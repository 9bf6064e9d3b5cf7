"""Port parity for tensor parallelism: the port's axis rules, parameter
specs, TP-adjusted configs and collective counts against the reference's;
``shard_params`` slices against the full tree; the sharded decode route
(its plain path) on each rank's head shard against the JAX Pallas kernels
in interpret mode; the roofline and the multiplexer at TP 2; and two gloo
ranks on the CPU serving reduced qwen3-4b (fp32) against the port at TP 1
and the JAX ``Model.forward`` greedy oracle.

The rank bodies below are module-level functions that the spawned ranks
import, so this module imports neither ``jax`` nor ``repro`` at its top:
the tests import them where they use them.
"""
import copy
import dataclasses
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.core.device import DeviceContext
from repro_torch.core.multiplexer import AdaptiveMultiplexer
from repro_torch.core.roofline import RequestLoad, RooflineModel
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ops import build_duet_schedule, duet_block_q
from repro_torch.launch.mesh import check_geometry, run_ranks
from repro_torch.models import Model, init_params, params_from_jax
from repro_torch.models.params import (_leaves, axis_rules, param_specs,
                                       shard_params, tp_adjusted_config)
from repro_torch.serving import (AsyncDuetEngine, DuetEngine, EngineConfig,
                                 Request)
from repro_torch.serving.kvcache import (PagedKVCacheManager, PagePoolConfig,
                                         copy_pool_pages, init_page_pools)
from repro_torch.serving.request import synth_prompt_tokens

REPO = Path(__file__).resolve().parents[1]
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # tests/test_kernels.py
LOGIT_TOL = 1e-5          # TP 2 vs TP 1 logits, relative to max |logit|
# the reference's shared-prefix scenario (tests/test_sharded_serving.py)
SHARED_KW = dict(max_slots=4, max_len=256, token_budget=64)
# its preemption case: a 56-token pool of 4-token pages
PREEMPT_KW = dict(max_slots=4, max_len=64, token_budget=32, page_size=4,
                  kv_pool_tokens=56)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the reduced model's ops are tiny, and with the
    suite's parallel workers sharing the cores, torch's default thread
    team per op slows these tests by an order of magnitude or more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (i,))
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# rules, specs, configs and collective counts against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pad_experts", [False, True])
@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("name", list_configs())
def test_rules_specs_and_collectives_match_reference(name, tp, pad_experts):
    from repro.configs import get_config as jget_config
    from repro.core.device import DeviceContext as JContext
    from repro.models.params import axis_rules as jaxis_rules
    from repro.models.params import param_specs as jparam_specs
    from repro.models.params import tp_adjusted_config as jtp_adjusted
    base, jbase = get_config(name), jget_config(name)
    for cfg, jcfg in ((base, jbase),
                      (tp_adjusted_config(base, tp, pad_experts),
                       jtp_adjusted(jbase, tp, pad_experts))):
        assert {f.name: getattr(cfg, f.name)
                for f in dataclasses.fields(cfg)} == \
            {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cfg)}
        assert axis_rules(cfg, tp) == jaxis_rules(jcfg, tp)
        mesh = SimpleNamespace(shape={"model": tp})
        want = {p: tuple(s) for p, s in _flat(jparam_specs(jcfg, mesh))}
        assert dict(_flat(param_specs(cfg, tp))) == want
        ctx = DeviceContext(cfg, "cpu", tp=tp, rank=tp - 1)
        assert ctx.collectives_per_iteration() == \
            JContext(mesh, jcfg).collectives_per_iteration()
        assert ctx.shape == {"model": tp}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", ["qwen3-4b", "granite-20b"])
def test_shard_params_concatenate_to_the_full_tree(name, tp):
    """Every rank's slices, concatenated along the dim its spec marks,
    give the full leaf; unmarked (or indivisible) leaves are whole on every
    rank; ``init_params`` at (tp, rank) draws exactly those slices."""
    cfg = reduced(get_config(name))
    full = init_params(cfg, torch.Generator().manual_seed(0))
    shards = [shard_params(full, cfg, tp, r) for r in range(tp)]
    specs = dict(_leaves(param_specs(cfg, tp)))
    flat = [dict(_leaves(s)) for s in shards]
    n_cut = 0
    for path, leaf in _leaves(full):
        parts = [f[path] for f in flat]
        dims = [d for d, a in enumerate(specs[path])
                if a == "model" and leaf.shape[d] % tp == 0]
        if dims:
            n_cut += 1
            assert torch.equal(torch.cat(parts, dim=dims[0]), leaf), path
        else:
            assert all(torch.equal(p, leaf) for p in parts), path
    assert n_cut > 0
    for r in range(tp):
        drawn = init_params(cfg, torch.Generator().manual_seed(0), tp=tp,
                            rank=r)
        for path, leaf in _leaves(drawn):
            assert torch.equal(leaf, flat[r][path]), path


def test_tp_refuses_unported_blocks_and_foreign_trees():
    """Every block kind is ported under TP now: reduced granite-moe (GQA +
    MoE) builds at TP 2 with its rank's experts. What is still refused is
    a tree that is not the rank's slices."""
    moe = reduced(get_config("granite-moe-3b-a800m"))
    ctx = DeviceContext(moe, "cpu", tp=2, rank=0)
    model = Model.init(moe, seed=0, ctx=ctx)
    assert model.params["layers"][0]["moe"]["w_gate"].shape[0] == \
        moe.num_experts // 2 == ctx.local_experts
    cfg = reduced(get_config("qwen3-4b"))
    full = init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="place_params"):
        Model(cfg, full, ctx=DeviceContext(cfg, "cpu", tp=2, rank=1))
    with pytest.raises(ValueError, match="place_params"):
        Model(moe, init_params(moe, torch.Generator().manual_seed(0)),
              ctx=ctx)


def test_mesh_geometry_refuses_what_the_machine_cannot_run():
    """The placement fixes the backend: gloo on the CPU (share_card means
    nothing there); CUDA where there is none raises, never a quiet move to
    the CPU."""
    assert check_geometry(2, "cpu") == "gloo"
    assert check_geometry(2, "cpu", share_card=True) == "gloo"
    with pytest.raises(ValueError, match="tp must be"):
        check_geometry(0, "cpu")
    with pytest.raises(ValueError, match="device must be"):
        check_geometry(2, "mps")
    if not torch.cuda.is_available():
        for share in (False, True):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                check_geometry(2, "cuda", share_card=share)


# ---------------------------------------------------------------------------
# the sharded decode route on each rank's head shard
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("tp", [2])
def test_paged_decode_sharded_matches_jax_kernel_per_shard(tp, rep, splits):
    import jax.numpy as jnp
    from repro.kernels.ops import paged_decode as jpaged_decode
    from repro.kernels.ops import paged_decode_splitkv as jsplitkv
    G, Dh, B, N, ps, P = 2 * tp, 64, 3, 24, 8, 6
    H = G * rep
    cfg = dataclasses.replace(reduced(get_config("qwen3-4b")), num_heads=H,
                              num_kv_heads=G, head_dim=Dh)
    rng = np.random.default_rng(rep * 10 + splits)
    q = rng.standard_normal((B, H, Dh), np.float32)
    kp = rng.standard_normal((N, ps, G, Dh), np.float32)
    vp = rng.standard_normal((N, ps, G, Dh), np.float32)
    tables = rng.integers(1, N, (B, P)).astype(np.int32)
    lengths = np.array([1, 17, P * ps], np.int32)
    args = [jnp.asarray(a) for a in (q, kp, vp, tables, lengths)]
    if splits > 1:
        want = jsplitkv(*args, num_splits=splits, interpret=True)
    else:
        want = jpaged_decode(*args, interpret=True)
    want = np.asarray(want)
    Hl, Gl = H // tp, G // tp
    for r in range(tp):
        ctx = DeviceContext(cfg, "cpu", tp=tp, rank=r)
        got = kernel_ops.paged_decode_sharded(
            torch.from_numpy(q[:, r * Hl:(r + 1) * Hl].copy()),
            torch.from_numpy(kp[:, :, r * Gl:(r + 1) * Gl].copy()),
            torch.from_numpy(vp[:, :, r * Gl:(r + 1) * Gl].copy()),
            torch.from_numpy(tables), torch.from_numpy(lengths), ctx=ctx,
            num_splits=splits)
        np.testing.assert_allclose(got.numpy(),
                                   want[:, r * Hl:(r + 1) * Hl],
                                   atol=TOL[torch.float32],
                                   rtol=TOL[torch.float32])
        # the full heads are not a rank's shard: refused, never run
        with pytest.raises(ValueError, match="holds"):
            kernel_ops.paged_decode_sharded(
                *[torch.from_numpy(a) for a in (q, kp, vp, tables,
                                                lengths)], ctx=ctx)


def test_paged_decode_auto_routes_tp_through_the_sharded_route(monkeypatch):
    cfg = reduced(get_config("qwen3-4b"))
    seen = []

    def spy(*a, ctx, num_splits):
        seen.append((ctx.tp, num_splits))
        return a[0]
    monkeypatch.setattr(kernel_ops, "paged_decode_sharded", spy)
    q = torch.zeros(2, 2, 64)
    pools = torch.zeros(9, 8, 1, 64)
    tables = torch.ones(2, 4, dtype=torch.int32)
    lengths = torch.ones(2, dtype=torch.int32)
    tp2 = DeviceContext(cfg, "cpu", tp=2, rank=0)
    kernel_ops.paged_decode_auto(q, pools, pools, tables, lengths, ctx=tp2,
                                 split_threshold=16)
    kernel_ops.paged_decode_auto(q, pools, pools, tables, lengths,
                                 ctx=DeviceContext(cfg, "cpu"))
    assert seen == [(2, 2)]
    # granite-20b's one KV head does not shard, so its attention stays
    # whole on every rank: the ordinary decode, not the sharded route
    gcfg = reduced(get_config("granite-20b"))
    gtp2 = DeviceContext(gcfg, "cpu", tp=2, rank=1)
    assert not gtp2.sharded("kv_heads") and not gtp2.sharded("heads")
    out = kernel_ops.paged_decode_auto(q, pools, pools, tables, lengths,
                                       ctx=gtp2)
    assert seen == [(2, 2)] and out.shape == q.shape


# ---------------------------------------------------------------------------
# the roofline and the multiplexer at TP 2
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", [
    "qwen3-4b", "yi-9b", "granite-20b", "granite-moe-3b-a800m",
    "deepseek-v2-lite-16b", "zamba2-1.2b", "xlstm-350m", "paligemma-3b",
    "musicgen-medium"])
def test_roofline_and_multiplexer_match_reference_at_tp2(name):
    from repro.configs import get_config as jget_config
    from repro.core.multiplexer import AdaptiveMultiplexer as JMux
    from repro.core.roofline import RequestLoad as JLoad
    from repro.core.roofline import RooflineModel as JRoofline
    cfg, jcfg = get_config(name), jget_config(name)
    ctx = DeviceContext(cfg, "cpu", tp=2, rank=0)
    jmesh = SimpleNamespace(shape={"model": 2})
    a = RooflineModel(cfg, page_size=16, mesh=ctx)
    b = JRoofline(jcfg, tp=2, page_size=16)
    assert a.tp == 2
    assert a.split_kv_threshold() == b.split_kv_threshold()
    rng = np.random.default_rng(3)
    for _ in range(5):
        loads = [(int(q), int(c), ph) for q, c, ph in zip(
            rng.integers(1, 300, 6), rng.integers(0, 4000, 6),
            rng.choice(["prefill", "decode"], 6))]
        for units in (1, 2, None):
            assert a.iteration_latency(
                [RequestLoad(*x) for x in loads], units) == \
                b.iteration_latency([JLoad(*x) for x in loads], units)
    ma = AdaptiveMultiplexer(cfg, total_units=2, tbt_slo=0.03, tp=2,
                             page_size=16, mesh=ctx)
    mb = JMux(jcfg, total_units=2, tbt_slo=0.03, tp=2, page_size=16,
              mesh=jmesh)
    for _ in range(8):
        pre = [(int(rng.integers(16, 512)), int(rng.integers(0, 1024)))
               for _ in range(int(rng.integers(0, 3)))]
        dec = [int(rng.integers(16, 3000))
               for _ in range(int(rng.integers(0, 9)))]
        da = ma.step([RequestLoad(q, c, "prefill") for q, c in pre],
                     [RequestLoad(1, c) for c in dec])
        db = mb.step([JLoad(q, c, "prefill") for q, c in pre],
                     [JLoad(1, c) for c in dec])
        assert (da.mode, da.t_mixed) == (db.mode, db.t_mixed)
        assert (da.partition is None) == (db.partition is None)
        if da.partition is not None:
            assert vars(da.partition) == vars(db.partition)
    assert vars(ma.stats) == vars(mb.stats)


# ---------------------------------------------------------------------------
# two gloo ranks serving reduced qwen3-4b (rank bodies: module level)
# ---------------------------------------------------------------------------
def shared_prefix_requests(vocab, n=6, shared=32):
    """The reference's scenario: staggered arrivals, so later requests hit
    the pages the first prefill inserted (32 shared tokens: two full
    pages of 16)."""
    common = np.random.default_rng(7).integers(0, vocab, shared) \
        .astype(np.int32)
    reqs = []
    for i in range(n):
        plen = 40 + 8 * (i % 3)
        body = synth_prompt_tokens(i, vocab, plen)
        reqs.append(Request(rid=i, arrival=0.05 * i,
                            prompt_len=plen + shared, output_len=8 + (i % 4),
                            prompt_tokens=np.concatenate([common, body])))
    return reqs


def duet_requests():
    """Simultaneous arrivals with long outputs: a decode batch stays
    resident while later prompts prefill, the mixed plans the async engine
    fuses into duet steps (the reference's kernel-mode scenario)."""
    return [Request(rid=100 + i, arrival=0.0, prompt_len=40 + 8 * (i % 3),
                    output_len=16 + (i % 5)) for i in range(8)]


def preempt_requests():
    return [Request(rid=i, arrival=0.0, prompt_len=20, output_len=12)
            for i in range(2)]


def _serve(cls, model, reqs, **kw):
    eng = cls(model, EngineConfig(**kw), device="cpu")
    reqs = [copy.deepcopy(r) for r in reqs]
    eng.submit(reqs)
    metrics = eng.run()
    return eng, metrics, {r.rid: [int(t) for t in r.output_tokens]
                          for r in metrics.requests}


def step_tokens(vocab):
    """step_logits' tokens: a 40-token prompt A, a 12-token chunk B and
    A's next token."""
    rng = np.random.default_rng(5)
    return (rng.integers(0, vocab, (1, 40)), rng.integers(0, vocab, (1, 12)),
            rng.integers(0, vocab, (1, 1)))


def jax_step_logits(forward, vocab):
    """step_logits' logits from the JAX full-sequence forward: A's last
    position, A + its next token's last position (the paged and the slab
    decode), and the duet step's rows (that decode row, then B's
    positions)."""
    toksA, toksB, tok = step_tokens(vocab)
    pre = np.asarray(forward(toksA.astype(np.int32)))[0, -1:, :vocab]
    dec = np.asarray(forward(np.concatenate([toksA, tok], 1).astype(
        np.int32)))[0, -1:, :vocab]
    chunk = np.asarray(forward(toksB.astype(np.int32)))[0, :, :vocab]
    return {"paged prefill": pre, "paged decode": dec,
            "duet": np.concatenate([dec, chunk]), "slab decode": dec}


def step_logits(model):
    """Logits of one paged prefill (40 tokens), one paged decode step, one
    duet step at the async engine's tiles (the decode row beside a 12-row
    chunk) and one slab decode step after a slab prefill, on ``model``'s
    device context (pools of its KV heads); kernel path on."""
    cfg, ps, P = model.cfg, 8, 8
    heads = model.ctx.local_kv_heads
    pool = PagePoolConfig(num_pages=2 * P + 1, page_size=ps)
    toksA, toksB, tok = map(torch.tensor, step_tokens(cfg.vocab_size))
    tblA = torch.arange(1, 1 + P, dtype=torch.int32)[None]
    tblB = torch.arange(1 + P, 1 + 2 * P, dtype=torch.int32)[None]
    pos = torch.tensor([40], dtype=torch.int32)
    state = [None] * cfg.num_layers

    def fresh():
        return init_page_pools(cfg, pool, torch.float32, kv_heads=heads)

    def prefilled():
        pools = fresh()
        model.prefill_paged(toksA, pools, state, tblA, start_pos=0)
        return pools

    out = {}
    with torch.no_grad():
        out["paged prefill"] = model.prefill_paged(toksA, fresh(), state,
                                                   tblA, start_pos=0)[0]
        out["paged decode"] = model.decode_step_paged(prefilled(), state,
                                                      tok, pos, tblA)[0]
        C = toksB.shape[1]
        bq = duet_block_q(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        sched = build_duet_schedule([(0, 40)], [(1, i) for i in range(C)],
                                    block_q=bq)
        out["duet"] = model.duet_step_paged(
            prefilled(), state, torch.cat([tok[:, 0], toksB[0]])[:, None],
            torch.cat([pos, torch.arange(C, dtype=torch.int32)]),
            torch.cat([tblA, tblB.expand(C, P)]),
            torch.tensor(sched.row_src), block_q=bq)[0]
        cache = model.init_cache(1, 64)
        model.prefill(toksA, cache=cache, start_pos=0)
        out["slab decode"] = model.decode_step(cache, tok, pos)[0]
    return {k: v.numpy() for k, v in out.items()}


def tp_rank_body(rank, jtree):
    """One rank of the TP 2 run: reduced qwen3-4b from the JAX weights,
    kernel path on. Returns everything the tests below check."""
    cfg = reduced(get_config("qwen3-4b"))
    ctx = rank.context(cfg)
    model = Model(cfg, ctx.place_params(params_from_jax(cfg, jtree)),
                  ctx=ctx, attn_kernel=True)
    res = {"local_heads": (model.params["layers"][0]["attn"]["w_q"].shape[1],
                           ctx.local_kv_heads)}
    routed = []
    inner = kernel_ops.paged_decode_sharded
    kernel_ops.paged_decode_sharded = \
        lambda *a, **k: routed.append(1) or inner(*a, **k)
    res["logits"] = step_logits(model)
    kernel_ops.paged_decode_sharded = inner
    res["sharded_route_calls"] = len(routed)
    before = ctx.all_reduces
    step_logits(model)
    res["all_reduces"] = ctx.all_reduces - before
    res["collectives_per_iteration"] = ctx.collectives_per_iteration()
    reqs = shared_prefix_requests(cfg.vocab_size)
    for label, cls in (("sync", DuetEngine), ("async", AsyncDuetEngine)):
        eng, m, toks = _serve(cls, model, reqs, **SHARED_KW)
        out = {"tokens": toks, "kernel_path": eng.kernel_path,
               "finished": m.summary()["num_finished"],
               "hit_tokens": eng.kv_mgr.prefix_stats()["hit_tokens"],
               "pool_shape": tuple(eng.pools[0][0].shape)}
        if cls is AsyncDuetEngine:
            out["host_syncs"] = eng.dstats.host_syncs
            out["super_iterations"] = eng.dstats.super_iterations
        res[label] = out
    eng, m, toks = _serve(AsyncDuetEngine, model, duet_requests(),
                          **dict(SHARED_KW, token_budget=48))
    res["duet"] = {"tokens": toks, "host_syncs": eng.dstats.host_syncs,
                   "super_iterations": eng.dstats.super_iterations,
                   "duet_buckets": sum(1 for k in eng._programs if k[-1])}
    for label, cls in (("preempt sync", DuetEngine),
                       ("preempt async", AsyncDuetEngine)):
        eng, m, toks = _serve(cls, model, preempt_requests(), **PREEMPT_KW)
        res[label] = {"tokens": toks,
                      "finished": m.summary()["num_finished"],
                      "preemptions": m.summary()["num_preemptions"],
                      "drained": eng.kv_mgr.used_pages == 0}
    res["cow"] = cow_on_local_pools(cfg, ctx)
    # granite-20b's single KV head does not shard: its attention is whole
    # on every rank and the ordinary decode kernels read it; the slab runs
    # its kernel on the rank's slab
    gcfg = reduced(get_config("granite-20b"))
    gmodel = Model.init(gcfg, seed=0, device="cpu", ctx=rank.context(gcfg),
                        attn_kernel=True)
    res["granite"] = kernel_route_run(gmodel, SHARED_KW)
    res["slab"] = kernel_route_run(model, dict(SHARED_KW, paged=False))
    res["tp4_vs_tp2"] = _raises(lambda: DuetEngine(
        model, EngineConfig(tp=4, **SHARED_KW), device="cpu"))
    return res


KERNEL_WRAPPERS = ("paged_decode", "paged_decode_splitkv",
                   "paged_decode_sharded", "duet_attention")


def kernel_route_run(model, kw):
    """The sync engine on the preemption requests with strict_kernel on:
    its tokens and kernel path, the warnings it raised, and how often the
    attention called each kernel wrapper (their plain versions here)."""
    calls = dict.fromkeys(KERNEL_WRAPPERS, 0)
    saved = {n: getattr(kernel_ops, n) for n in calls}

    def spy(name):
        def call(*a, **k):
            calls[name] += 1
            return saved[name](*a, **k)
        return call
    for n in calls:
        setattr(kernel_ops, n, spy(n))
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            eng, _, toks = _serve(DuetEngine, model, preempt_requests(),
                                  strict_kernel=True, **kw)
    finally:
        for n, fn in saved.items():
            setattr(kernel_ops, n, fn)
    return {"tokens": toks, "kernel_path": eng.kernel_path,
            "attn_kernel": eng.model.attn_kernel, "calls": calls,
            "warnings": [str(w.message) for w in caught]}


def _raises(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def cow_on_local_pools(cfg, ctx):
    """Two requests share one fully matched page; the second's first write
    privatises it on the rank's pools without touching the original."""
    mgr = PagedKVCacheManager(PagePoolConfig(num_pages=16, page_size=4),
                              prefix_cache=True)
    pools = init_page_pools(cfg, mgr.pool, kv_heads=ctx.local_kv_heads)
    toks4 = np.arange(1, 5, dtype=np.int64)
    [page_a] = mgr.allocate(1, 4)
    for p in pools:
        p[0][page_a] = 1.0
        p[1][page_a] = 1.0
    mgr.insert_prefix(1, toks4)
    matched = mgr.lock_prefix(2, toks4)
    copies = mgr.ensure_writable(2, matched)
    copy_pool_pages(pools, copies)
    [(src, dst)] = copies
    for p in pools:
        p[0][dst, 3] = 9.0
        p[1][dst, 3] = 9.0
    k0 = pools[0][0]
    return {"matched": matched, "cow_copies": mgr.stats.cow_copies,
            "heads": k0.shape[2],
            "src_intact": bool((k0[src] == 1.0).all()),
            "dst_prefix_copied": bool((k0[dst, :3] == 1.0).all()),
            "dst_written": bool((k0[dst, 3] == 9.0).all())}


def _greedy(forward, prompts, want):
    """Greedy continuations from the JAX full-sequence forward, every
    sequence right-padded to one length (causal: the padding is invisible
    to earlier positions)."""
    import jax.numpy as jnp
    seqs = {rid: list(map(int, p)) for rid, p in prompts.items()}
    out = {rid: [] for rid in seqs}
    L = max(len(seqs[r]) + want[r] for r in seqs)
    for _ in range(max(want.values())):
        batch = np.zeros((len(seqs), L), np.int32)
        for i, s in enumerate(seqs.values()):
            batch[i, :len(s)] = s
        logits = np.asarray(forward(jnp.asarray(batch)))
        for i, (rid, s) in enumerate(seqs.items()):
            if len(out[rid]) < want[rid]:
                tok = int(np.argmax(logits[i, len(s) - 1]))
                s.append(tok)
                out[rid].append(tok)
    return out


def _oracle(forward, reqs, vocab):
    return _greedy(forward, {
        r.rid: (r.prompt_tokens if r.prompt_tokens is not None
                else synth_prompt_tokens(r.rid, vocab, r.prompt_len))
        for r in reqs}, {r.rid: r.output_len for r in reqs})


@pytest.fixture(scope="module")
def tp2():
    """The JAX weights and greedy oracles, the port at TP 1, and the two
    ranks' results."""
    import jax
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import Model as JModel
    jcfg = jreduced(jget_config("qwen3-4b"))
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jtree = jax.tree.map(np.asarray, jparams)
    forward = jax.jit(lambda toks: jmodel.forward(jparams, toks))
    cfg = reduced(get_config("qwen3-4b"))
    one = Model(cfg, params_from_jax(cfg, jtree), attn_kernel=True)
    gcfg = reduced(get_config("granite-20b"))
    gone = Model.init(gcfg, seed=0, device="cpu", attn_kernel=True)
    ranks = run_ranks(tp_rank_body, 2, device="cpu", args=(jtree,))
    return SimpleNamespace(
        ranks=ranks, tp1_logits=step_logits(one),
        jax_logits=jax_step_logits(forward, cfg.vocab_size),
        oracle=_oracle(forward, shared_prefix_requests(cfg.vocab_size),
                       cfg.vocab_size),
        preempt_oracle=_oracle(forward, preempt_requests(), cfg.vocab_size),
        duet_oracle=_oracle(forward, duet_requests(), cfg.vocab_size),
        granite_tp1=_serve(DuetEngine, gone, preempt_requests(),
                           **SHARED_KW)[2])


def test_tp2_logits_match_tp1_and_agree_across_ranks(tp2):
    r0, r1 = tp2.ranks
    assert r0["local_heads"] == r1["local_heads"] == (2, 1)
    assert r0["sharded_route_calls"] > 0       # the decode went sharded
    for what, want in tp2.tp1_logits.items():
        got = r0["logits"][what]
        assert np.array_equal(got, r1["logits"][what]), what   # bitwise
        V = 512
        scale = max(1.0, np.abs(want[..., :V]).max())
        err = np.abs(got[..., :V] - want[..., :V]).max()
        assert err <= LOGIT_TOL * scale, (what, err, scale)


def test_tp2_logits_match_the_jax_model(tp2):
    """The same steps' logits against the JAX Model.forward on the same
    weights, so an error common to TP 1 and TP 2 shows too."""
    got = tp2.ranks[0]["logits"]
    for what, want in tp2.jax_logits.items():
        scale = max(1.0, np.abs(want).max())
        err = np.abs(got[what] - want).max()
        assert err <= LOGIT_TOL * scale, (what, err, scale)


def test_tp2_all_reduces_per_step(tp2):
    """Per forward: the vocab-parallel embedding, each layer's attention
    and MLP outputs, the logits: the reference's count plus the
    embedding."""
    r0 = tp2.ranks[0]
    assert r0["collectives_per_iteration"] == 2 * 2 + 1
    # four forwards in step_logits (paged prefill, decode, duet, slab
    # decode) and three prefills behind them
    assert r0["all_reduces"] == 7 * (r0["collectives_per_iteration"] + 1)


@pytest.mark.parametrize("engine", ["sync", "async"])
def test_tp2_engines_match_jax_oracle_on_shared_prefix(tp2, engine):
    r0, r1 = tp2.ranks
    got = r0[engine]
    assert got["kernel_path"] == "torch"       # CPU: the plain versions
    assert got["finished"] == 6
    assert got["tokens"] == tp2.oracle
    assert got["tokens"] == r1[engine]["tokens"]
    assert got["hit_tokens"] > 0
    assert got["pool_shape"][2] == 1           # the rank's KV head
    if engine == "async":
        assert 0 < got["host_syncs"] <= got["super_iterations"]


def test_tp2_async_duet_steps_match_jax_oracle(tp2):
    """The fused duet step runs per rank on its local heads."""
    r0, r1 = tp2.ranks
    got = r0["duet"]
    assert got["duet_buckets"] > 0
    assert 0 < got["host_syncs"] <= got["super_iterations"]
    assert got["tokens"] == tp2.duet_oracle
    assert got["tokens"] == r1["duet"]["tokens"]


@pytest.mark.parametrize("engine", ["sync", "async"])
def test_tp2_preemption_keeps_oracle_tokens(tp2, engine):
    r0, r1 = tp2.ranks
    got = r0[f"preempt {engine}"]
    assert got["finished"] == 2 and got["drained"]
    assert got["preemptions"] > 0
    assert got["tokens"] == tp2.preempt_oracle
    assert got["tokens"] == r1[f"preempt {engine}"]["tokens"]


def test_tp2_cow_isolation_on_rank_local_pools(tp2):
    for r in tp2.ranks:
        cow = r["cow"]
        assert cow["heads"] == 1
        assert cow["matched"] == 3 and cow["cow_copies"] == 1
        assert cow["src_intact"], "CoW wrote through to the cached page"
        assert cow["dst_prefix_copied"] and cow["dst_written"]


@pytest.mark.parametrize("what", ["granite", "slab"])
def test_tp2_unshardable_kv_heads_and_slab_keep_the_kernels(tp2, what):
    """Granite-20b's unsharded KV head (paged) and the slab at TP 2 run
    the kernel wrappers on each rank's local tensors, with strict_kernel
    on and no warning; the sharded route is only for sharded KV heads."""
    for r in tp2.ranks:
        g = r[what]
        assert g["attn_kernel"] and g["kernel_path"] == "torch"   # CPU
        assert not [w for w in g["warnings"] if "attn_kernel" in w], \
            g["warnings"]
        calls = g["calls"]
        assert calls["paged_decode_sharded"] == 0
        if what == "granite":
            assert calls["paged_decode"] + calls["paged_decode_splitkv"] > 0
            assert g["tokens"] == tp2.granite_tp1
        else:
            assert calls["duet_attention"] > 0
            assert g["tokens"] == tp2.preempt_oracle
        assert g["tokens"] == tp2.ranks[0][what]["tokens"]
    assert "contradicts" in tp2.ranks[0]["tp4_vs_tp2"]


def test_serve_cli_tp2_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--tp", "2", "--num-requests", "4",
         "--attn-kernel", "--max-len", "128"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    summary = json.loads(proc.stdout[proc.stdout.index("{\n"):])
    assert summary["num_finished"] == 4
    assert summary["mesh"]["tp"] == 2 and summary["mesh"]["backend"] == "gloo"
    assert summary["collectives_per_iteration"] == 2 * 2 + 1
