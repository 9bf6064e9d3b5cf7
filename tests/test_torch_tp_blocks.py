"""Port parity for tensor parallelism over every block kind and both
frontends: two gloo ranks on the CPU run reduced granite-moe-3b-a800m
(GQA + MoE cut on ``experts``), the same with 3 experts (the MoE cut on
each expert's ``moe_ffn`` columns) and with those 3 padded to 4
(``tp_adjusted_config(pad_experts=True)``: the expert axis cut, the pad
expert never chosen), deepseek-v2-lite-16b (MLA + MoE with a shared
expert), zamba2-1.2b (Mamba2 + the shared attention block, at 4 layers:
two occurrences), xlstm-350m (mLSTM + sLSTM, whole on every rank),
paligemma-3b (the vision prefix; its one KV head keeps attention whole)
and musicgen-medium (the audio codebooks, slab steps only), fp32, from
the JAX ``init`` through ``params_from_jax``.

Held: the logits of the full-sequence forward and of the paged and slab
prefill and decode steps at TP 2 against TP 1 (``LOGIT_TOL``), both
ranks bitwise equal, and against the JAX ``Model.forward`` within the
tolerance of each block kind's own parity file; the all-reduces of one
forward and of one decode step against ``collectives_per_iteration()``
+ 1 (the vocab-parallel embedding); each rank's weights, recurrent state
and page pools at the rank's widths; both engines' greedy streams at
TP 2 on the paged and the slab path against the greedy oracle from the
JAX ``Model.forward`` (every config but musicgen, which no engine
serves, as in the reference); one ``serve --tp 2`` CLI run.

One module fixture spawns the two ranks once for every config (one torch
thread each). The rank bodies are module-level functions the spawned
ranks import, so this module imports neither ``jax`` nor ``repro`` at its
top.
"""
import copy
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.device import DeviceContext
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import Model, params_from_jax
from repro_torch.models.params import tp_adjusted_config
from repro_torch.models.transformer import _build_cache
from repro_torch.serving import (AsyncDuetEngine, DuetEngine, EngineConfig,
                                 Request)
from repro_torch.serving.kvcache import PagePoolConfig, init_page_pools

REPO = Path(__file__).resolve().parents[1]
TP = 2
LOGIT_TOL = 1e-5            # TP 2 vs TP 1, as tests/test_torch_tp.py
# case -> (registered config, reduced depth, MoE variant)
CASES = {
    "granite-moe": ("granite-moe-3b-a800m", 2, None),
    "granite-moe-e3": ("granite-moe-3b-a800m", 2, "e3"),
    "granite-moe-e3-padded": ("granite-moe-3b-a800m", 2, "e3-padded"),
    "deepseek": ("deepseek-v2-lite-16b", 2, None),
    "zamba2": ("zamba2-1.2b", 4, None),
    "xlstm": ("xlstm-350m", 2, None),
    "paligemma": ("paligemma-3b", 2, None),
    "musicgen": ("musicgen-medium", 2, None),
}
ENGINE_CASES = [c for c in CASES if c != "musicgen"]
# TP 2 against the JAX Model.forward: each block kind's own parity TOL
# (tests/test_torch_{moe,ssm,xlstm,mla,frontends}.py)
JAX_TOL = {"deepseek": 1e-4, "paligemma": 1e-4, "musicgen": 1e-4}
# the engine runs' MoE capacity factor: nothing dropped, so the
# whole-sequence oracle routes as the engines' steps do
# (tests/test_torch_configs.py); the logits run the default 1.25
ORACLE_CAPACITY = 64.0
# the drop check: a capacity factor that must drop choices
DROP_CAPACITY = 0.5
# the full configs' all-reduces a step at TP 2: collectives_per_iteration
# (the reference's count, pinned by tests/test_torch_tp.py) plus the
# embedding's
FULL_REDUCES = {"deepseek-v2-lite-16b": 55 + 1, "zamba2-1.2b": 45 + 1,
                "granite-moe-3b-a800m": 65 + 1, "xlstm-350m": 1 + 1,
                "paligemma-3b": 19 + 1, "musicgen-medium": 97 + 1}
B, S = 2, 12
ENGINE_KW = dict(max_slots=4, max_len=64, token_budget=32, page_size=8)


def build_cfg(case, get_config, reduced, tp_adjusted_config):
    """The case's config from either package's functions."""
    name, layers, variant = CASES[case]
    cfg = reduced(get_config(name), num_layers=layers)
    if variant:
        cfg = dataclasses.replace(cfg, num_experts=3)
        if variant == "e3-padded":
            cfg = tp_adjusted_config(cfg, TP, pad_experts=True)
    return cfg


def port_cfg(case):
    return build_cfg(case, get_config, reduced, tp_adjusted_config)


def engine_cfg(cfg):
    return (dataclasses.replace(cfg, capacity_factor=ORACLE_CAPACITY)
            if cfg.is_moe else cfg)


def inputs(cfg):
    """(tokens, next tokens, patch embeddings or None): (B, S) text, (B,
    K, S) audio codebooks."""
    rng = np.random.default_rng(11)
    lead = (B, cfg.num_codebooks) if cfg.frontend == "audio" else (B,)
    toks = rng.integers(0, cfg.vocab_size, lead + (S,))
    nxt = rng.integers(0, cfg.vocab_size, lead + (1,))
    patches = None
    if cfg.frontend == "vision":
        patches = (0.1 * rng.standard_normal(
            (B, cfg.num_prefix_tokens, cfg.d_model))).astype(np.float32)
    return toks, nxt, patches


def requests():
    """Three requests on four slots (no slot reused), none of one token,
    arriving apart so later prompts prefill while earlier ones decode."""
    return [Request(rid=i, arrival=0.0003 * i, prompt_len=20 + 7 * i,
                    output_len=5 + i) for i in range(3)]


# ---------------------------------------------------------------------------
# what one rank (or the TP 1 model) computes
# ---------------------------------------------------------------------------
def step_logits(model):
    """Logits of the full-sequence forward, the slab prefill and one slab
    decode step, and (text configs) the paged prefill and one paged
    decode step; the prefills are over the same B x S rows as the
    forward."""
    cfg = model.cfg
    toks, nxt, patches = map(lambda a: None if a is None
                             else torch.from_numpy(a), inputs(cfg))
    kw = {} if patches is None else {"patch_embeds": patches}
    P = 0 if patches is None else patches.shape[1]
    pos = torch.full((B,), P + S, dtype=torch.int32)
    out = {}
    with torch.no_grad():
        out["forward"] = model.forward(toks, **kw)
        cache = model.init_cache(B, 32)
        out["slab prefill"] = model.prefill(toks, cache=cache, **kw)[0]
        out["slab decode"] = model.decode_step(cache, nxt, pos)[0]
        if cfg.frontend != "audio":
            ps, n = 8, 4
            pools = init_page_pools(
                cfg, PagePoolConfig(num_pages=B * n + 1, page_size=ps),
                kv_heads=model.ctx.local_kv_heads)
            state = model.init_state_cache(B)
            tables = torch.arange(1, B * n + 1,
                                  dtype=torch.int32).reshape(B, n)
            out["paged prefill"] = model.prefill_paged(
                toks, pools, state, tables, start_pos=0)[0]
            out["paged decode"] = model.decode_step_paged(
                pools, state, nxt, torch.full((B,), S, dtype=torch.int32),
                tables)[0]
        if cfg.is_moe:
            drop = Model(dataclasses.replace(cfg,
                                             capacity_factor=DROP_CAPACITY),
                         model.param_tree(), ctx=model.ctx)
            out["forward, choices dropped"] = drop.forward(toks)
    return {k: v.numpy() for k, v in out.items()}


def widths(model):
    """The rank's weight, recurrent-state and pool shapes that differ by
    block kind."""
    cfg = model.cfg
    p, kind = model._block_params(cfg.num_layers - 1)
    out = {"state": [None if c is None else [tuple(t.shape) for t in c]
                     for c in model.init_state_cache(B)],
           "pools": [None if c is None else [tuple(t.shape) for t in c]
                     for c in init_page_pools(
                         cfg, PagePoolConfig(num_pages=5, page_size=8),
                         kv_heads=model.ctx.local_kv_heads)]}
    if "moe" in p:
        out["experts"] = tuple(p["moe"]["w_gate"].shape)
    return out


def serve(model, reqs, paged, cls):
    eng = cls(model, EngineConfig(paged=paged, **ENGINE_KW), device="cpu")
    eng.submit([copy.deepcopy(r) for r in reqs])
    metrics = eng.run()
    out = {"tokens": {r.rid: [int(t) for t in r.output_tokens]
                      for r in metrics.requests},
           "finished": metrics.summary()["num_finished"]}
    if cls is AsyncDuetEngine:
        out["host_syncs"] = eng.dstats.host_syncs
        out["super_iterations"] = eng.dstats.super_iterations
    return out


def rank_body(rank, trees):
    """One rank: every case from the JAX weights, kernel path on (the
    kernels' plain versions on the CPU)."""
    torch.set_num_threads(1)
    res = {}
    for case, tree in trees.items():
        cfg = port_cfg(case)
        ctx = rank.context(cfg)
        local = ctx.place_params(params_from_jax(cfg, tree))
        model = Model(cfg, local, ctx=ctx, attn_kernel=True)
        out = {"logits": step_logits(model), "widths": widths(model),
               "collectives_per_iteration": ctx.collectives_per_iteration()}
        toks, nxt, patches = inputs(cfg)
        kw = {} if patches is None else {
            "patch_embeds": torch.from_numpy(patches)}
        with torch.no_grad():
            before = ctx.all_reduces
            model.forward(torch.from_numpy(toks), **kw)
            out["forward reduces"] = ctx.all_reduces - before
            cache = model.init_cache(B, 32)
            model.prefill(torch.from_numpy(toks), cache=cache, **kw)
            before = ctx.all_reduces
            model.decode_step(cache, torch.from_numpy(nxt),
                              torch.full((B,), S + 16, dtype=torch.int32))
            out["decode reduces"] = ctx.all_reduces - before
        if case in ENGINE_CASES:
            emodel = Model(engine_cfg(cfg), local, ctx=ctx,
                           attn_kernel=True)
            reqs = requests()
            for paged in (True, False):
                for cls in (DuetEngine, AsyncDuetEngine):
                    out[(paged, cls.__name__)] = serve(emodel, reqs, paged,
                                                       cls)
        res[case] = out
    return res


# ---------------------------------------------------------------------------
# the fixture: JAX weights and oracles, TP 1, and the two ranks
# ---------------------------------------------------------------------------
def _jax_cfg(case):
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models.params import tp_adjusted_config as jtp_adjusted
    return build_cfg(case, jget_config, jreduced, jtp_adjusted)


def jax_logits(jcfg, jmodel, jparams):
    """step_logits' logits from the JAX forward over the same inputs."""
    import jax.numpy as jnp
    toks, nxt, patches = inputs(jcfg)
    kw = {} if patches is None else {"patch_embeds": jnp.asarray(patches)}
    fwd = np.asarray(jmodel.forward(jparams, jnp.asarray(toks), **kw))
    ext = np.asarray(jmodel.forward(
        jparams, jnp.asarray(np.concatenate([toks, nxt], -1)), **kw))
    out = {"forward": fwd, "slab prefill": fwd[:, -1],
           "slab decode": ext[:, -1]}
    if jcfg.frontend != "audio":
        text = fwd if patches is None else np.asarray(
            jmodel.forward(jparams, jnp.asarray(toks)))
        text_ext = ext if patches is None else np.asarray(jmodel.forward(
            jparams, jnp.asarray(np.concatenate([toks, nxt], -1))))
        out["paged prefill"] = text[:, -1]
        out["paged decode"] = text_ext[:, -1]
    if jcfg.is_moe:
        # one decode step routes B rows, the forward B x (S + 1): their
        # drops differ at the default capacity, so the MoE decode steps
        # meet the JAX model through the engines (at ORACLE_CAPACITY)
        del out["slab decode"], out["paged decode"]
    return out


@pytest.fixture(scope="module")
def tp2():
    import jax
    from repro.models import Model as JModel
    from test_torch_tp import _oracle
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trees, tp1, jaxl, oracle = {}, {}, {}, {}
    for case in CASES:
        jcfg = _jax_cfg(case)
        jmodel = JModel(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        trees[case] = jax.tree.map(np.asarray, jparams)
        cfg = port_cfg(case)
        tp1[case] = step_logits(Model(cfg, params_from_jax(cfg,
                                                           trees[case]),
                                      attn_kernel=True))
        jaxl[case] = jax_logits(jcfg, jmodel, jparams)
        if case in ENGINE_CASES:
            ejcfg = engine_cfg(jcfg)
            ejmodel = JModel(ejcfg)
            forward = jax.jit(lambda t, m=ejmodel: m.forward(jparams, t))
            oracle[case] = _oracle(forward, requests(), cfg.vocab_size)
    ranks = run_ranks(rank_body, TP, device="cpu", args=(trees,))
    torch.set_num_threads(n)
    return SimpleNamespace(ranks=ranks, tp1=tp1, jax=jaxl, oracle=oracle)


def _err(got, want, vocab):
    got, want = got[..., :vocab], want[..., :vocab]
    return (np.abs(got - want).max(), max(1.0, np.abs(want).max()))


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(CASES))
def test_tp2_logits_match_tp1_and_agree_across_ranks(tp2, case):
    r0, r1 = (r[case]["logits"] for r in tp2.ranks)
    want = tp2.tp1[case]
    assert set(r0) == set(want)
    V = port_cfg(case).vocab_size
    for what in want:
        assert np.array_equal(r0[what], r1[what]), (case, what)  # bitwise
        assert np.isfinite(r0[what][..., :V]).all(), (case, what)
        err, scale = _err(r0[what], want[what], V)
        assert err <= LOGIT_TOL * scale, (case, what, err, scale)


@pytest.mark.parametrize("case", list(CASES))
def test_tp2_logits_match_the_jax_model(tp2, case):
    got = tp2.ranks[0][case]["logits"]
    tol = JAX_TOL.get(case, 1e-5)
    V = port_cfg(case).vocab_size
    for what, want in tp2.jax[case].items():
        assert got[what].shape[:-1] == want.shape[:-1], (case, what)
        err, scale = _err(got[what], want, V)
        assert err <= tol * scale, (case, what, err, scale)


@pytest.mark.parametrize("case", list(CASES))
def test_tp2_all_reduces_per_step(tp2, case):
    """One all-reduce per sharded block and none per whole one: the
    reference's count plus the embedding's, per forward and per decode
    step, on both ranks."""
    for r in tp2.ranks:
        got = r[case]
        n = got["collectives_per_iteration"] + 1
        assert got["forward reduces"] == n, (case, got["forward reduces"])
        assert got["decode reduces"] == n, (case, got["decode reduces"])
    cfg = port_cfg(case)
    ctx = DeviceContext(cfg, "cpu", tp=TP, rank=0)
    kinds = set(cfg.block_pattern)
    if kinds <= {"mlstm", "slstm"}:
        assert n == 2                      # the vocab's two, no block's
    if case == "paligemma":
        assert not ctx.sharded("heads") and ctx.sharded("ffn")
        assert n == cfg.num_layers + 2     # the MLPs; attention is whole


@pytest.mark.parametrize("name", sorted(FULL_REDUCES))
def test_full_configs_all_reduces_at_tp2(name):
    ctx = DeviceContext(get_config(name), "cpu", tp=TP, rank=1)
    assert ctx.collectives_per_iteration() + 1 == FULL_REDUCES[name]


@pytest.mark.parametrize("case", list(CASES))
def test_rank_widths(tp2, case):
    """Each rank holds its widths: KV-head and Mamba2 shards, whole MLA
    latents and xLSTM state, its experts or its share of each expert."""
    cfg = port_cfg(case)
    ctx = DeviceContext(cfg, "cpu", tp=TP, rank=0)
    W, n = cfg.ssm_conv, cfg.ssm_state
    # the xLSTM states stay whole: TP 1's shapes
    one = _build_cache(cfg, B, 1, torch.float32, False, "cpu",
                       attention=False, ctx=DeviceContext(cfg, "cpu"))
    whole = {k: [tuple(t.shape) for t in c]
             for k, c in zip(cfg.block_pattern, one) if c is not None}
    for r in tp2.ranks:
        got = r[case]["widths"]
        for kind, st, pool in zip(cfg.block_pattern, got["state"],
                                  got["pools"]):
            if kind == "mamba2":
                assert st == [(B, W - 1, cfg.d_inner // TP + 2 * n),
                              (B, cfg.ssm_heads // TP, cfg.ssm_head_dim,
                               n)], st
                assert ctx.local_d_inner == cfg.d_inner // TP
                assert ctx.local_ssm_heads == cfg.ssm_heads // TP
            elif kind in ("mlstm", "slstm"):
                assert st == whole[kind], st
            elif kind in ("mla", "mla_moe"):
                assert st is None
                assert pool == [(5, 8, cfg.kv_lora_rank),
                                (5, 8, cfg.qk_rope_dim)]
            else:
                G = cfg.num_kv_heads // (TP if ctx.sharded("kv_heads")
                                         else 1)
                assert st is None and pool == [(5, 8, G, cfg.head_dim)] * 2
        if cfg.is_moe:
            E, D, F = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
            want = ((E // TP, D, F) if ctx.sharded("experts")
                    else (E, D, F // TP))
            assert got["experts"] == want, (case, got["experts"])
            assert ctx.local_experts == want[0]
    assert ctx.sharded("experts") == (case != "granite-moe-e3"
                                      and cfg.is_moe)


@pytest.mark.parametrize("path", ["paged", "slab"])
@pytest.mark.parametrize("engine", ["DuetEngine", "AsyncDuetEngine"])
@pytest.mark.parametrize("case", ENGINE_CASES)
def test_tp2_engines_match_jax_greedy_oracle(tp2, case, engine, path):
    key = (path == "paged", engine)
    r0, r1 = (r[case][key] for r in tp2.ranks)
    assert r0["finished"] == 3
    assert r0["tokens"] == tp2.oracle[case], case
    assert r0["tokens"] == r1["tokens"]
    if engine == "AsyncDuetEngine":
        assert 0 < r0["host_syncs"] <= r0["super_iterations"]


def test_serve_cli_tp2_deepseek_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "deepseek-v2-lite-16b", "--reduced", "--device", "cpu", "--tp",
         "2", "--num-requests", "3", "--max-len", "128"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    summary = json.loads(proc.stdout[proc.stdout.index("{\n"):])
    assert summary["num_finished"] == 3
    assert summary["mesh"]["tp"] == 2 and summary["mesh"]["backend"] == "gloo"
    assert summary["collectives_per_iteration"] == 2 * 2 + 1
