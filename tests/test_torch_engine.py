"""Port parity for serving: the port's ``DuetEngine`` and
``AsyncDuetEngine`` on the CPU with the kernel path on (the kernels' plain
versions) against a greedy oracle computed with the JAX ``Model.forward``
on the same weights, and the copied host modules (roofline, partition,
multiplexer, scheduler, page manager) against their JAX namesakes on
seeded inputs.

The JAX engines themselves are not the oracle here: with jax 0.9 on a CPU
backend they raise a ShardingTypeError (the embedding gather under the
engine's parameter shardings), while the model-level functions run on
every backend."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.multiplexer import AdaptiveMultiplexer as JMux
from repro.core.roofline import RequestLoad as JLoad
from repro.core.roofline import RooflineModel as JRoofline
from repro.models import Model as JModel
from repro.serving.kvcache import PagedKVCacheManager as JManager
from repro.serving.kvcache import PagePoolConfig as JPoolConfig
from repro.serving.kvcache import copy_pool_pages as jcopy
from repro.serving.kvcache import gather_kv as jgather
from repro.serving.kvcache import write_kv_page as jwrite
from repro.serving.request import Request as JRequest
from repro.serving.request import synth_prompt_tokens as jsynth
from repro.serving.scheduler import DuetPolicy as JDuetPolicy
from repro.serving.scheduler import QueueState as JQueueState
from repro_torch.configs import get_config, reduced
from repro_torch.core.device import DeviceContext
from repro_torch.core.multiplexer import AdaptiveMultiplexer
from repro_torch.core.roofline import RequestLoad, RooflineModel
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ops import build_duet_schedule, duet_block_q
from repro_torch.models import Model, params_from_jax
from repro_torch.serving import (AsyncDuetEngine, DuetEngine, EngineConfig,
                                 FinishEvent, Request, TokenEvent)
from repro_torch.serving.kvcache import (PagedKVCacheManager, PagePoolConfig,
                                         copy_pool_pages, gather_kv,
                                         init_page_pools, write_kv_page)
from repro_torch.serving.scheduler import DuetPolicy, QueueState

KW = dict(max_slots=3, max_len=128, token_budget=48, page_size=8)
# arrivals 0.3 ms apart on the virtual clock: later prompts prefill while
# earlier requests decode, so the async engine fuses duet steps
SPECS = [(i, i * 0.0003, 20 + 7 * i, 6 + i) for i in range(5)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the reduced model's ops are tiny, and with the
    suite's parallel workers sharing the cores, torch's default thread
    team per op slows these tests by an order of magnitude or more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = jreduced(jget_config("qwen3-4b"))
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = reduced(get_config("qwen3-4b"))
    tmodel = Model(tcfg, params_from_jax(
        tcfg, jax.tree.map(np.asarray, jparams)), attn_kernel=True)
    forward = jax.jit(lambda toks: jmodel.forward(jparams, toks))
    return jcfg, forward, tcfg, tmodel


def greedy_oracle(forward, vocab, specs):
    """Greedy continuations from the JAX full-sequence forward: every
    sequence is right-padded to one length (causal attention makes the
    padding invisible to earlier positions), so the forward compiles once
    and each step extends every unfinished request by its argmax."""
    seqs = {rid: list(jsynth(rid, vocab, p)) for rid, _, p, _ in specs}
    want = {rid: o for rid, _, _, o in specs}
    out = {rid: [] for rid in seqs}
    L = max(p + o for _, _, p, o in specs)
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


def _workload(specs):
    return [Request(rid=rid, arrival=a, prompt_len=p, output_len=o)
            for rid, a, p, o in specs]


def _serve(cls, model, specs, **kw):
    eng = cls(model, EngineConfig(**kw), device="cpu")
    eng.submit(_workload(specs))
    metrics = eng.run()
    return eng, metrics, {r.rid: list(r.output_tokens)
                          for r in metrics.requests}


@pytest.fixture(scope="module")
def oracle(setup):
    jcfg, forward, tcfg, tmodel = setup
    return greedy_oracle(forward, tcfg.vocab_size, SPECS)


def test_sync_engine_matches_jax_greedy_oracle(setup, oracle):
    jcfg, forward, tcfg, tmodel = setup
    eng, metrics, toks = _serve(DuetEngine, tmodel, SPECS, **KW)
    assert eng.kernel_path == "torch"        # CPU: the plain versions run
    assert metrics.summary()["num_finished"] == len(SPECS)
    assert toks == oracle
    assert eng.kv_mgr.used_pages == 0


def test_async_engine_matches_sync_and_oracle(setup, oracle):
    """Async tokens, event stream and ServingMetrics summary are identical
    to the synchronous engine's; at most one host sync per
    super-iteration; the fused duet step was dispatched."""
    jcfg, forward, tcfg, tmodel = setup
    _, sync_metrics, sync_toks = _serve(DuetEngine, tmodel, SPECS, **KW)
    eng = AsyncDuetEngine(tmodel, EngineConfig(**KW), device="cpu")
    eng.submit(_workload(SPECS))
    stream = {}
    for ev in eng.events():
        if isinstance(ev, TokenEvent):
            toks = stream.setdefault(ev.rid, [])
            assert ev.index == len(toks)
            toks.append(ev.token)
        elif isinstance(ev, FinishEvent):
            assert ev.reason == "completed"
    metrics = eng.run()
    got = {r.rid: list(r.output_tokens) for r in metrics.requests}
    assert got == sync_toks == oracle
    assert stream == oracle
    assert metrics.summary() == sync_metrics.summary()
    st = eng.dstats
    assert 0 < st.host_syncs <= st.super_iterations
    assert st.cache_hits + st.cache_misses == st.dispatches
    assert any(key[-1] for key in eng._programs), "no duet dispatch"
    assert eng.kv_mgr.used_pages == 0


def test_async_engine_duet_tiles_hold_the_engine_block_q(setup, oracle,
                                                        monkeypatch):
    """The async engine's fused duet launch takes its chunk in tiles of
    ``ops.duet_block_q`` = 64 // rep rows (the reference keeps one row a
    tile; only scheduling differs): every duet_attention_paged call of the
    run gets that block_q and a schedule built with it, and the greedy
    tokens stay the oracle's."""
    jcfg, forward, tcfg, tmodel = setup
    bq = duet_block_q(tcfg.num_heads, tcfg.num_kv_heads, tcfg.head_dim)
    assert bq == 64 // (tcfg.num_heads // tcfg.num_kv_heads) > 1
    seen = []
    plain = kernel_ops.duet_attention_paged

    def spy(q, row_pos, tile_slot, *args, block_q):
        seen.append((block_q, q.shape[0], tile_slot.shape[0]))
        return plain(q, row_pos, tile_slot, *args, block_q=block_q)
    monkeypatch.setattr(kernel_ops, "duet_attention_paged", spy)
    eng, metrics, toks = _serve(AsyncDuetEngine, tmodel, SPECS, **KW)
    assert toks == oracle
    assert seen and all(b == bq and R == T * bq for b, R, T in seen)
    for chunk, order in eng._duet_orders.items():
        sched = build_duet_schedule(
            [(b, 0) for b in range(KW["max_slots"])],
            [(KW["max_slots"], i) for i in range(chunk)], block_q=bq)
        np.testing.assert_array_equal(order.numpy(), sched.row_src)
    assert 0 < eng.dstats.host_syncs <= eng.dstats.super_iterations


@pytest.mark.parametrize("cls", [DuetEngine, AsyncDuetEngine])
def test_tiny_pool_preemption_keeps_oracle_tokens(setup, cls):
    """A 56-token pool forces look-ahead shrink and preemption with
    recompute-from-prompt; greedy tokens still equal the oracle's."""
    jcfg, forward, tcfg, tmodel = setup
    specs = [(i, 0.0, 20, 12) for i in range(2)]
    kw = dict(KW, max_slots=2, kv_pool_tokens=56)
    eng, metrics, toks = _serve(cls, tmodel, specs, **kw)
    assert metrics.summary()["num_finished"] == 2
    assert metrics.summary()["num_preemptions"] > 0
    assert toks == greedy_oracle(forward, tcfg.vocab_size, specs)
    assert eng.kv_mgr.used_pages == 0


def test_split_kv_threshold_path_matches_oracle(setup, oracle):
    """The decode dispatcher's split-KV branch (threshold 8 tokens) serves
    the same greedy tokens."""
    jcfg, forward, tcfg, tmodel = setup
    _, _, toks = _serve(AsyncDuetEngine, tmodel, SPECS,
                        split_kv_threshold=8, **KW)
    assert toks == oracle


def _tier_trace(vocab, shared=16, polluter_len=48, out=4):
    """Sharers of one 16-token prefix interleaved with polluters whose
    footprint spans nearly the whole 64-token pool, so every later sharer
    re-locks the prefix through a host-tier demote -> promote round trip
    (the reference's tiered-KV trace)."""
    common = np.random.default_rng(99).integers(0, vocab, shared)
    reqs = []
    for i in range(5):
        if i % 2 == 0:
            toks = np.concatenate([common, np.random.default_rng(
                1000 + i).integers(0, vocab, 8)])
        else:
            toks = np.random.default_rng(2000 + i).integers(
                0, vocab, polluter_len)
        toks = toks.astype(np.int32)
        reqs.append(Request(rid=i, arrival=0.01 * i, prompt_len=len(toks),
                            output_len=out, prompt_tokens=toks))
    return reqs


@pytest.mark.parametrize("cls", [DuetEngine, AsyncDuetEngine])
def test_host_tier_round_trip_keeps_tokens(setup, cls):
    """Pages demoted to the host tier are captured as snapshots (the pools
    are updated in place) and promoted back byte-exact: the warm run's
    tokens equal the cold-cache run's."""
    jcfg, forward, tcfg, tmodel = setup
    kw = dict(max_slots=1, max_len=128, token_budget=48, page_size=8)
    runs = {}
    for label, extra in (("cold", dict(prefix_cache=False)),
                         ("warm", dict(prefix_cache=True, kv_pool_tokens=64,
                                       host_kv_tokens=512))):
        eng = cls(tmodel, EngineConfig(**kw, **extra), device="cpu")
        reqs = _tier_trace(tcfg.vocab_size)
        eng.submit(reqs)
        assert eng.run().summary()["num_finished"] == 5
        runs[label] = {r.rid: list(r.output_tokens) for r in reqs}
    st = eng.kv_mgr.prefix_stats()
    assert st["demotions"] > 0 and st["promotions"] > 0
    assert runs["warm"] == runs["cold"]
    assert eng.kv_mgr.used_pages == 0


def test_engine_rejects_unported_modes(setup):
    """EngineConfig.tp on a single-device model is the reference's
    modelling-only knob (the planner prices TP 2, one device runs). Every
    block kind serves under tensor parallelism (an MoE model builds at TP
    2); data parallelism over TP groups is not yet ported."""
    jcfg, forward, tcfg, tmodel = setup
    eng = DuetEngine(tmodel, EngineConfig(tp=2), device="cpu")
    assert eng.mux.model.tp == 2 and eng.ctx.tp == 1
    moe = reduced(get_config("granite-moe-3b-a800m"))
    Model.init(moe, device="cpu", ctx=DeviceContext(moe, "cpu", tp=2, rank=0))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        DeviceContext(moe, "cpu", tp=2, dp=2)


# ---------------------------------------------------------------------------
# copied host modules against the reference
# ---------------------------------------------------------------------------
def _loads(rng, n, cls):
    return [cls(q=int(q), c=int(c), phase=ph) for q, c, ph in zip(
        rng.integers(1, 300, n), rng.integers(0, 4000, n),
        rng.choice(["prefill", "decode"], n))]


@pytest.mark.parametrize("name", ["qwen3-4b", "qwen3-14b", "yi-9b",
                                  "minicpm-2b", "granite-20b"])
def test_roofline_matches_jax(name):
    rng = np.random.default_rng(0)
    for page_size in (1, 16):
        a = RooflineModel(get_config(name), page_size=page_size)
        b = JRoofline(jget_config(name), page_size=page_size)
        assert a.split_kv_threshold() == b.split_kv_threshold()
        assert a.model_flops_per_token() == b.model_flops_per_token()
        for _ in range(5):
            seed = int(rng.integers(1 << 30))
            la = _loads(np.random.default_rng(seed), 6, RequestLoad)
            lb = _loads(np.random.default_rng(seed), 6, JLoad)
            for units in (1, 8, None):
                assert a.iteration_latency(la, units) == \
                    b.iteration_latency(lb, units)


@pytest.mark.parametrize("units", [1, 8])
def test_multiplexer_decisions_match_jax(units):
    cfg, jcfg = get_config("qwen3-4b"), jget_config("qwen3-4b")
    a = AdaptiveMultiplexer(cfg, total_units=units, tbt_slo=0.03,
                            page_size=16)
    b = JMux(jcfg, total_units=units, tbt_slo=0.03, page_size=16)
    rng = np.random.default_rng(units)
    for _ in range(6):
        n_pre, n_dec = int(rng.integers(0, 3)), int(rng.integers(0, 9))
        pre = [(int(rng.integers(16, 512)), int(rng.integers(0, 1024)))
               for _ in range(n_pre)]
        dec = [int(rng.integers(16, 3000)) for _ in range(n_dec)]
        da = a.step([RequestLoad(q, c, "prefill") for q, c in pre],
                    [RequestLoad(1, c) for c in dec])
        db = b.step([JLoad(q, c, "prefill") for q, c in pre],
                    [JLoad(1, c) for c in dec])
        assert (da.mode, da.t_mixed) == (db.mode, db.t_mixed)
        assert (da.partition is None) == (db.partition is None)
        if da.partition is not None:
            assert vars(da.partition) == vars(db.partition)
    assert vars(a.stats) == vars(b.stats)


def test_duet_policy_plans_match_jax():
    cfg, jcfg = get_config("qwen3-4b"), jget_config("qwen3-4b")
    rng = np.random.default_rng(5)
    specs = [(i, float(i) * 0.01, int(rng.integers(20, 600)),
              int(rng.integers(2, 40))) for i in range(10)]
    plans = []
    for mux_cls, pol_cls, qs_cls, req_cls, c in (
            (AdaptiveMultiplexer, DuetPolicy, QueueState, Request, cfg),
            (JMux, JDuetPolicy, JQueueState, JRequest, jcfg)):
        policy = pol_cls(mux_cls(c, total_units=1, tbt_slo=0.02,
                                 page_size=16), token_budget=256,
                         max_batch=6)
        reqs = [req_cls(rid=r, arrival=a, prompt_len=p, output_len=o)
                for r, a, p, o in specs]
        state = qs_cls()
        state.admit_arrivals(reqs, 1.0)
        seq = []
        for _ in range(12):
            plan = policy.schedule(state)
            seq.append((plan.mode, [r.rid for r in plan.decode],
                        [(r.rid, n) for r, n in plan.prefill]))
            for r, n in plan.prefill:     # pretend the chunks ran
                r.prefilled += n
                if r.remaining_prompt == 0:
                    state.prefilling.remove(r)
                    state.running.append(r)
            for r in plan.decode:
                r.generated += 1
        plans.append(seq)
    assert plans[0] == plans[1]


def test_page_manager_matches_jax():
    """One seeded sequence of allocate / look-ahead / commit / free /
    prefix-cache operations on both managers gives the same page tables,
    free counts and prefix statistics."""
    mgrs = [PagedKVCacheManager(PagePoolConfig(num_pages=40, page_size=8),
                                prefix_cache=True),
            JManager(JPoolConfig(num_pages=40, page_size=8),
                     prefix_cache=True)]
    rng = np.random.default_rng(9)
    ops = []
    live = []
    common = rng.integers(0, 500, 24).astype(np.int32)
    for step in range(60):
        op = int(rng.integers(0, 4))
        if op == 0 or not live:
            rid = step
            toks = np.concatenate([common, rng.integers(
                0, 500, int(rng.integers(1, 30))).astype(np.int32)])
            ops.append(("lock", rid, toks))
            ops.append(("alloc", rid, len(toks)))
            ops.append(("insert", rid, toks))
            live.append(rid)
        elif op == 1:
            ops.append(("lookahead", list(live), int(rng.integers(1, 4))))
        elif op == 2:
            ops.append(("commit", live[int(rng.integers(len(live)))], 1))
        else:
            ops.append(("free", live.pop(int(rng.integers(len(live))))))
    trace = []
    for mgr in mgrs:
        out = []
        for op in ops:
            kind = op[0]
            if kind == "lock":
                out.append(mgr.lock_prefix(op[1], op[2]))
            elif kind == "alloc":
                n = op[2] - mgr.length(op[1])
                if n > 0 and mgr.can_allocate(op[1], n):
                    out.append(mgr.allocate(op[1], n))
            elif kind == "insert":
                mgr.insert_prefix(op[1], op[2])
            elif kind == "lookahead":
                rids = [r for r in op[1] if mgr.page_table(r)]
                out.append(mgr.reserve_lookahead(rids, op[2]))
            elif kind == "commit":
                if mgr.page_table(op[1]):
                    mgr.commit_tokens(op[1], op[2])
            else:
                mgr.free(op[1])
            out.append((mgr.free_pages, mgr.used_pages))
        out.append(mgr.prefix_stats())
        out.append(mgr.padded_tables(sorted(set(live)), 40).tolist())
        trace.append(out)
    assert trace[0] == trace[1]


def test_pool_device_helpers_match_jax():
    """The torch half of kvcache (in place) against the JAX half
    (functional): a token scatter, a chain gather and CoW page copies."""
    tcfg = reduced(get_config("qwen3-4b"))
    rng = np.random.default_rng(4)
    pages = rng.standard_normal((10, 4, 2, 8)).astype(np.float32)
    kv = rng.standard_normal((2, 3, 2, 8)).astype(np.float32)
    ids = np.asarray([[3, 3, 4], [7, 7, 7]], np.int32)
    offs = np.asarray([[1, 2, 0], [0, 1, 3]], np.int32)
    got = write_kv_page(torch.from_numpy(pages.copy()), torch.from_numpy(kv),
                        torch.from_numpy(ids), torch.from_numpy(offs))
    want = jwrite(jnp.asarray(pages), jnp.asarray(kv), jnp.asarray(ids),
                  jnp.asarray(offs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    table = np.asarray([3, 4, 9], np.int32)
    np.testing.assert_array_equal(
        gather_kv(got, torch.from_numpy(table), 6).numpy(),
        np.asarray(jgather(want, jnp.asarray(table), 6)))
    pools = init_page_pools(tcfg, PagePoolConfig(num_pages=10, page_size=4))
    assert all(p[0].shape == (10, 4, tcfg.num_kv_heads, tcfg.head_dim)
               for p in pools)
    pools = [(torch.from_numpy(pages.copy()), torch.from_numpy(-pages))]
    jpools = [(jnp.asarray(pages), jnp.asarray(-pages))]
    copies = [(3, 8), (4, 2)]
    out = copy_pool_pages(pools, copies)
    jout = jcopy(jpools, copies)
    assert out is pools                      # updated in place
    for a, b in zip(out[0], jout[0]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
