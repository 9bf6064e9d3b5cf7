"""Port parity for data-parallel serving: the port's real ``Router`` over
two engine replicas on the CPU (reduced qwen3-4b, fp32, the kernel path's
plain versions), held to the contracts the reference's router tests state
(``tests/test_router.py``, ``tests/test_elastic.py``) and to a greedy
oracle from the JAX ``Model.forward`` on the same weights.

The reference's own DP tests drive the JAX engines in a subprocess with
forced host devices; those engines raise a ShardingTypeError on a CPU
backend with jax 0.9, so the port is held to what those tests state, not
to their results:

* round-robin gives the tokens of two independent engines fed the
  round-robin shards, and alternates strictly;
* prefix affinity routes each pair's second member to its first's warm
  replica, and the real router's ``(replica, matched)`` decisions equal
  the port's ``ClusterSim``'s and the reference's;
* elastic scale-up and scale-down on a burst-then-silence trace make the
  reference ``ClusterSim``'s scaling and dispatch sequences, lose no
  request, count none twice, and the drained requests recompute to the
  oracle's tokens, on sync and async replicas;
* async replicas stream the sync cluster's tokens.

Every request asks for more than one token, as in the reference's
tests (the reference's async engine raises on a one-token request).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.serving import router as jrouter
from repro.serving import simulator as jsim
from repro.serving.request import Request as JRequest
from repro_torch.configs import get_config, reduced
from repro_torch.core.device import DeviceContext
from repro_torch.launch import mesh
from repro_torch.models import Model, params_from_jax
from repro_torch.serving import (AsyncDuetEngine, DuetEngine, EngineConfig,
                                 Request, TokenEvent)
from repro_torch.serving import simulator as sim
from repro_torch.serving.request import synth_prompt_tokens
from repro_torch.serving.router import (ElasticConfig, Router, RouterEvent,
                                        ScaleEvent)

# the reference's pair-trace constants, verbatim: 3 groups of 2 requests;
# each group shares a 32-token prefix (two full default pages), the
# pair's second member arrives after the first's prefill completes
GROUPS, SHARED, GROUP_GAP, PAIR_GAP = 3, 32, 1.5, 0.5
EC = dict(max_slots=4, max_len=256, token_budget=64)
# the reference's burst-then-silence constants, verbatim: 10 requests 2
# ms apart, outstanding work far over the up threshold within the burst,
# then the drain empties the cluster and the down threshold fires
N_REQ, GAP, PLEN, OLEN = 10, 0.002, 120, 40
ECFG = dict(min_replicas=1, max_replicas=2, scale_up_tokens=100,
            scale_down_tokens=20, cooldown_s=0.05, check_interval=0.05)
# elastic cases: (engine config, elastic config, output length). "burst"
# is the reference's geometry, whose scale-down finds replica 1 idle;
# "drain" scales down while replica 1 still holds two requests, which are
# drained, re-routed and recomputed on replica 0 (every burst request
# holds a slot, as the simulated replicas have no slot limit, so the
# simulator's clock stays the engines')
ELASTIC = {"burst": (EC, ECFG, OLEN),
           "drain": (dict(EC, max_slots=N_REQ),
                     dict(ECFG, scale_down_tokens=100), 20)}
# simulated replicas: 1 GB a unit still admits every request of these
# traces, and builds a small admission ledger (see test_torch_simulator)
SIMCFG = dict(units=1, tp=1, hbm_per_unit=1e9)


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


def greedy_oracle(forward, prompts, want):
    """Greedy continuations of ``prompts`` ({rid: token list}) from the
    JAX full-sequence forward, ``want[rid]`` tokens each: every sequence is
    right-padded to one length (causal attention hides the padding), so
    the forward compiles once."""
    seqs = {rid: list(p) for rid, p in prompts.items()}
    out = {rid: [] for rid in seqs}
    L = max(len(p) + want[rid] for rid, p in prompts.items())
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


def _oracle(forward, reqs):
    return greedy_oracle(forward, {r.rid: r.prompt_tokens for r in reqs},
                         {r.rid: r.output_len for r in reqs})


def pair_trace(vocab):
    reqs = []
    for g in range(GROUPS):
        common = np.random.default_rng(1000 + g).integers(
            0, vocab, SHARED).astype(np.int32)
        for j in range(2):
            rid = 2 * g + j
            plen = 36 + 4 * g
            body = synth_prompt_tokens(rid, vocab, plen)
            reqs.append(Request(
                rid=rid, arrival=g * GROUP_GAP + j * PAIR_GAP,
                prompt_len=plen + SHARED, output_len=6 + g,
                prompt_tokens=np.concatenate([common, body])))
    return reqs


def burst_trace(vocab, olen=OLEN):
    return [Request(rid=i, arrival=i * GAP, prompt_len=PLEN,
                    output_len=olen,
                    prompt_tokens=synth_prompt_tokens(i, vocab, PLEN))
            for i in range(N_REQ)]


def _toks(metrics):
    return {r.rid: list(r.output_tokens) for r in metrics.requests}


def _run_router(tmodel, reqs, policy, engine_cls=DuetEngine, elastic=None,
                ec=EC):
    router = Router(tmodel, EngineConfig(**ec),
                    ctx=DeviceContext.for_replicas(tmodel.cfg, 2, "cpu"),
                    policy=policy, engine_cls=engine_cls, elastic=elastic)
    router.submit([copy.deepcopy(r) for r in reqs])
    events = []
    metrics = router.run(on_event=events.append)
    return router, metrics, events


def _sims(tcfg, reqs, policy, elastic=None):
    """The port's and the reference's ClusterSim on ``reqs``."""
    jcfg = jreduced(jget_config("qwen3-4b"))
    mine = sim.ClusterSim(
        lambda i: sim.make_duet_instance(tcfg, sim.SimConfig(**SIMCFG),
                                         token_budget=EC["token_budget"]),
        n=2, policy=policy,
        elastic=None if elastic is None else ElasticConfig(**elastic))
    ref = jsim.ClusterSim(
        lambda i: jsim.make_duet_instance(jcfg, jsim.SimConfig(**SIMCFG),
                                          token_budget=EC["token_budget"]),
        n=2, policy=policy,
        elastic=None if elastic is None else jrouter.ElasticConfig(
            **elastic))
    mine.run([copy.deepcopy(r) for r in reqs])
    ref.run([JRequest(rid=r.rid, arrival=r.arrival, prompt_len=r.prompt_len,
                      output_len=r.output_len,
                      prompt_tokens=np.array(r.prompt_tokens))
             for r in reqs])
    return mine, ref


# ------------------------------------------------------------ round-robin
def test_round_robin_matches_independent_engines_and_oracle(setup):
    _, forward, tcfg, tmodel = setup
    reqs = pair_trace(tcfg.vocab_size)
    indep, indep_hits = {}, 0
    for shard in (reqs[0::2], reqs[1::2]):
        eng = DuetEngine(tmodel, EngineConfig(**EC), device="cpu")
        eng.submit([copy.deepcopy(r) for r in shard])
        indep.update(_toks(eng.run()))
        indep_hits += eng.kv_mgr.prefix_stats()["hit_tokens"]
    router, m, events = _run_router(tmodel, reqs, "round-robin")
    assert _toks(m) == indep == _oracle(forward, reqs)
    assert m.summary()["num_finished"] == 2 * GROUPS
    assert [d.replica for d in router.decisions] == \
        [i % 2 for i in range(2 * GROUPS)]
    assert [e for e in events if isinstance(e, RouterEvent)] == \
        router.decisions
    # round-robin splits every pair: no cross-request hits anywhere
    assert router.prefix_stats()["hit_tokens"] == indep_hits == 0
    s = router.summary()
    assert sorted(k for k in ("router", "per_replica", "slo_attainment")
                  if k in s) == ["per_replica", "router", "slo_attainment"]
    assert s["router"]["dispatch_counts"] == [GROUPS, GROUPS]
    assert [r["mesh"]["dp"] for r in s["per_replica"]] == [1, 1]


# -------------------------------------------------------- prefix affinity
def test_prefix_affinity_routes_pairs_to_warm_replica(setup):
    """Each pair's second member lands on its first's replica with the
    whole shared prefix matched, the cluster hits at least GROUPS*SHARED
    tokens, the tokens are the oracle's, and the real router's
    (replica, matched) decisions are the port's and the reference's
    ClusterSim's."""
    _, forward, tcfg, tmodel = setup
    reqs = pair_trace(tcfg.vocab_size)
    router, m, _ = _run_router(tmodel, reqs, "prefix")
    assert _toks(m) == _oracle(forward, reqs)
    by_rid = {d.rid: d for d in router.decisions}
    for g in range(GROUPS):
        first, second = by_rid[2 * g], by_rid[2 * g + 1]
        assert first.matched_tokens == 0
        assert second.matched_tokens >= SHARED
        assert second.replica == first.replica
    stats = router.prefix_stats()
    assert stats["hit_tokens"] >= GROUPS * SHARED and stats["hit_rate"] > 0
    assert len(stats["per_replica"]) == 2
    real = [(d.replica, d.matched_tokens) for d in router.decisions]
    mine, ref = _sims(tcfg, reqs, "prefix")
    assert [(d.replica, d.matched_tokens) for d in mine.decisions] == real
    assert [(d.replica, d.matched_tokens) for d in ref.decisions] == real
    assert sum(d.matched_tokens for d in router.decisions) >= \
        GROUPS * SHARED


# ---------------------------------------------------------------- elastic
@pytest.mark.parametrize("engine_cls", [DuetEngine, AsyncDuetEngine],
                         ids=["sync", "async"])
@pytest.mark.parametrize("case", list(ELASTIC))
def test_elastic_scale_down_matches_sim_and_oracle(setup, case, engine_cls):
    _, forward, tcfg, tmodel = setup
    ec, ecfg, olen = ELASTIC[case]
    reqs = burst_trace(tcfg.vocab_size, olen)
    router, m, events = _run_router(tmodel, reqs, "round-robin",
                                    engine_cls=engine_cls,
                                    elastic=ElasticConfig(**ecfg), ec=ec)
    scale = [(e.action, e.replica, e.requeued) for e in router.scale_events]
    assert ("up", 1, 0) in scale
    assert [s[:2] for s in scale if s[0] == "down"] == [("down", 1)]
    mine, ref = _sims(tcfg, reqs, "round-robin", elastic=ecfg)
    assert scale == [(e.action, e.replica, e.requeued)
                     for e in mine.scale_events] == \
        [(e.action, e.replica, e.requeued) for e in ref.scale_events]
    dispatch = [d.replica for d in router.decisions]
    assert dispatch == [d.replica for d in mine.decisions] == \
        [d.replica for d in ref.decisions]
    assert [e for e in events if isinstance(e, ScaleEvent)] == \
        router.scale_events
    # nothing lost, nothing counted twice, every drained request
    # recomputed to the oracle's tokens
    assert sorted(r.rid for r in m.requests) == list(range(N_REQ))
    assert m.summary()["num_finished"] == N_REQ
    assert all(r.generated == r.output_len for r in m.requests)
    assert _toks(m) == _oracle(forward, reqs)
    es = router.router_summary()["elastic"]
    assert es["scale_ups"] >= 1 and es["scale_downs"] >= 1
    assert es["final_active"] == [0]
    if case == "drain":
        assert es["requeued_requests"] == 2
        assert sum(r.preemptions for r in m.requests) == 2
    if engine_cls is AsyncDuetEngine:
        streamed = {}
        for ev in events:
            if isinstance(ev, TokenEvent):
                streamed.setdefault(ev.rid, []).append(ev.token)
        assert streamed == _toks(m)
        for eng in router.engines:
            st = eng.dstats
            assert st.host_syncs <= st.super_iterations
    for eng in router.engines:
        assert eng.kv_mgr.used_pages == 0


def test_async_cluster_streams_the_sync_clusters_tokens(setup):
    _, _, tcfg, tmodel = setup
    reqs = pair_trace(tcfg.vocab_size)
    _, sync_m, _ = _run_router(tmodel, reqs, "round-robin")
    router, async_m, events = _run_router(tmodel, reqs, "round-robin",
                                          engine_cls=AsyncDuetEngine)
    streamed = {}
    for ev in events:
        if isinstance(ev, TokenEvent):
            streamed.setdefault(ev.rid, []).append(ev.token)
    assert _toks(async_m) == _toks(sync_m) == streamed
    assert all(0 < e.dstats.host_syncs <= e.dstats.super_iterations
               for e in router.engines)


# --------------------------------------------------------------- geometry
@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_split_replicas_geometry():
    cfg = reduced(get_config("qwen3-4b"))
    ctx = DeviceContext.for_replicas(cfg, 2, "cpu")
    subs = ctx.split_replicas()
    assert len(subs) == 2 and ctx.dp == 2
    assert [c.tp for c in subs] == [1, 1]
    assert [c.dp for c in subs] == [1, 1]
    assert [c.device.type for c in subs] == ["cpu", "cpu"]
    assert ctx.shape == {"data": 2, "model": 1}
    assert ctx.describe()["dp"] == 2
    one = DeviceContext.single(cfg, "cpu")
    assert [c.device for c in one.split_replicas()] == [one.device]
    # one weight tree: a replica on the model's device holds its tensors
    model = Model.init(cfg, seed=0, device="cpu")
    tree = subs[0].place_params(model.param_tree())
    assert tree["final_norm"] is model.param_tree()["final_norm"]
    # replicas of a TP group: the grid's shape, a device a replica
    grid = DeviceContext(cfg, torch.device("cpu"), tp=2, rank=1, dp=2)
    assert grid.shape == {"data": 2, "model": 2}
    assert grid.replica_devices == (torch.device("cpu"),) * 2
    # the router's default context: 2 replicas on the model's device
    router = Router(model, EngineConfig(**EC))
    assert router.ctx.dp == router.n_replicas == 2
    assert [e.device.type for e in router.engines] == ["cpu", "cpu"]
    assert router.engines[0].model.params is not \
        router.engines[1].model.params
    assert router.engines[1].model.params["final_norm"] is \
        model.param_tree()["final_norm"]
    with pytest.raises(ValueError, match="contradicts"):
        Router(model, EngineConfig(**EC), ctx=ctx, replicas=3)
    with pytest.raises(ValueError, match="contradicts"):
        Router(model, EngineConfig(**EC), ctx=ctx,
               elastic=ElasticConfig(max_replicas=3))


def test_replicas_never_share_a_card_quietly(no_cuda, monkeypatch):
    cfg = reduced(get_config("qwen3-4b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceContext.for_replicas(cfg, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.split_data_axis("cuda", 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="--share-card"):
        mesh.split_data_axis("cuda", 2)
    with pytest.raises(ValueError, match="--share-card"):
        DeviceContext(cfg, torch.device("cuda", 0), dp=2)
    assert mesh.split_data_axis("cuda", 2, share_card=True) == \
        (torch.device("cuda", 0),) * 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh.split_data_axis("cuda", 2) == (torch.device("cuda", 0),
                                               torch.device("cuda", 1))
