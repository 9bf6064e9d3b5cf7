"""Port parity for data-parallel serving over tensor-parallel replicas:
two gloo ranks on the CPU (``launch.mesh.run_ranks``, one torch thread
each) each run the cluster router over their rank of two TP 2 replicas
of reduced qwen3-4b (fp32, the kernel path's plain versions, the weights
from the JAX ``init`` through ``params_from_jax``); every replica is a
process group of its own (``DeviceContext.split_replicas``).

Held:

* round-robin streams at DP 2 x TP 2 equal DP 2 x TP 1's (the port's
  router in this process) and the greedy oracle from the JAX
  ``Model.forward``, on both ranks; the async replicas stream the same
  tokens with at most one host sync a super-iteration;
* least-loaded and prefix-affinity decisions (replica, matched tokens)
  equal the port's and the reference's ``ClusterSim`` over replicas of
  the same geometry (2 units at TP 2), on both ranks;
* an elastic scale-down drains a replica that still holds two requests,
  and both ranks drain and requeue the same requests, as the simulators
  do, and recompute them to the oracle's tokens;
* ``serve --tp 2 --dp 2`` (its per-rank body) serves every request and
  its streams equal ``serve --dp 2`` alone.

The rank body is a module-level function the spawned ranks import, so
this module imports neither ``jax`` nor ``repro`` at its top.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.device import DeviceContext
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import Model, params_from_jax
from repro_torch.serving import (AsyncDuetEngine, DuetEngine, EngineConfig,
                                 TokenEvent)
from repro_torch.serving.router import ElasticConfig, Router

DP, TP = 2, 2
# (policy, engine, elastic case or None) of each router run
RUNS = {"round-robin": ("round-robin", DuetEngine, None),
        "round-robin async": ("round-robin", AsyncDuetEngine, None),
        "least-loaded": ("least-loaded", DuetEngine, None),
        "prefix": ("prefix", DuetEngine, None),
        "elastic drain": ("round-robin", DuetEngine, "drain")}
# the serve CLI's flags for both of its runs
CLI = ["--reduced", "--device", "cpu", "--dp", "2", "--num-requests", "4",
       "--max-len", "128", "--token-budget", "64"]
# simulated replicas of the engines' geometry: 2 units at TP 2 (see
# tests/test_torch_router.py for the 1 GB a unit)
SIMCFG = dict(units=TP, tp=TP, hbm_per_unit=1e9)


def _cfg():
    return reduced(get_config("qwen3-4b"))


def _run(model, ctx, reqs, policy, cls, ec, elastic):
    router = Router(model, EngineConfig(**ec), ctx=ctx, policy=policy,
                    engine_cls=cls, elastic=elastic)
    router.submit([copy.deepcopy(r) for r in reqs])
    events = []
    metrics = router.run(on_event=events.append)
    streamed = {}
    for ev in events:
        if isinstance(ev, TokenEvent):
            streamed.setdefault(ev.rid, []).append(ev.token)
    out = {"tokens": {r.rid: [int(t) for t in r.output_tokens]
                      for r in metrics.requests},
           "streamed": streamed,
           "finished": metrics.summary()["num_finished"],
           "generated": sorted((r.rid, r.generated, r.output_len)
                               for r in metrics.requests),
           "decisions": [(d.replica, d.matched_tokens)
                         for d in router.decisions],
           "scale": [(e.action, e.replica, e.requeued)
                     for e in router.scale_events],
           "used_pages": [e.kv_mgr.used_pages for e in router.engines],
           "summary": router.router_summary(),
           "meshes": [e.ctx.describe() for e in router.engines],
           "groups": len({id(e.ctx.group) for e in router.engines})}
    if cls is AsyncDuetEngine:
        out["syncs"] = [(e.dstats.host_syncs, e.dstats.super_iterations)
                        for e in router.engines]
    return out


def grid_body(rank, tree, traces, cases):
    """One rank: every router run over its rank of both replicas, then the
    serve CLI's per-rank body."""
    torch.set_num_threads(1)
    cfg = _cfg()
    ctx = rank.context(cfg, dp=DP)
    local = ctx.place_params(params_from_jax(cfg, tree))
    model = Model(cfg, local, ctx=ctx, attn_kernel=True)
    res = {}
    for label, (policy, cls, case) in RUNS.items():
        ec, ecfg, _ = cases[case or "pairs"]
        res[label] = _run(model, ctx, traces[case or "pairs"], policy, cls,
                          ec, None if ecfg is None
                          else ElasticConfig(**ecfg))
    res["cli"] = serve_cli.serve(rank, serve_cli.build_parser().parse_args(
        CLI + ["--tp", str(TP)]))
    return res


# ---------------------------------------------------------------------------
# the fixture: the oracle, the sims, DP 2 x TP 1, and the two ranks
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def grid():
    import jax
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import Model as JModel
    from repro.serving import router as jrouter
    from repro.serving import simulator as jsim
    from repro.serving.request import Request as JRequest
    from repro_torch.serving import simulator as sim
    from test_torch_router import (EC, ELASTIC, _oracle, burst_trace,
                                   pair_trace)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jcfg = jreduced(jget_config("qwen3-4b"))
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    cfg = _cfg()
    forward = jax.jit(lambda toks: jmodel.forward(jparams, toks))
    drain_ec, drain_ecfg, olen = ELASTIC["drain"]
    traces = {"pairs": pair_trace(cfg.vocab_size),
              "drain": burst_trace(cfg.vocab_size, olen)}
    cases = {"pairs": (EC, None, None), "drain": ELASTIC["drain"]}
    oracle = {k: _oracle(forward, v) for k, v in traces.items()}

    def sims(case, policy):
        reqs, (ec, ecfg, _) = traces[case], cases[case]
        el = None if ecfg is None else ElasticConfig(**ecfg)
        mine = sim.ClusterSim(
            lambda i: sim.make_duet_instance(
                cfg, sim.SimConfig(**SIMCFG),
                token_budget=ec["token_budget"]), n=DP, policy=policy,
            elastic=el)
        ref = jsim.ClusterSim(
            lambda i: jsim.make_duet_instance(
                jcfg, jsim.SimConfig(**SIMCFG),
                token_budget=ec["token_budget"]), n=DP, policy=policy,
            elastic=None if ecfg is None
            else jrouter.ElasticConfig(**ecfg))
        mine.run([copy.deepcopy(r) for r in reqs])
        ref.run([JRequest(rid=r.rid, arrival=r.arrival,
                          prompt_len=r.prompt_len, output_len=r.output_len,
                          prompt_tokens=np.array(r.prompt_tokens))
                 for r in reqs])
        return [mine, ref]

    sim_runs = {label: sims(case or "pairs", policy)
                for label, (policy, _, case) in RUNS.items()
                if label != "round-robin async"}
    tmodel = Model(cfg, params_from_jax(cfg, tree), attn_kernel=True)
    tp1 = _run(tmodel, DeviceContext.for_replicas(cfg, DP, "cpu"),
               traces["pairs"], "round-robin", DuetEngine, EC, None)
    cli_dp = serve_cli.serve(None, serve_cli.build_parser().parse_args(CLI))
    ranks = run_ranks(grid_body, TP, device="cpu",
                      args=(tree, traces, cases))
    torch.set_num_threads(n)
    return dict(ranks=ranks, oracle=oracle, sims=sim_runs, tp1=tp1,
                cli_dp=cli_dp, traces=traces)


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("label", list(RUNS))
def test_ranks_make_the_same_decisions_and_streams(grid, label):
    """Both ranks' routers route, scale and stream identically; every
    replica is a TP 2 context over a process group of its own."""
    r0, r1 = (r[label] for r in grid["ranks"])
    for key in ("tokens", "decisions", "scale", "summary", "generated"):
        assert r0[key] == r1[key], (label, key)
    case = RUNS[label][2] or "pairs"
    assert r0["finished"] == len(grid["traces"][case])
    assert all(g == want for _, g, want in r0["generated"])
    assert r0["used_pages"] == [0, 0]
    assert r0["groups"] == DP
    assert [m["tp"] for m in r0["meshes"]] == [TP, TP]
    assert r0["tokens"] == grid["oracle"][case], label


def test_round_robin_matches_tp1_replicas_and_oracle(grid):
    r0 = grid["ranks"][0]["round-robin"]
    assert r0["tokens"] == grid["tp1"]["tokens"] == grid["oracle"]["pairs"]
    assert r0["decisions"] == grid["tp1"]["decisions"]
    assert [d for d, _ in r0["decisions"]] == [i % DP for i in range(
        len(grid["traces"]["pairs"]))]
    a = grid["ranks"][0]["round-robin async"]
    assert a["tokens"] == a["streamed"] == r0["tokens"]
    for r in grid["ranks"]:
        assert all(0 < s <= n for s, n in r["round-robin async"]["syncs"])


@pytest.mark.parametrize("label", ["least-loaded", "prefix"])
def test_dispatch_decisions_match_cluster_sim(grid, label):
    """The real TP 2 replicas' (replica, matched) decisions are the port's
    and the reference's ClusterSim's over replicas of the same geometry;
    prefix affinity sends each pair's second member to its first's warm
    replica."""
    got = grid["ranks"][0][label]["decisions"]
    for s in grid["sims"][label]:
        assert [(d.replica, d.matched_tokens) for d in s.decisions] == got
    if label == "prefix":
        for g in range(0, len(got), 2):
            assert got[g][1] == 0 and got[g + 1][1] > 0
            assert got[g + 1][0] == got[g][0]


def test_elastic_scale_down_drains_the_same_requests_on_both_ranks(grid):
    r0 = grid["ranks"][0]["elastic drain"]
    assert ("up", 1, 0) in r0["scale"]
    assert [s[:2] for s in r0["scale"] if s[0] == "down"] == [("down", 1)]
    for s in grid["sims"]["elastic drain"]:
        assert [(e.action, e.replica, e.requeued)
                for e in s.scale_events] == r0["scale"]
        assert [d.replica for d in s.decisions] == \
            [d for d, _ in r0["decisions"]]
    es = r0["summary"]["elastic"]
    assert es["requeued_requests"] == 2 and es["final_active"] == [0]


def test_serve_cli_tp2_dp2_streams_equal_dp2(grid):
    a, b = (r["cli"] for r in grid["ranks"])
    assert a == b == grid["cli_dp"]
    assert len(a) == 4 and all(len(t) > 0 for t in a.values())
