"""Port parity for the discrete-event simulator and the router's host half:
``repro_torch.serving.simulator`` and the policies of
``repro_torch.serving.router`` against the reference's on the same
requests.

Both packages do the same host float arithmetic in the same order, so the
``ServingMetrics.summary()`` dicts, the dispatch decisions and the scaling
events are equal exactly (compared as canonical JSON, which also equates
NaN with NaN). The elastic and dispatch-policy decision tables of the
reference's tests (``tests/test_elastic.py``, ``tests/test_router.py``)
are held on both packages.
"""
import dataclasses
import json

import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.serving import router as jrouter
from repro.serving import simulator as jsim
from repro.serving.loadgen import make_load as jmake_load
from repro.serving.request import Request as JRequest
from repro.serving.traces import synth_trace as jsynth_trace
from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.serving import router, simulator as sim
from repro_torch.serving.loadgen import make_load
from repro_torch.serving.request import Request
from repro_torch.serving.traces import synth_trace
from test_torch_router import GROUPS, SHARED, pair_trace

CFG, JCFG = get_config("qwen3-4b"), jget_config("qwen3-4b")
# the reduced config's KV is 1 KB a token, so the default 16 GB a unit
# sizes a 14M-page admission ledger that takes seconds to build; 1 GB
# still admits every trace here
REDUCED_SIM = dict(hbm_per_unit=1e9)


def _json(x) -> str:
    return json.dumps(x, sort_keys=True)


def _events(evs):
    return [dataclasses.astuple(e) for e in evs]


def _both(make_trace):
    """The same trace as port and reference Requests."""
    reqs = make_trace()
    mk = (lambda cls: [cls(rid=r.rid, arrival=r.arrival,
                           prompt_len=r.prompt_len, output_len=r.output_len,
                           prompt_tokens=None if r.prompt_tokens is None
                           else np.array(r.prompt_tokens)) for r in reqs])
    return mk(Request), mk(JRequest)


def _azure(n=60, qps=4.0, seed=0):
    return lambda: synth_trace("azure-conv", n, qps, seed=seed)


def test_traces_match_reference():
    mine = synth_trace("azure-code", 40, 3.0, seed=2)
    ref = jsynth_trace("azure-code", 40, 3.0, seed=2)
    assert [(r.arrival, r.prompt_len, r.output_len) for r in mine] == \
        [(r.arrival, r.prompt_len, r.output_len) for r in ref]


@pytest.mark.parametrize("name", list_configs())
def test_kv_sizing_matches_reference(name):
    cfg, jcfg = get_config(name), jget_config(name)
    assert sim.kv_bytes_per_token(cfg) == jsim.kv_bytes_per_token(jcfg)
    assert sim.kv_capacity_tokens(cfg, sim.TPU_V5E, 2) == \
        jsim.kv_capacity_tokens(jcfg, jsim.TPU_V5E, 2)


# ------------------------------------------------------------ InstanceSim
INSTANCES = {
    "duet": dict(units=1, tp=1),
    "duet-tp8": dict(units=8, tp=8),
    "duet-paged-sync": dict(units=1, tp=1, page_size=16,
                            host_sync_overhead=0.002,
                            interruption_free=False),
    "vllm": dict(units=1, tp=1),
    "sglang-chunked": dict(units=1, tp=1, host_sync_overhead=0.001),
    "sglang-default": dict(units=1, tp=1),
}


@pytest.mark.parametrize("kind", list(INSTANCES))
def test_instance_sim_matches_reference(kind):
    """One replica, duet or a baseline policy, on an azure-conv trace at
    saturation: the same metrics summary and per-iteration timeline."""
    simcfg = INSTANCES[kind]
    mine, ref = _both(_azure(80, qps=6.0))
    if kind.startswith("duet"):
        a = sim.make_duet_instance(CFG, sim.SimConfig(**simcfg),
                                   token_budget=2048)
        b = jsim.make_duet_instance(JCFG, jsim.SimConfig(**simcfg),
                                    token_budget=2048)
    else:
        a = sim.make_baseline_instance(CFG, sim.SimConfig(**simcfg), kind)
        b = jsim.make_baseline_instance(JCFG, jsim.SimConfig(**simcfg), kind)
    a.record_trace = b.record_trace = True
    ma, mb = a.run(mine), b.run(ref)
    assert _json(ma.summary()) == _json(mb.summary())
    assert ma.summary()["num_finished"] == 80
    assert _json(a.trace) == _json(b.trace)
    assert ma.duration == mb.duration


def test_instance_sim_drain_matches_reference():
    """``drain_requests`` mid-run: the same requests leave with the same
    replay targets, and the rest of the run is the same."""
    mine, ref = _both(_azure(30, qps=20.0))
    out = []
    for mod, cfg, reqs in ((sim, CFG, mine), (jsim, JCFG, ref)):
        inst = mod.make_duet_instance(cfg, mod.SimConfig(units=1, tp=1))
        inst.submit(reqs)
        inst.service_until(reqs[10].arrival)
        drained, evs = inst.drain_requests()
        assert evs == []
        out.append(([(r.rid, r.resume_len, r.preemptions, r.prefilled,
                      r.phase.name) for r in drained],
                    inst.outstanding_tokens(), inst.metrics().summary()))
    assert _json(out[0]) == _json(out[1])
    assert out[0][0] and out[0][1] == 0


@pytest.mark.parametrize("n_decode", [1, 2])
def test_disagg_sim_matches_reference(n_decode):
    mine, ref = _both(lambda: synth_trace("azure-code", 40, 3.0, seed=1))
    a = sim.DisaggSim(CFG, sim.SimConfig(units=1, tp=1, page_size=16),
                      n_decode=n_decode).run(mine)
    b = jsim.DisaggSim(JCFG, jsim.SimConfig(units=1, tp=1, page_size=16),
                       n_decode=n_decode).run(ref)
    assert _json(a.summary()) == _json(b.summary())


# ------------------------------------------------------------- ClusterSim
def _run_cluster(policy, make_trace, cfg=CFG, jcfg=JCFG, n=2, elastic=None,
                 simcfg=None, **kw):
    simcfg = dict(units=1, tp=1, **(simcfg or {}))
    mine, ref = _both(make_trace)
    a = sim.ClusterSim(
        lambda i: sim.make_duet_instance(cfg, sim.SimConfig(**simcfg),
                                         **kw),
        n=n, policy=policy,
        elastic=None if elastic is None else router.ElasticConfig(**elastic))
    b = jsim.ClusterSim(
        lambda i: jsim.make_duet_instance(jcfg, jsim.SimConfig(**simcfg),
                                          **kw),
        n=n, policy=policy,
        elastic=None if elastic is None else jrouter.ElasticConfig(
            **elastic))
    ma, mb = a.run(mine), b.run(ref)
    assert _json(ma.summary()) == _json(mb.summary())
    assert _events(a.decisions) == _events(b.decisions)
    assert _events(a.scale_events) == _events(b.scale_events)
    return a, ma


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("policy", router.ROUTER_POLICIES)
def test_cluster_sim_matches_reference(policy, n):
    _, m = _run_cluster(policy, _azure(60, qps=12.0), n=n)
    assert m.summary()["num_finished"] == 60


@pytest.mark.parametrize("policy", router.ROUTER_POLICIES)
def test_cluster_sim_pair_trace_matches_reference(policy):
    """The pair trace on the reduced config: prefix affinity reunites
    each pair on its warm replica; round-robin splits them."""
    cfg, jcfg = reduced(get_config("qwen3-4b")), jreduced(
        jget_config("qwen3-4b"))
    c, m = _run_cluster(policy, lambda: pair_trace(cfg.vocab_size), cfg=cfg,
                        jcfg=jcfg, simcfg=REDUCED_SIM, token_budget=64)
    assert m.summary()["num_finished"] == 2 * GROUPS
    replicas = [d.replica for d in c.decisions]
    if policy == "round-robin":
        assert replicas == [i % 2 for i in range(2 * GROUPS)]
    if policy == "prefix":
        matched = [d.matched_tokens for d in c.decisions]
        assert matched[0::2] == [0] * GROUPS
        assert all(x >= SHARED for x in matched[1::2])
        assert replicas[0::2] == replicas[1::2]


def test_cluster_sim_pinned_elastic_sequence_matches_reference():
    """The reference's calibrated mmpp geometry (``test_elastic.py``):
    up in each burst, down in each lull, replica 1 the elastic one."""
    def trace():
        return make_load("azure-conv", process="mmpp", qps=2.19,
                         burst_factor=6.0, mean_burst_s=20.0,
                         mean_calm_s=40.0, seed=0).generate(60)
    ref_trace = jmake_load("azure-conv", process="mmpp", qps=2.19,
                           burst_factor=6.0, mean_burst_s=20.0,
                           mean_calm_s=40.0, seed=0).generate(60)
    assert [(r.arrival, r.prompt_len) for r in trace()] == \
        [(r.arrival, r.prompt_len) for r in ref_trace]
    c, m = _run_cluster(
        "least-loaded", trace, token_budget=8192,
        elastic=dict(min_replicas=1, max_replicas=2, scale_up_tokens=600,
                     scale_down_tokens=250, cooldown_s=5.0,
                     check_interval=1.0))
    assert [(e.action, e.replica) for e in c.scale_events] == \
        [("up", 1), ("down", 1), ("up", 1), ("down", 1)]
    assert m.summary()["num_finished"] == 60
    assert sorted(r.rid for r in m.requests) == list(range(60))


def test_cluster_sim_least_loaded_rebalances_skewed_trace():
    """The reference's skewed burst (``test_router.py``): alternating heavy
    and light arrivals; least-loaded spreads the work, round-robin piles
    the heavy requests onto replica 0."""
    cfg, jcfg = reduced(get_config("qwen3-4b")), jreduced(
        jget_config("qwen3-4b"))

    def trace():
        return [Request(rid=i, arrival=0.001 * i,
                        prompt_len=2000 if i % 2 == 0 else 100,
                        output_len=8) for i in range(8)]
    work = {r.rid: r.prompt_len + r.output_len for r in trace()}
    spreads = {}
    for policy in ("round-robin", "least-loaded"):
        c, _ = _run_cluster(policy, trace, cfg=cfg, jcfg=jcfg,
                            simcfg=REDUCED_SIM)
        per = [0, 0]
        for d in c.decisions:
            per[d.replica] += work[d.rid]
        spreads[policy] = abs(per[0] - per[1])
    assert spreads["least-loaded"] < spreads["round-robin"]


# -------------------------------------------------- policy decision tables
ECFG = dict(min_replicas=1, max_replicas=2, scale_up_tokens=100,
            scale_down_tokens=20, cooldown_s=0.05, check_interval=0.05)
# (config overrides, [(outstanding, active, t, expected decision), ...]):
# the reference's ElasticPolicy pins, in order on one policy object
ELASTIC_TABLE = {
    "up_lowest_inactive": (dict(max_replicas=4), [
        ([150, 0, 0, 0], [0], 0.0, ("up", 1)),
        ([150, 80, 0, 0], [0, 1], 1.0, ("up", 2))]),
    "none_at_max": ({}, [
        ([500, 0], [0], 0.0, ("up", 1)),
        ([500, 500], [0, 1], 10.0, None)]),
    "down_least_loaded": (dict(max_replicas=3), [
        ([10, 5, 2], [0, 1, 2], 0.0, ("down", 2))]),
    "down_tie_on_index": (dict(max_replicas=3), [
        ([0, 7, 7], [0, 1, 2], 0.0, ("down", 1))]),
    "replica_zero_kept": ({}, [([2, 10], [0, 1], 0.0, ("down", 1))]),
    "lone_replica_zero": ({}, [([0, 0], [0], 0.0, None)]),
    "hysteresis_low": ({}, [([60, 0], [0], 0.0, None)]),
    "hysteresis_high": ({}, [([15, 35], [0, 1], 0.0, None)]),
    "cooldown": (dict(cooldown_s=0.2), [
        ([500, 0], [0], 0.0, ("up", 1)),
        ([0, 0], [0, 1], 0.1, None),
        ([0, 0], [0, 1], 0.3, ("down", 1))]),
}


@pytest.mark.parametrize("case", list(ELASTIC_TABLE))
def test_elastic_policy_decision_table(case):
    kw, steps = ELASTIC_TABLE[case]
    mine = router.ElasticPolicy(router.ElasticConfig(**{**ECFG, **kw}))
    ref = jrouter.ElasticPolicy(jrouter.ElasticConfig(**{**ECFG, **kw}))
    for outstanding, active, t, want in steps:
        got = mine.decide(outstanding, active, t)
        assert got == ref.decide(outstanding, active, t) == want


@pytest.mark.parametrize("kw", [
    dict(min_replicas=3, max_replicas=2), dict(min_replicas=0),
    dict(check_interval=0.0)])
def test_elastic_config_validation(kw):
    for mod in (router, jrouter):
        with pytest.raises(ValueError):
            mod.ElasticConfig(**kw)


class _StubView:
    page_size = 16

    def __init__(self, outstanding=0, matched=0):
        self._o, self._m = outstanding, matched

    def outstanding_tokens(self):
        return self._o

    def match_keys(self, keys):
        return self._m


# (policy, [(views as (outstanding, matched), token ids?, expected,
# record the choice?)]) — the reference's dispatch pins, in order
DISPATCH_TABLE = {
    "least-loaded": [([(100, 0), (10, 0), (10, 0)], False, (1, 0), True),
                     ([(100, 0), (10, 0), (10, 0)], False, (2, 0), True),
                     ([(5, 0), (5, 0), (5, 0)], False, (0, 0), False)],
    "prefix": [([(0, 32), (50, 64), (5, 64)], True, (2, 64), False),
               ([(9, 0), (3, 0)], True, (1, 0), False),
               ([(9, 0), (3, 0)], False, (1, 0), False)],
    "round-robin": [([(0, 0), (0, 0)], True, (0, 0), True),
                    ([(0, 0), (9, 64)], True, (1, 0), True),
                    ([(0, 0), (0, 0), (0, 0)], False, (2, 0), True)],
}


@pytest.mark.parametrize("policy", list(DISPATCH_TABLE))
def test_dispatch_policy_decision_table(policy):
    mine, ref = (router.make_dispatch_policy(policy),
                 jrouter.make_dispatch_policy(policy))
    assert mine.name == ref.name == policy
    ids = np.arange(64)
    for views, with_ids, want, record in DISPATCH_TABLE[policy]:
        views = [_StubView(*v) for v in views]
        toks = ids if with_ids else None
        got = mine.choose(views, toks)
        assert got == ref.choose(views, toks) == want
        if record:
            mine.record(got[0])
            ref.record(got[0])


def test_unknown_policy_raises():
    assert router.ROUTER_POLICIES == jrouter.ROUTER_POLICIES
    with pytest.raises(ValueError, match="unknown router policy"):
        router.make_dispatch_policy("random")
