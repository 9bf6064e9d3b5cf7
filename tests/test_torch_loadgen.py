"""Port parity for the stochastic load generator: the port's
``repro_torch.serving.loadgen`` against the reference's
``repro.serving.loadgen`` on the same specs.

Both are host numpy code making the same RNG calls in the same order, so
the traces are equal field by field (and so byte-identical under
``trace_fingerprint``), and the roofline cost estimate is equal to the
last bits (1e-12 relative). The reference's own contracts
(``tests/test_loadgen.py``) run against the port as cheap cases.
"""
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.serving import loadgen as jloadgen
from repro_torch.configs import get_config
from repro_torch.serving import loadgen
from repro_torch.serving.loadgen import (ARRIVAL_PROCESSES, SERVICE_MIXES,
                                         ArrivalSpec, LoadGenerator,
                                         LoadSpec, ServiceSpec, make_load,
                                         qps_for_rho, request_cost,
                                         trace_fingerprint)
from repro_torch.serving.traces import TRACES

COST_TOL = 1e-12


def _fields(reqs):
    return [(r.rid, r.arrival, r.prompt_len, r.output_len) for r in reqs]


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("mix", SERVICE_MIXES)
@pytest.mark.parametrize("process", ARRIVAL_PROCESSES)
def test_generate_matches_reference(process, mix, seed):
    """The same LoadSpec gives the same requests in both packages, field
    by field, and the same fingerprint (mmpp with the pinned elastic
    geometry's dwell times, so both states are visited)."""
    kw = dict(burst_factor=6.0, mean_burst_s=20.0, mean_calm_s=40.0) \
        if process == "mmpp" else {}
    mine = make_load("azure-code", process=process, mix=mix, qps=2.19,
                     seed=seed, **kw).generate(300, rid_base=5)
    ref = jloadgen.make_load("azure-code", process=process, mix=mix,
                             qps=2.19, seed=seed, **kw).generate(
                                 300, rid_base=5)
    assert _fields(mine) == _fields(ref)
    assert trace_fingerprint(mine) == jloadgen.trace_fingerprint(ref)
    assert all(isinstance(r.prompt_len, int) for r in mine)


def test_specs_match_reference():
    """Rates, base scale and the spec defaults equal the reference's."""
    a = ArrivalSpec(process="mmpp", qps=6.0, burst_factor=4.0)
    ja = jloadgen.ArrivalSpec(process="mmpp", qps=6.0, burst_factor=4.0)
    assert a.rates() == ja.rates()
    s = ServiceSpec(trace=TRACES["azure-conv"], mix="mixture", p_heavy=0.2)
    js = jloadgen.ServiceSpec(trace=jloadgen.TRACES["azure-conv"],
                              mix="mixture", p_heavy=0.2)
    assert s.base_scale() == js.base_scale()
    assert (ARRIVAL_PROCESSES, SERVICE_MIXES) == (
        jloadgen.ARRIVAL_PROCESSES, jloadgen.SERVICE_MIXES)
    gen = LoadGenerator(LoadSpec(seed=3))
    jgen = jloadgen.LoadGenerator(jloadgen.LoadSpec(seed=3))
    np.testing.assert_array_equal(gen.arrivals(50), jgen.arrivals(50))


@pytest.mark.parametrize("name,kw", [
    ("qwen3-4b", {}),
    ("qwen3-4b", dict(units=8, tp=8)),
    ("qwen3-4b", dict(token_budget=64, decode_batch=4, page_size=16)),
    ("deepseek-v2-lite-16b", {}),
    ("zamba2-1.2b", dict(units=2, tp=2)),
])
@pytest.mark.parametrize("mix", SERVICE_MIXES)
def test_request_cost_and_qps_match_reference(name, kw, mix):
    cost = request_cost(get_config(name),
                        ServiceSpec(trace=TRACES["azure-conv"], mix=mix),
                        **kw)
    jcost = jloadgen.request_cost(
        jget_config(name),
        jloadgen.ServiceSpec(trace=jloadgen.TRACES["azure-conv"], mix=mix),
        **kw)
    assert cost == pytest.approx(jcost, rel=COST_TOL, abs=0)
    for rho, k in ((0.5, 1), (0.8, 2), (1.2, 4)):
        assert qps_for_rho(rho, cost, replicas=k) == pytest.approx(
            jloadgen.qps_for_rho(rho, jcost, replicas=k), rel=COST_TOL,
            abs=0)


# ------------------------------------------ the reference's own contracts
@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("process", ARRIVAL_PROCESSES)
def test_arrivals_strictly_increasing(process, seed):
    arr = make_load("azure-conv", process=process, qps=20.0,
                    seed=seed).arrivals(500)
    gaps = np.diff(np.concatenate([[0.0], arr]))
    assert (gaps > 0).all() and (arr > 0).all()


def test_substreams_isolate_axes():
    """Changing only the arrival process leaves the length draw as it
    was; a different seed gives a different trace."""
    pois = make_load("azure-conv", seed=3).generate(200)
    mmpp = make_load("azure-conv", seed=3, process="mmpp").generate(200)
    assert [r.prompt_len for r in pois] == [r.prompt_len for r in mmpp]
    assert [r.output_len for r in pois] == [r.output_len for r in mmpp]
    assert [r.arrival for r in pois] != [r.arrival for r in mmpp]
    fps = {trace_fingerprint(make_load("azure-conv", seed=s).generate(50))
           for s in range(4)}
    assert len(fps) == 4


def test_mmpp_burstier_at_the_same_rate():
    pois = make_load("azure-conv", qps=8.0, seed=1).arrivals(20_000)
    mmpp = make_load("azure-conv", qps=8.0, process="mmpp",
                     seed=1).arrivals(20_000)
    assert mmpp[-1] / len(mmpp) == pytest.approx(1 / 8.0, rel=0.15)
    _, cv_p = loadgen._mean_gap_cv(pois)
    _, cv_m = loadgen._mean_gap_cv(mmpp)
    assert cv_p == pytest.approx(1.0, abs=0.05)
    assert cv_m > cv_p + 0.1


def test_mixture_keeps_means_and_clips():
    trace = TRACES["azure-conv"]
    isl, osl = make_load("azure-conv", mix="mixture", seed=0).lengths(20_000)
    assert isl.mean() == pytest.approx(trace.mean_isl, rel=0.1)
    assert osl.mean() == pytest.approx(trace.mean_osl, rel=0.1)
    reqs = make_load("azure-conv", mix="mixture", heavy_mult=64.0,
                     p_heavy=0.3, seed=0).generate(2_000)
    assert all(8 <= r.prompt_len <= trace.max_isl for r in reqs)
    assert all(1 <= r.output_len <= trace.max_osl for r in reqs)


def test_rho_targeting_is_the_mgk_identity():
    assert qps_for_rho(0.5, 2.0) == pytest.approx(0.25)
    assert qps_for_rho(0.5, 2.0, replicas=4) == pytest.approx(1.0)
    cfg = get_config("qwen3-4b")
    c1 = request_cost(cfg, ServiceSpec(trace=TRACES["azure-conv"]))
    c8 = request_cost(cfg, ServiceSpec(trace=TRACES["azure-conv"]), units=8,
                      tp=8)
    assert 0 < c8 < c1
    arr = make_load("azure-conv", rho=0.8, cost_s=c8, seed=0).arrivals(
        20_000)
    assert len(arr) / arr[-1] == pytest.approx(0.8 / c8, rel=0.05)


@pytest.mark.parametrize("make,err", [
    (lambda: ArrivalSpec(process="uniform"), ValueError),
    (lambda: ArrivalSpec(qps=0.0), ValueError),
    (lambda: ArrivalSpec(process="mmpp", burst_factor=0.5), ValueError),
    (lambda: ServiceSpec(mix="pareto"), ValueError),
    (lambda: ServiceSpec(mix="mixture", p_heavy=1.0), ValueError),
    (lambda: ServiceSpec(mix="mixture", heavy_mult=0.5), ValueError),
    (lambda: make_load("azure-conv", bogus_knob=1), TypeError),
    (lambda: make_load("azure-conv", rho=0.5), ValueError),
    (lambda: qps_for_rho(0.0, 1.0), ValueError),
    (lambda: qps_for_rho(0.5, 0.0), ValueError),
])
def test_spec_validation(make, err):
    with pytest.raises(err):
        make()
