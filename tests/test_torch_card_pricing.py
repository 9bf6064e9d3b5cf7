"""The card priced as itself: ``roofline.card_spec``, the engines' pricing
by the device they run on, and the partition curves' host side.

(a) The port's roofline, Algorithm 1 (``decide``) and multiplexer at the
card's units (``H100_LIKE``'s 66 TPCs) with a non-linear measured-like
B(S) table, against the reference's on the same inputs. (b)
``card_spec`` from a stand-in of ``torch.cuda.get_device_properties``.
(c) The engines: the CPU's default stays the reference's TPU v5e; given
the card's spec with a table (``TabulatedPartitionCurves``, as
``device_pricing`` builds it on the card), reduced qwen3-4b plans over 66
TPCs, takes duet iterations at a TBT bound between its predicted decode
and mixed times, and serves the JAX ``Model.forward`` greedy oracle's
tokens; the serve CLI's ``--rho`` load is priced as the engines plan. (d)
What measures the curve on the card refuses the CPU: ``partition_curves``
raises, the probe's wrapper runs its plain version on a CPU tensor and
refuses any other non-CUDA one."""
import types

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.multiplexer import AdaptiveMultiplexer as JMux
from repro.core.multiplexer import TabulatedPartitionCurves as JCurves
from repro.core.partition import decide as jdecide
from repro.core.roofline import H100_LIKE as JH100
from repro.core.roofline import RequestLoad as JLoad
from repro.core.roofline import RooflineModel as JRoofline
from repro_torch.configs import get_config
from repro_torch.core.device import partition_curves
from repro_torch.core.multiplexer import (AdaptiveMultiplexer,
                                          TabulatedPartitionCurves)
from repro_torch.core.partition import decide
from repro_torch.core.roofline import (CARD_DATASHEET, H100_LIKE, TPU_V5E,
                                       RequestLoad, RooflineModel,
                                       card_spec)
from repro_torch.kernels.sm_probe import (MAX_VALUE, THREADS, VEC,
                                          sm_probe, sm_probe_plain)
from repro_torch.serving import AsyncDuetEngine, DuetEngine, EngineConfig
from repro_torch.serving.engine import device_pricing
from test_torch_engine import KW, SPECS, greedy_oracle

H100 = types.SimpleNamespace(name="NVIDIA H100 80GB HBM3",
                             multi_processor_count=132)
UNITS = 66
# a measured-like B(S): superlinear in SMs, saturating near the card's
# rate (bytes/s at u TPCs)
BW = {u: 3.35e12 * (1.0 - np.exp(-u / 9.0)) for u in range(1, UNITS + 1)}
PI = {u: H100_LIKE.pi(u) for u in range(1, UNITS + 1)}
# what device_pricing gives an engine on the card: card_spec's spec, Pi
# linear in SMs, B(S) measured (here the table above)
CARD = TabulatedPartitionCurves(
    card_spec(H100), {u: card_spec(H100).pi(u) for u in BW}, BW)
PRICED = ("qwen3-4b", "granite-moe-3b-a800m", "deepseek-v2-lite-16b",
          "zamba2-1.2b")
# decode batches x contexts x prefill chunks (chunk at a context of its own)
GRID = [(b, c, q) for b in (1, 32) for c in (128, 4000)
        for q in (64, 1024)]
REL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread (the engine test files' fixture): the reduced
    model's ops are tiny, and the suite's parallel workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loads(b, c, q, load=RequestLoad):
    return ([load(q=q, c=c // 2, phase="prefill")],
            [load(q=1, c=c) for _ in range(b)])


def _close(a, b):
    assert a == pytest.approx(b, rel=REL, abs=0.0)


def _same_decision(got, want):
    assert got.mode == want.mode
    _close(got.t_mixed, want.t_mixed)
    if want.partition is None:
        assert got.partition is None
        return
    g, w = got.partition, want.partition
    assert (g.s_prefill, g.s_decode, g.k) == (w.s_prefill, w.s_decode, w.k)
    for f in ("t_prefill", "t_decode", "throughput"):
        _close(getattr(g, f), getattr(w, f))


@pytest.mark.parametrize("part", ["roofline", "decide", "multiplexer"])
@pytest.mark.parametrize("arch", PRICED)
def test_card_units_match_reference(arch, part):
    """(a) At 66 units with the non-linear table: every latency within
    1e-12 relative, and every decision's mode, S_p, S_d and k equal."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    model = RooflineModel(cfg, TabulatedPartitionCurves(H100_LIKE, PI, BW),
                          page_size=16)
    jmodel = JRoofline(jcfg, JCurves(JH100, PI, BW), page_size=16)
    modes = set()
    for b, c, q in GRID:
        pre, dec = _loads(b, c, q)
        jpre, jdec = _loads(b, c, q, JLoad)
        if part == "roofline":
            for units in (1, 7, 12.5, 33, UNITS):
                _close(model.iteration_latency(pre + dec, units),
                       jmodel.iteration_latency(jpre + jdec, units))
            continue
        t_mixed = model.iteration_latency(pre + dec, UNITS)
        for f in (0.5, 0.97, 1.1):
            slo = f * t_mixed
            if part == "decide":
                got = decide(model, pre, dec, UNITS, slo)
                want = jdecide(jmodel, jpre, jdec, UNITS, slo)
            else:
                mux = AdaptiveMultiplexer(cfg, hw=H100_LIKE,
                                          total_units=UNITS, tbt_slo=slo,
                                          page_size=16, bw_table=BW)
                jmux = JMux(jcfg, hw=JH100, total_units=UNITS, tbt_slo=slo,
                            page_size=16, bw_table=BW)
                got, want = mux.step(pre, dec), jmux.step(jpre, jdec)
                _close(mux.predict_mixed(pre + dec),
                       jmux.predict_mixed(jpre + jdec))
                assert vars(mux.stats) == vars(jmux.stats)
            _same_decision(got, want)
            modes.add(got.mode)
    if part != "roofline":
        assert modes == {"duet", "aggregated"}


@pytest.mark.parametrize("name,sms", [("NVIDIA H100 80GB HBM3", 132)])
def test_card_spec_from_device_properties(name, sms):
    """(b) TPCs = SMs / 2; the datasheet's peak and HBM rate spread over
    them; NVLink terms as H100_LIKE's."""
    spec = card_spec(types.SimpleNamespace(name=name,
                                           multi_processor_count=sms))
    flops, hbm = CARD_DATASHEET[name]
    assert (spec.name, spec.num_units, spec.units_per_device) == \
        (name, sms // 2, sms // 2)
    assert (flops, hbm) == (989.4e12, 3.35e12)
    _close(spec.pi(spec.num_units), flops)
    _close(spec.bw(spec.num_units), hbm)
    assert (spec.ici_bw, spec.ici_links, spec.alpha) == \
        (H100_LIKE.ici_bw, H100_LIKE.ici_links, H100_LIKE.alpha)
    # the reference's specs stay as they are
    assert H100_LIKE.units_per_device == TPU_V5E.units_per_device == 1


@pytest.mark.parametrize("name", ["NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB",
                                  "h100_like", ""])
def test_card_spec_refuses_an_unknown_card(name):
    with pytest.raises(ValueError, match="no datasheet values"):
        card_spec(types.SimpleNamespace(name=name, multi_processor_count=132))


@pytest.mark.parametrize("cls", [DuetEngine, AsyncDuetEngine])
def test_cpu_engines_price_the_reference_tpu(cls):
    """(c) hw=None on the CPU: TPU v5e at one unit, as before, and what
    device_pricing gives the CPU."""
    from repro_torch.configs import reduced
    from repro_torch.models import Model
    model = Model.init(reduced(get_config("qwen3-4b")), device="cpu")
    eng = cls(model, EngineConfig(**KW), device="cpu")
    assert eng.mux.hw is TPU_V5E and eng.hw is TPU_V5E
    assert eng.mux.total_units == 1
    assert device_pricing(torch.device("cpu"), model.ctx) is TPU_V5E


@pytest.fixture(scope="module")
def priced():
    """Reduced qwen3-4b (fp32, the JAX weights), the card's spec, the
    JAX greedy oracle on the engine tests' trace, and a TBT bound midway
    between the card's predicted decode time (the trace's full decode
    batch) and mixed time (that batch and a chunk of the rest of the
    token budget)."""
    import jax
    from repro.configs import reduced as jreduced
    from repro.models import Model as JModel
    from repro_torch.configs import reduced
    from repro_torch.models import Model, params_from_jax
    jcfg = jreduced(jget_config("qwen3-4b"))
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = reduced(get_config("qwen3-4b"))
    tmodel = Model(tcfg, params_from_jax(
        tcfg, jax.tree.map(np.asarray, jparams)), attn_kernel=True)
    forward = jax.jit(lambda toks: jmodel.forward(jparams, toks))
    oracle = greedy_oracle(forward, tcfg.vocab_size, SPECS)
    mux = DuetEngine(tmodel, EngineConfig(**KW), hw=CARD, device="cpu").mux
    B = KW["max_slots"]
    dec = [RequestLoad(q=1, c=40) for _ in range(B)]
    chunk = [RequestLoad(q=KW["token_budget"] - B, c=0, phase="prefill")]
    t_dec, t_mix = mux.predict_mixed(dec), mux.predict_mixed(dec + chunk)
    assert t_dec < t_mix
    return tmodel, oracle, (t_dec + t_mix) / 2


@pytest.mark.parametrize("slo", ["between", "default"])
def test_card_priced_engines_serve_the_oracle(priced, slo):
    """(c) Given the card's spec with a table, both engines plan over 66
    TPCs with that table; between the predicted decode and mixed times
    Algorithm 1 takes duet iterations whose S_p and S_d are TPCs, at 0.1 s
    none; both engines serve the greedy oracle's tokens, and their
    ServingMetrics are equal."""
    tmodel, oracle, between = priced
    tbt = between if slo == "between" else EngineConfig().tbt_slo
    kw = dict(KW, tbt_slo=tbt)
    runs = {}
    for cls in (DuetEngine, AsyncDuetEngine):
        parts = []
        eng = cls(tmodel, EngineConfig(**kw), hw=CARD, device="cpu")
        assert eng.mux.hw is CARD and eng.mux.total_units == UNITS
        assert eng.mux.bw_table == BW
        assert eng.mux.pi_table == {u: card_spec(H100).pi(u) for u in BW}
        step = eng.mux.step

        def record(pre, dec, step=step):
            decision = step(pre, dec)
            if decision.mode == "duet":
                p = decision.partition
                parts.append((p.s_prefill, p.s_decode, p.k))
            return decision
        eng.mux.step = record
        eng.submit(_workload())
        metrics = eng.run()
        toks = {r.rid: list(r.output_tokens) for r in metrics.requests}
        assert toks == oracle
        assert eng.mux.stats.duet_iterations == len(parts)
        if slo == "between":
            assert parts
            for s_p, s_d, k in parts:
                assert s_p + s_d == UNITS and s_p >= 1 and s_d >= 1
                assert k >= 1
        else:
            assert not parts
        runs[cls] = metrics.summary()
    assert runs[DuetEngine] == runs[AsyncDuetEngine]


def _workload():
    from repro_torch.serving import Request
    return [Request(rid=rid, arrival=a, prompt_len=p, output_len=o)
            for rid, a, p, o in SPECS]


@pytest.mark.parametrize("units,tp", [(2, 1), (1, 2)])
def test_replica_of_cards_extends_the_card_curve(units, tp):
    """A replica of several cards (``units``, or a ``tp`` what-if) plans
    over all their TPCs: one card's curve up to its TPCs, linear past
    them from the card's whole rate."""
    from repro_torch.configs import reduced
    from repro_torch.models import Model
    model = Model.init(reduced(get_config("qwen3-4b")), device="cpu")
    mux = DuetEngine(model, EngineConfig(**KW, units=units, tp=tp),
                     hw=CARD, device="cpu").mux
    n = 2 * UNITS
    assert mux.total_units == n
    assert sorted(mux.bw_table) == list(range(1, n + 1))
    assert all(mux.bw_table[u] == BW[u] for u in BW)
    _close(mux.bw_table[n], 2 * BW[UNITS])
    _close(mux.pi_table[n], card_spec(H100).pi(n))


def _rho_args(*extra):
    from repro_torch.launch.serve import build_parser
    return build_parser().parse_args(
        ["--arrival", "mmpp", "--service-mix", "mixture", "--rho", "0.8",
         "--num-requests", "8", "--device", "cpu", *extra])


@pytest.mark.parametrize("dp,tp", [(1, 1), (2, 1), (2, 2)])
def test_cli_rho_prices_the_engines_spec(dp, tp):
    """The serve CLI's ``--rho`` arrival rate on the card's spec is rho x
    k / E[S], E[S] the mean request's roofline cost under that spec over a
    replica's TPCs (tp cards of 66): the trace the CLI draws equals the
    load generator's at that rate, and it arrives faster than the TPU
    v5e's pricing would send it."""
    from repro_torch.launch.serve import _trace
    from repro_torch.serving.loadgen import (ArrivalSpec, LoadGenerator,
                                             LoadSpec, ServiceSpec,
                                             request_cost, trace_fingerprint)
    from repro_torch.serving.traces import TRACES
    cfg = get_config("qwen3-4b")
    args = _rho_args("--dp", str(dp), "--tp", str(tp))
    service = ServiceSpec(trace=TRACES[args.trace], mix=args.service_mix)
    costs = {name: request_cost(cfg, service, hw, units=tp * n, tp=tp,
                                token_budget=args.token_budget)
             for name, hw, n in (("card", CARD, UNITS), ("tpu", TPU_V5E, 1))}
    assert costs["card"] < costs["tpu"]
    for name, hw in (("card", CARD), ("tpu", TPU_V5E)):
        qps = 0.8 * dp / costs[name]
        want = LoadGenerator(LoadSpec(
            arrival=ArrivalSpec(process="mmpp", qps=qps), service=service,
            seed=args.seed)).generate(8)
        got = _trace(args, cfg, dp, hw)
        assert trace_fingerprint(got) == trace_fingerprint(want)


def test_partition_curves_refuse_the_cpu():
    """(d) The curve is measured on a card; the CPU has none to measure."""
    with pytest.raises(ValueError, match="measures a CUDA card"):
        partition_curves("cpu", card_spec(H100))


@pytest.mark.parametrize("n,ctas", [(4 * THREADS * 7, 7), (4 * 10, 3),
                                    (4 * (3 * THREADS + 5), 2)])
def test_probe_plain_version_follows_the_kernel_schedule(n, ctas):
    """(d) On a CPU tensor the probe runs its plain version: CTA b sums the
    16-byte vectors i with (i // THREADS) % ctas == b, and the CTAs' sums
    add up to torch.sum of the buffer."""
    rng = np.random.default_rng(n)
    buf = torch.from_numpy(rng.integers(0, MAX_VALUE, n).astype(np.int32))
    partial, smid = sm_probe(buf, ctas)
    assert smid is None and partial.dtype == torch.int64
    vec = buf.view(-1, VEC).sum(1, dtype=torch.int64).numpy()
    owner = (np.arange(vec.size) // THREADS) % ctas
    want = [int(vec[owner == b].sum()) for b in range(ctas)]
    assert partial.tolist() == want
    assert int(partial.sum()) == int(buf.sum())
    assert torch.equal(sm_probe_plain(buf, ctas), partial)


def test_probe_never_falls_back_off_the_cpu():
    buf = torch.empty((4 * THREADS,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="is not on"):
        sm_probe(buf, 2)
    with pytest.raises(ValueError, match="int32"):
        sm_probe(torch.zeros(8, dtype=torch.int64), 2)
