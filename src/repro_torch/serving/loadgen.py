"""Open-loop stochastic load generation (M/G/k-style heavy-traffic harness).

A host-only copy of the reference's ``repro.serving.loadgen``: the same
numpy draws in the same order, so one seed gives a byte-identical trace in
both packages (``tests/test_torch_loadgen.py`` pins it).

``synth_trace`` replays one fixed Poisson/lognormal draw; production load is
a stochastic *process* whose tail behaviour (p99/p999 TTFT/TBT at high
utilisation) is where DuetServe's adaptive multiplexing earns its keep. This
module layers controllable arrival processes and service mixes on the
existing :class:`~repro_torch.serving.traces.TraceSpec` statistics:

Arrivals (open loop — the generator never waits for completions):

* ``poisson`` — memoryless rate-``qps`` arrivals, the classic baseline.
* ``mmpp``    — a 2-state Markov-modulated Poisson process: exponential
  dwell times alternate between a *calm* and a *burst* state whose rate is
  ``burst_factor`` times calm. The calm rate is normalised so the
  time-average rate stays exactly ``qps`` — an MMPP sweep and a Poisson
  sweep at the same ρ differ only in burstiness (gap CV > 1).

Service mixes (lengths layered on a ``TraceSpec``):

* ``lognormal`` — the trace's own clipped-lognormal ISL/OSL marginals.
* ``mixture``   — a two-point heavy-tail mixture: with probability
  ``p_heavy`` a request's lengths are drawn at ``heavy_mult`` × a reduced
  base mean, the base mean scaled by ``1/(1 + p_heavy·(heavy_mult-1))`` so
  the *overall* means stay pinned to the spec (the ρ target survives).

ρ targeting (SNIPPETS M/G/k idiom: ``λ = ρ·k / E[S]``): the per-request
service-time estimate comes from the same attention-aware roofline the
engines schedule with — chunked prefill of the mean ISL plus the mean OSL's
share of batched decode iterations — so a sweep prescribes offered load as a
fraction of modeled capacity instead of a raw QPS guess.

Everything is seeded through independent ``SeedSequence`` substreams:
identical :class:`LoadSpec` ⇒ byte-identical request list, and the arrival
process can change without perturbing the length draws.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.roofline import (HardwareSpec, RooflineModel,
                                       TPU_V5E)
from repro_torch.serving.request import Request
from repro_torch.serving.traces import TraceSpec, TRACES, _lognormal

ARRIVAL_PROCESSES = ("poisson", "mmpp")
SERVICE_MIXES = ("lognormal", "mixture")


@dataclass(frozen=True)
class ArrivalSpec:
    """Open-loop arrival process parameters.

    ``qps`` is always the *time-average* rate: for ``mmpp`` the calm-state
    rate is solved from ``burst_factor`` and the mean dwell times so the
    long-run average matches, keeping ρ comparisons across processes fair.
    """
    process: str = "poisson"
    qps: float = 4.0
    # mmpp only: burst-state rate multiplier and mean state dwell times (s)
    burst_factor: float = 4.0
    mean_burst_s: float = 2.0
    mean_calm_s: float = 8.0

    def __post_init__(self):
        if self.process not in ARRIVAL_PROCESSES:
            raise ValueError(f"unknown arrival process {self.process!r}; "
                             f"choose from {ARRIVAL_PROCESSES}")
        if self.qps <= 0:
            raise ValueError(f"qps must be > 0, got {self.qps}")
        if self.process == "mmpp" and self.burst_factor < 1.0:
            raise ValueError("burst_factor must be >= 1 (burst state is "
                             "the fast one)")

    def rates(self) -> Tuple[float, float]:
        """(calm_rate, burst_rate) with the time-average pinned to qps."""
        if self.process != "mmpp":
            return self.qps, self.qps
        tc, tb, f = self.mean_calm_s, self.mean_burst_s, self.burst_factor
        calm = self.qps * (tc + tb) / (tc + f * tb)
        return calm, f * calm


@dataclass(frozen=True)
class ServiceSpec:
    """Service (length) mix layered on a :class:`TraceSpec`."""
    trace: TraceSpec = field(
        default_factory=lambda: TRACES["azure-conv"])
    mix: str = "lognormal"
    # mixture only: heavy-class probability and length multiplier
    p_heavy: float = 0.1
    heavy_mult: float = 4.0

    def __post_init__(self):
        if self.mix not in SERVICE_MIXES:
            raise ValueError(f"unknown service mix {self.mix!r}; choose "
                             f"from {SERVICE_MIXES}")
        if not 0.0 <= self.p_heavy < 1.0:
            raise ValueError(f"p_heavy must be in [0, 1), got {self.p_heavy}")
        if self.heavy_mult < 1.0:
            raise ValueError("heavy_mult must be >= 1")

    def base_scale(self) -> float:
        """Mean-preserving shrink of the base class under the mixture:
        ``E[len] = scale·mean·(1-p) + scale·mean·mult·p = mean``."""
        if self.mix != "mixture":
            return 1.0
        return 1.0 / (1.0 + self.p_heavy * (self.heavy_mult - 1.0))


@dataclass(frozen=True)
class LoadSpec:
    arrival: ArrivalSpec = field(default_factory=ArrivalSpec)
    service: ServiceSpec = field(default_factory=ServiceSpec)
    seed: int = 0


class LoadGenerator:
    """Seeded, reproducible open-loop request stream.

    Substreams (``SeedSequence.spawn``) keep arrivals, lengths and the
    mixture class independent: regenerating with a different arrival
    process leaves the service draw untouched, so A/B sweeps isolate one
    axis at a time.
    """

    def __init__(self, spec: LoadSpec):
        self.spec = spec
        arr_ss, len_ss, mix_ss = np.random.SeedSequence(spec.seed).spawn(3)
        self._arr_rng = np.random.default_rng(arr_ss)
        self._len_rng = np.random.default_rng(len_ss)
        self._mix_rng = np.random.default_rng(mix_ss)

    # ------------------------------------------------------------ arrivals
    def arrivals(self, n: int) -> np.ndarray:
        a = self.spec.arrival
        if a.process == "poisson":
            gaps = self._arr_rng.exponential(1.0 / a.qps, n)
            return np.cumsum(gaps)
        return self._mmpp_arrivals(n)

    def _mmpp_arrivals(self, n: int) -> np.ndarray:
        """Exact 2-state MMPP simulation. Both the arrival stream and the
        state dwell are memoryless, so a candidate gap that overruns the
        current state's dwell is discarded and resampled from the state
        boundary at the new state's rate — no thinning bias."""
        a = self.spec.arrival
        rng = self._arr_rng
        rates = a.rates()                      # (calm, burst)
        dwell_means = (a.mean_calm_s, a.mean_burst_s)
        out = np.empty(n)
        t, state = 0.0, 0                      # start calm
        state_end = t + rng.exponential(dwell_means[state])
        for i in range(n):
            while True:
                cand = t + rng.exponential(1.0 / rates[state])
                if cand <= state_end:
                    t = cand
                    break
                t = state_end                  # jump to the state switch
                state = 1 - state
                state_end = t + rng.exponential(dwell_means[state])
            out[i] = t
        return out

    # ------------------------------------------------------------- lengths
    def lengths(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        s = self.spec.service
        spec = s.trace
        scale = s.base_scale()
        isl = _lognormal(self._len_rng, spec.mean_isl * scale,
                         spec.cv_isl, n)
        osl = _lognormal(self._len_rng, spec.mean_osl * scale,
                         spec.cv_osl, n)
        if s.mix == "mixture":
            heavy = self._mix_rng.random(n) < s.p_heavy
            isl = np.where(heavy, isl * s.heavy_mult, isl)
            osl = np.where(heavy, osl * s.heavy_mult, osl)
        isl = np.clip(isl, 8, spec.max_isl).astype(int)
        osl = np.clip(osl, 1, spec.max_osl).astype(int)
        return isl, osl

    # ------------------------------------------------------------ requests
    def generate(self, n: int, rid_base: int = 0) -> List[Request]:
        arrivals = self.arrivals(n)
        isl, osl = self.lengths(n)
        return [Request(rid=rid_base + i, arrival=float(arrivals[i]),
                        prompt_len=int(isl[i]), output_len=int(osl[i]))
                for i in range(n)]


# ------------------------------------------------------------- ρ targeting
def request_cost(cfg: ArchConfig, service: ServiceSpec,
                 hw: HardwareSpec = TPU_V5E, *,
                 units: int = 1, tp: int = 1,
                 token_budget: int = 256,
                 decode_batch: int = 8,
                 page_size: int = 1) -> float:
    """Roofline estimate of one mean request's service time E[S] (seconds).

    Chunked prefill of the mean ISL at the engine's token budget, plus the
    mean OSL's *per-request share* of batched decode iterations at the
    request's mid-generation context — the same latency oracle the engines
    and simulator advance their virtual clock with, so ``ρ = λ·E[S]/k`` is
    utilisation against modeled capacity, not a guess.
    """
    spec = service.trace
    model = RooflineModel(cfg, hw, tp=tp, page_size=page_size)
    t = model.prefill_latency(spec.mean_isl, chunk=token_budget, units=units)
    ctx = spec.mean_isl + spec.mean_osl // 2
    t += spec.mean_osl * model.decode_latency(decode_batch, ctx,
                                              units=units) / decode_batch
    return t


def qps_for_rho(rho: float, cost_s: float, replicas: int = 1) -> float:
    """Arrival rate hitting target utilisation ρ on ``replicas`` servers
    (M/G/k: ``λ = ρ·k / E[S]``)."""
    if rho <= 0:
        raise ValueError(f"rho must be > 0, got {rho}")
    if cost_s <= 0:
        raise ValueError(f"cost_s must be > 0, got {cost_s}")
    return rho * replicas / cost_s


def make_load(trace: str = "azure-conv", *, process: str = "poisson",
              mix: str = "lognormal", qps: Optional[float] = None,
              rho: Optional[float] = None,
              cost_s: Optional[float] = None, replicas: int = 1,
              seed: int = 0, **kw) -> LoadGenerator:
    """Convenience constructor: name a trace, pick a process/mix, give either a
    raw ``qps`` or a ``(rho, cost_s)`` target."""
    if rho is not None:
        if cost_s is None:
            raise ValueError("rho targeting needs cost_s (request_cost)")
        qps = qps_for_rho(rho, cost_s, replicas)
    if qps is None:
        qps = 4.0
    arr_kw = {k: kw.pop(k) for k in ("burst_factor", "mean_burst_s",
                                     "mean_calm_s") if k in kw}
    svc_kw = {k: kw.pop(k) for k in ("p_heavy", "heavy_mult") if k in kw}
    if kw:
        raise TypeError(f"unknown load parameters: {sorted(kw)}")
    return LoadGenerator(LoadSpec(
        arrival=ArrivalSpec(process=process, qps=qps, **arr_kw),
        service=ServiceSpec(trace=TRACES[trace], mix=mix, **svc_kw),
        seed=seed))


def trace_fingerprint(reqs: List[Request]) -> str:
    """Canonical byte-stable digest of a generated trace (determinism
    pins): arrival microseconds + lengths, order-sensitive."""
    import hashlib
    h = hashlib.sha256()
    for r in reqs:
        h.update(f"{r.rid},{r.arrival:.9f},{r.prompt_len},"
                 f"{r.output_len};".encode())
    return h.hexdigest()


def _mean_gap_cv(arrivals: np.ndarray) -> Tuple[float, float]:
    """(mean, CV) of inter-arrival gaps — burstiness probe used by tests
    and the sweep's sanity logging."""
    gaps = np.diff(np.concatenate([[0.0], arrivals]))
    m = float(gaps.mean())
    return m, float(gaps.std() / max(m, 1e-12))
