"""GPU/TPU partitioning configuration optimizer — paper §4.2, Algorithm 1.

Given a mixed batch whose predicted latency exceeds the TBT SLO, enumerate
decode partition sizes S_d (step = the hardware's smallest partition unit:
one TPC = 2 SMs on H100, one chip on a TPU pod), keep candidates whose decode
latency meets the SLO, pair each with S_p = S − S_d for prefill, choose the
look-ahead depth k ∈ {⌊t_p/t_d⌋, ⌊t_p/t_d⌋+1}, and maximise token throughput

    ρ(S_p, S_d, k) = (k·T_decode + T_prefill) / max(k·t_d(S_d), t_p(S_p)).

The optimizer naturally gives decode the minimum units that satisfy τ_TBT and
prefill the rest (the paper's observation) — the enumeration keeps it exact.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from repro_torch.core.roofline import RequestLoad, RooflineModel


@dataclass(frozen=True)
class PartitionConfig:
    s_prefill: int           # units assigned to the prefill stream
    s_decode: int            # units assigned to the decode stream
    k: int                   # decode steps overlapped with one prefill chunk
    t_prefill: float         # predicted prefill-side latency (s)
    t_decode: float          # predicted per-decode-step latency (s)
    throughput: float        # predicted tokens/s of the configuration

    @property
    def span(self) -> float:
        """Wall-clock of one duet super-iteration."""
        return max(self.k * self.t_decode, self.t_prefill)


@dataclass(frozen=True)
class ScheduleDecision:
    mode: str                            # "aggregated" | "duet"
    t_mixed: float                       # predicted aggregated latency
    partition: Optional[PartitionConfig] = None


def optimize_partition(model: RooflineModel,
                       prefill_reqs: Sequence[RequestLoad],
                       decode_reqs: Sequence[RequestLoad],
                       total_units: int,
                       tbt_slo: float,
                       *,
                       unit_step: int = 1,
                       min_decode_units: int = 1,
                       max_k: int = 64) -> Optional[PartitionConfig]:
    """Algorithm 1 lines 6–21. Returns the best feasible configuration or
    None when no S_d satisfies the TBT constraint (caller falls back to
    aggregated execution with a reduced token budget)."""
    t_decode_tokens = sum(r.q for r in decode_reqs)     # = batch size
    t_prefill_tokens = sum(r.q for r in prefill_reqs)
    best: Optional[PartitionConfig] = None

    for s_d in range(min_decode_units, total_units, unit_step):
        t_d = model.iteration_latency(decode_reqs, units=s_d)
        if t_d > tbt_slo:
            continue
        s_p = total_units - s_d
        t_p = model.iteration_latency(prefill_reqs, units=s_p)
        k_base = int(t_p / t_d) if t_d > 0 else 1
        for k in (k_base, k_base + 1):
            k = max(1, min(k, max_k))
            # §4.2: the decode stream must meet τ_TBT *across* the
            # super-iteration boundary too. Tokens inside the iteration are
            # t_d apart, but when k·t_d < t_p the last decode token waits
            # out the prefill remainder before the next iteration's first
            # step, so the worst inter-token gap is
            # t_d + max(0, t_p − k·t_d). This bites when k under-covers
            # t_p — a large remainder at k_base, or the max_k clamp.
            if t_d + max(0.0, t_p - k * t_d) > tbt_slo:
                continue
            span = max(k * t_d, t_p)
            if span <= 0:
                continue
            rho = (k * t_decode_tokens + t_prefill_tokens) / span
            if best is None or rho > best.throughput:
                best = PartitionConfig(s_prefill=s_p, s_decode=s_d, k=k,
                                       t_prefill=t_p, t_decode=t_d,
                                       throughput=rho)
    return best


def decide(model: RooflineModel,
           prefill_reqs: Sequence[RequestLoad],
           decode_reqs: Sequence[RequestLoad],
           total_units: int,
           tbt_slo: float,
           *,
           unit_step: int = 1) -> ScheduleDecision:
    """Algorithm 1 top level: predict the mixed-batch latency; stay
    aggregated when it meets the SLO, otherwise optimise a duet partition."""
    mixed = list(prefill_reqs) + list(decode_reqs)
    t_mixed = model.iteration_latency(mixed, units=total_units)
    if t_mixed <= tbt_slo or not prefill_reqs or not decode_reqs:
        return ScheduleDecision(mode="aggregated", t_mixed=t_mixed)
    # S_d at multiples of the step (the reference starts at 1 unit; the
    # same at its unit_step 1): on the card, only splits the driver can cut
    part = optimize_partition(model, prefill_reqs, decode_reqs, total_units,
                              tbt_slo, unit_step=unit_step,
                              min_decode_units=unit_step)
    if part is None:
        return ScheduleDecision(mode="aggregated", t_mixed=t_mixed)
    return ScheduleDecision(mode="duet", t_mixed=t_mixed, partition=part)
