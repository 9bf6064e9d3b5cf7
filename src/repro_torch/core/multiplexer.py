"""Adaptive multiplexing controller — ties the roofline predictor (§4.1) and
the partition optimizer (§4.2) into the per-iteration decision the DuetServe
scheduler consumes: *aggregated* execution by default, *duet* (spatially
multiplexed) execution only when a TBT violation is predicted.

The controller also owns the profiled Π(S)/B(S) tables. The paper profiles
these with microbenchmarks at engine start; here they default to analytic
TPU curves (linear per chip — DESIGN.md §2) sampled at every integer unit
count, and the roofline consults the *tables* (piecewise-linear) for every
latency estimate — so a real deployment drops measured values in via the
``pi_table``/``bw_table`` constructor args and Algorithm 1 runs against
them unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

from repro_torch.configs.base import ArchConfig
from repro_torch.core.partition import ScheduleDecision, decide
from repro_torch.core.roofline import (HardwareSpec, RequestLoad, RooflineModel,
                                 TPU_V5E)


@dataclass
class MultiplexerStats:
    iterations: int = 0
    duet_iterations: int = 0
    aggregated_iterations: int = 0
    predicted_violations: int = 0

    @property
    def duet_fraction(self) -> float:
        return self.duet_iterations / max(1, self.iterations)


class TabulatedPartitionCurves:
    """Π(S)/B(S) hardware curves backed by per-unit tables (paper: profiled
    at engine start). Behaves like a :class:`HardwareSpec` — the roofline
    calls ``pi``/``bw`` and reads spec constants through delegation.

    Integer unit counts read the table directly; fractional counts in the
    table range interpolate linearly between the bracketing entries; counts
    below one unit (kernel-grid slots expressed as chip fractions) scale
    the one-unit table entry by the base spec's sub-unit curve shape, so an
    analytic table reproduces the base spec exactly."""

    def __init__(self, base: HardwareSpec, pi_table: Dict[int, float],
                 bw_table: Dict[int, float]):
        self._base = base
        self._pi = dict(pi_table)
        self._bw = dict(bw_table)
        # both tables must cover the same contiguous 1..N unit range: the
        # interpolating lookup reads table[lo]/table[lo+1] for any
        # fractional count and table[N] for the extrapolation anchor, so a
        # gap or a range mismatch between measured curves would KeyError
        # (or extrapolate from a missing entry) mid-decision.
        for name, tbl in (("pi_table", self._pi), ("bw_table", self._bw)):
            if not tbl or set(tbl) != set(range(1, max(tbl) + 1)):
                raise ValueError(
                    f"{name} must cover contiguous unit counts 1..N, got "
                    f"keys {sorted(tbl)}")
        if max(self._pi) != max(self._bw):
            raise ValueError(
                "pi_table and bw_table must cover the same unit range, got "
                f"1..{max(self._pi)} vs 1..{max(self._bw)}")
        self._n = max(self._pi)

    def _lookup(self, table: Dict[int, float], base_curve, units: float
                ) -> float:
        if units < 1.0:
            return table[1] * base_curve(units) / max(base_curve(1), 1e-30)
        if units >= self._n:
            return table[self._n] * units / self._n
        lo = int(units)
        frac = units - lo
        if frac == 0.0:
            return table[lo]
        return table[lo] + frac * (table[lo + 1] - table[lo])

    def pi(self, units: float) -> float:
        return self._lookup(self._pi, self._base.pi, units)

    def bw(self, units: float) -> float:
        return self._lookup(self._bw, self._base.bw, units)

    def __getattr__(self, item):
        return getattr(self._base, item)


class AdaptiveMultiplexer:
    """Per-iteration mode decision for one engine replica.

    Args:
      cfg: architecture being served.
      hw: hardware spec (defaults to TPU v5e).
      total_units: partitionable units available to this replica (chips in
        its slice; 1 when the engine runs a single chip and partitioning
        happens at kernel-grid granularity — see kernels/duet_attention).
      tbt_slo: decode TBT bound (s).
      tp: tensor-parallel degree inside the replica.
      mesh: the device mesh the replica executes on (an object with a
        ``shape`` mapping; single-device serving passes None); when
        given, the roofline derives tp from its ``model`` axis (and
        rejects a contradicting ``tp``), so planning and execution share
        one geometry.
      pi_table/bw_table: measured Π(S)/B(S) curves keyed by unit count
        (1..total_units). Default: sampled from the analytic ``hw`` spec.
        Every roofline estimate this controller makes goes through the
        tables, so dropping in profiled values changes the decisions.
    """

    def __init__(self, cfg: ArchConfig, *, hw: HardwareSpec = TPU_V5E,
                 total_units: int = 256, tbt_slo: float = 0.1, tp: int = 1,
                 unit_step: int = 1, granularity: int = 64,
                 sliding_window: Optional[int] = None,
                 mla_absorb: bool = False, page_size: int = 1,
                 pi_table: Optional[Dict[int, float]] = None,
                 bw_table: Optional[Dict[int, float]] = None,
                 mesh=None):
        self.cfg = cfg
        self.mesh = mesh  # executed geometry; RooflineModel derives tp
        self.hw = hw
        self.total_units = total_units
        self.tbt_slo = tbt_slo
        self.unit_step = unit_step
        # profiled partition curves (paper: microbenchmarked at engine
        # start; analytic fallback here). The roofline model reads hardware
        # throughput/bandwidth exclusively through these tables.
        self.pi_table: Dict[int, float] = dict(pi_table) if pi_table else {
            u: hw.pi(u) for u in range(1, total_units + 1)}
        self.bw_table: Dict[int, float] = dict(bw_table) if bw_table else {
            u: hw.bw(u) for u in range(1, total_units + 1)}
        # a measured table shorter than the replica silently degrades to
        # linear extrapolation for the uncovered counts — the exact
        # assumption profiling exists to replace, so refuse it up front
        if pi_table and max(self.pi_table) < total_units:
            raise ValueError(
                f"pi_table/bw_table cover units 1..{max(self.pi_table)} "
                f"but total_units={total_units}; profile every unit count "
                "Algorithm 1 can query")
        self.model = RooflineModel(
            cfg, TabulatedPartitionCurves(hw, self.pi_table, self.bw_table),
            tp=tp, sliding_window=sliding_window, mla_absorb=mla_absorb,
            page_size=page_size, mesh=mesh)
        self.stats = MultiplexerStats()
        # grid-granularity variant: when the replica is one chip, Algorithm 1
        # enumerates fused-kernel grid slots instead of chips.
        self.granularity = granularity

    # ------------------------------------------------------------------
    def step(self, prefill_reqs: Sequence[RequestLoad],
             decode_reqs: Sequence[RequestLoad]) -> ScheduleDecision:
        """Make one iteration's duet-vs-aggregated decision (Algorithm 1
        front-end).

        Args:
            prefill_reqs: this iteration's prefill chunks as request loads
                (``q`` = chunk tokens, ``c`` = tokens already prefilled).
            decode_reqs: the decode batch (``q=1``, ``c`` = context).

        Returns:
            :class:`ScheduleDecision` — ``mode="duet"`` carries the
            (S_p, S_d, k) partition; stats counters update as a side
            effect (``self.stats``).
        """
        units = self.total_units if self.total_units > 1 else self.granularity
        model = self.model
        if self.total_units == 1:
            # fractional-chip partitioning: express grid slots as fractional
            # units of one chip so the same Algorithm 1 enumeration applies.
            model = _FractionalModel(self.model, self.granularity)
        decision = decide(model, prefill_reqs, decode_reqs, units,
                          self.tbt_slo, unit_step=self.unit_step)
        self.stats.iterations += 1
        if decision.t_mixed > self.tbt_slo:
            self.stats.predicted_violations += 1
        if decision.mode == "duet":
            self.stats.duet_iterations += 1
        else:
            self.stats.aggregated_iterations += 1
        return decision

    def predict_mixed(self, reqs: Sequence[RequestLoad]) -> float:
        """Roofline latency (s) of one aggregated iteration running
        ``reqs`` on all of this replica's units — the τ_TBT check duet
        mode is gated on."""
        return self.model.iteration_latency(reqs, units=self.total_units)


class _FractionalModel:
    """Adapter: unit = 1/granularity of a chip (fused-kernel grid slots)."""

    def __init__(self, base: RooflineModel, granularity: int):
        self._base = base
        self._g = granularity

    def iteration_latency(self, reqs, units=None):
        frac = 1.0 if units is None else units / self._g
        return self._base.iteration_latency(reqs, units=frac)

    def __getattr__(self, item):
        return getattr(self._base, item)
