"""Request lifecycle and serving metrics (TTFT / TBT / throughput)."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


def synth_prompt_tokens(rid: int, vocab_size: int, n: int) -> np.ndarray:
    """Deterministic rid-derived prompt tokens for trace requests that carry
    lengths only. Single source of the seeding convention: the engines'
    prompt materialization and the serve CLI's shared-prefix builder must
    derive identical bodies."""
    return np.random.default_rng(rid).integers(0, vocab_size, n) \
        .astype(np.int32)


class Phase(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"
    REJECTED = "rejected"


@dataclass
class Request:
    rid: int
    arrival: float               # seconds since serving start
    prompt_len: int
    output_len: int              # target generation length

    # progress ------------------------------------------------------------
    phase: Phase = Phase.WAITING
    prefilled: int = 0           # prompt tokens already prefilled
    generated: int = 0           # output tokens produced
    # prefix cache: tokens served from shared cached pages instead of being
    # recomputed. The real engine writes it when a prefix lock succeeds; a
    # simulator trace may preset it to model a known hit (the policy then
    # starts the prefill at the cached length). ``prefill_executed`` counts
    # the prompt tokens actually run through the model — monotone across
    # preemptions, so executed vs cached accounting survives recompute.
    cached_prompt: int = 0
    prefill_executed: int = 0
    slot: Optional[int] = None   # engine batch slot (real engine only)
    prompt_tokens: Optional[np.ndarray] = None   # real engine: token ids
    output_tokens: List[int] = field(default_factory=list)

    # preemption / admission outcome ---------------------------------------
    # After a recompute-from-prompt preemption the prefill must cover the
    # prompt plus all already-sampled output tokens except the last (the last
    # one is the next decode input). ``resume_len`` freezes that target.
    resume_len: int = 0
    preemptions: int = 0
    finish_reason: Optional[str] = None   # "completed" | "rejected:<why>"

    # metrics ---------------------------------------------------------------
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    token_times: List[float] = field(default_factory=list)

    @property
    def prefill_total(self) -> int:
        """Tokens the prefill phase must process (prompt, or the frozen
        resume target after a preemption)."""
        return self.resume_len or self.prompt_len

    @property
    def remaining_prompt(self) -> int:
        return self.prefill_total - self.prefilled

    @property
    def folded_outputs(self) -> int:
        """Output tokens replayed inside the (resume) prefill."""
        return max(0, self.resume_len - self.prompt_len)

    @property
    def context_len(self) -> int:
        """Tokens currently in this request's KV cache."""
        return self.prefilled + self.generated - self.folded_outputs

    def prefill_token_ids(self) -> np.ndarray:
        """Token ids the prefill consumes: the prompt, extended with the
        already-sampled outputs being replayed after a preemption."""
        if self.folded_outputs:
            return np.concatenate([
                np.asarray(self.prompt_tokens, np.int32),
                np.asarray(self.output_tokens[:self.folded_outputs],
                           np.int32)])
        return np.asarray(self.prompt_tokens, np.int32)

    @property
    def done(self) -> bool:
        return self.generated >= self.output_len

    # ------------------------------------------------------------------
    def record_token(self, now: float):
        self.generated += 1
        if self.first_token_time is None:
            self.first_token_time = now
        self.token_times.append(now)
        if self.done:
            self.phase = Phase.FINISHED
            self.finish_time = now
            self.finish_reason = "completed"

    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival

    def tbt_samples(self) -> List[float]:
        return [b - a for a, b in zip(self.token_times, self.token_times[1:])]


@dataclass
class ServingMetrics:
    requests: List[Request] = field(default_factory=list)
    duration: float = 0.0

    def slo_attainment(self, tbt_slo: float,
                       ttft_slo: Optional[float] = None) -> float:
        """Fraction of requests that finished AND met the latency SLOs.

        A request attains the SLO when every one of its time-between-token
        samples is ≤ ``tbt_slo`` and (when ``ttft_slo`` is given) its TTFT
        is ≤ ``ttft_slo``. Rejected/unfinished requests count against
        attainment — the cluster-level goodput denominator is every
        submitted request. Returns NaN for an empty request set.
        """
        if not self.requests:
            return float("nan")
        ok = 0
        for r in self.requests:
            if r.finish_time is None or r.phase == Phase.REJECTED:
                continue
            if any(t > tbt_slo for t in r.tbt_samples()):
                continue
            if ttft_slo is not None and (r.ttft() or 0.0) > ttft_slo:
                continue
            ok += 1
        return ok / len(self.requests)

    def summary(self) -> dict:
        finished = [r for r in self.requests if r.finish_time is not None]
        ttfts = [r.ttft() for r in finished if r.ttft() is not None]
        tbts = [t for r in finished for t in r.tbt_samples()]
        out_tokens = sum(r.generated for r in self.requests)
        total_tokens = out_tokens + sum(r.prefilled for r in self.requests)
        dur = max(self.duration, 1e-9)
        return {
            "num_finished": len(finished),
            "num_requests": len(self.requests),
            "num_rejected": sum(1 for r in self.requests
                                if r.phase == Phase.REJECTED),
            "num_preemptions": sum(r.preemptions for r in self.requests),
            "prefill_tokens_executed": sum(r.prefill_executed
                                           for r in self.requests),
            "prefill_tokens_cached": sum(r.cached_prompt
                                         for r in self.requests),
            "mean_ttft_s": sum(ttfts) / len(ttfts) if ttfts else float("nan"),
            "p50_ttft_s": _pct(ttfts, 0.50),
            "p95_ttft_s": _pct(ttfts, 0.95),
            "p99_ttft_s": _pct(ttfts, 0.99),
            "p999_ttft_s": _pct(ttfts, 0.999),
            "mean_tbt_s": sum(tbts) / len(tbts) if tbts else float("nan"),
            "p50_tbt_s": _pct(tbts, 0.50),
            "p95_tbt_s": _pct(tbts, 0.95),
            "p99_tbt_s": _pct(tbts, 0.99),
            "p999_tbt_s": _pct(tbts, 0.999),
            "request_throughput": len(finished) / dur,
            "output_token_throughput": out_tokens / dur,
            "total_token_throughput": total_tokens / dur,
            "duration_s": self.duration,
        }


def _pct(xs: List[float], p: float) -> float:
    if not xs:
        return float("nan")
    xs = sorted(xs)
    idx = min(len(xs) - 1, int(p * len(xs)))
    return xs[idx]
