"""Workload traces (paper Table 1) and Poisson arrival synthesis.

The paper evaluates on Azure-Code, Azure-Conversation (Microsoft 2023 Azure
LLM inference traces) and Mooncake-Conversation. The public traces are not
shipped offline, so each is synthesised to match its published statistics
(mean ISL/OSL from Table 1) with the long-tailed length distributions the
originals exhibit (lognormal, clipped). Arrivals follow a Poisson process per
the paper's methodology (Yu et al. 2022; Kwon et al. 2023).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np

from repro_torch.serving.request import Request


@dataclass(frozen=True)
class TraceSpec:
    name: str
    mean_isl: int      # input sequence length
    mean_osl: int      # output sequence length
    cv_isl: float      # coefficient of variation of ISL
    cv_osl: float
    max_isl: int = 32768
    max_osl: int = 4096


# Table 1 of the paper
TRACES = {
    "azure-code": TraceSpec("azure-code", 2047, 28, 1.2, 1.0),
    "azure-conv": TraceSpec("azure-conv", 1155, 211, 1.1, 0.9),
    "mooncake":   TraceSpec("mooncake", 12035, 343, 0.9, 0.8),
}


def _lognormal(rng: np.random.Generator, mean: float, cv: float,
               size: int) -> np.ndarray:
    sigma2 = math.log(1.0 + cv * cv)
    mu = math.log(mean) - sigma2 / 2.0
    return rng.lognormal(mu, math.sqrt(sigma2), size)


def synth_trace(name: str, num_requests: int, qps: float,
                seed: int = 0) -> List[Request]:
    """Synthesise `num_requests` with Poisson(qps) arrivals."""
    spec = TRACES[name]
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / qps, num_requests)
    arrivals = np.cumsum(gaps)
    isl = np.clip(_lognormal(rng, spec.mean_isl, spec.cv_isl, num_requests),
                  8, spec.max_isl).astype(int)
    osl = np.clip(_lognormal(rng, spec.mean_osl, spec.cv_osl, num_requests),
                  1, spec.max_osl).astype(int)
    return [Request(rid=i, arrival=float(arrivals[i]),
                    prompt_len=int(isl[i]), output_len=int(osl[i]))
            for i in range(num_requests)]


def synthetic_fixed(num_requests: int, qps: float, isl: int, osl: int,
                    seed: int = 0) -> List[Request]:
    """Fixed-length workload (paper Table 2 sensitivity study and the Fig. 2
    agg-vs-disagg benchmark: ISL=8000, OSL=200)."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / qps, num_requests))
    return [Request(rid=i, arrival=float(arrivals[i]), prompt_len=isl,
                    output_len=osl) for i in range(num_requests)]
