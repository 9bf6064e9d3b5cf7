#!/usr/bin/env python3
"""Time the paged duet kernel (``csrc/duet_attention_paged.cu``) for every
cluster size, and by role, on one NVIDIA card.

    python3 duet_paged_sweep.py

The kernels build as ``chip_smoke.py`` builds them (into the git-ignored
``build/kernels/``). For C = 1, 2, 4, 8 (forced in place of the wrapper's
own choice) and the wrapper's own C, each shape is held to its plain version
and timed hot and cold with ``chip_smoke.py``'s checks and timers (bf16).
The shapes: the kernels phase's main duet case (8 decode rows at
256..2048 tokens beside a 256-row chunk at 512..767, the engine's tiles of
64 // rep = 16 rows), its decode tiles alone and its chunk tiles alone,
and a small launch (one 2048-token decode row beside a 64-row chunk),
where the wrapper's C is above 1. Then ``paged_decode`` on the same 8
decode rows at C = 1 and at its own C, the decode role's yardstick. One
line per (shape, C). Without CUDA it exits non-zero and prints no
result.
"""
from __future__ import annotations

import importlib
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
CLUSTERS = (1, 2, 4, 8, None)       # None: the wrapper's own choice


def main() -> int:
    if not torch.cuda.is_available():
        print("duet_paged_sweep: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE / "src"))
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.ops import duet_block_q
    # the modules, not the package's functions of the same names
    duet = importlib.import_module("repro_torch.kernels.duet_attention")
    paged = importlib.import_module("repro_torch.kernels.paged_decode")
    own_duet, own_paged = duet.paged_cluster_for, paged.cluster_for
    card = cs.card_line()
    B, H, G, Dh, ps, P = 8, 32, 8, 128, 16, 128
    bq = duet_block_q(H, G, Dh)
    lens = np.linspace(256, 2048, B).astype(np.int64)
    drows = [(b, int(lens[b]) - 1) for b in range(B)]
    chunk = [(B, 512 + i) for i in range(256)]
    bf16 = torch.bfloat16
    N = (B + 1) * P + 1

    def duet_case(label, d, p):
        return label, lambda rng: cs.check_duet(
            rng, label, bf16, N, ps, G, H, Dh, P, d, p, bq=bq)
    cases = [duet_case(f"main bq={bq}", drows, chunk),
             duet_case(f"decode tiles bq={bq}", drows, []),
             duet_case(f"chunk tiles bq={bq}", [], chunk),
             duet_case(f"small 1 x 2048 + 64 bq={bq}", [(0, 2047)],
                       [(B, 512 + i) for i in range(64)])]
    _build.build_all(("duet_attention_paged", "paged_decode"))
    for C in CLUSTERS:
        duet.paged_cluster_for = own_duet if C is None else \
            (lambda *_, c=C: c)
        for label, check in cases:
            rec = check(np.random.default_rng(0))
            print(f"[sweep] {rec['case']:36s} "
                  f"{'own' if C is None else f'C={C}':6s} "
                  f"max_abs_err={rec['max_abs_err']:.2e} "
                  f"ms={rec['ms']:.4f} cold_ms={rec['cold_ms']:.4f} "
                  f"bound_ms={rec['bound_ms']:.4f} [{card}]", flush=True)
    duet.paged_cluster_for = own_duet
    for C in (1, None):
        paged.cluster_for = own_paged if C is None else (lambda *_, c=C: c)
        rec = cs.check_decode(np.random.default_rng(0),
                              "paged_decode 8 rows ctx 256-2048", bf16, B,
                              H, G, Dh, N, ps, P, lengths=lens,
                              distinct=True)
        print(f"[sweep] paged_decode {rec['case']:40s} "
              f"{'own' if C is None else 'forced C=1':10s} "
              f"max_abs_err={rec['max_abs_err']:.2e} ms={rec['ms']:.4f} "
              f"cold_ms={rec['cold_ms']:.4f} bound_ms={rec['bound_ms']:.4f} "
              f"[{card}]", flush=True)
    paged.cluster_for = own_paged
    return 0


if __name__ == "__main__":
    sys.exit(main())
