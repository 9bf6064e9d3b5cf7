#!/usr/bin/env python3
"""Rebuild the port's bf16 flash_prefill kernel (``csrc/flash_prefill.cu``
on the block of ``csrc/prefill_core.cuh``) with other ring depths, warps a
block and blocks an SM, and time it at the kernels phase's three prefill
shapes, on one NVIDIA card.

    python3 flash_prefill_sweep.py

For each variant it writes a copy of the kernel sources with the
constants changed into ``build/sweep/flash_<variant>/`` (git ignores
``build/``), builds ``flash_prefill.cu`` from it, holds the kernel to its
plain version and times it hot and cold with ``chip_smoke.py``'s checks
and timers (bf16; also the plain version and SDPA). One line per
(variant, shape). Without CUDA it exits non-zero and prints no result.
"""
from __future__ import annotations

import re
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
# (variant, {constant: value}) applied to csrc/prefill_core.cuh (NSTAGE,
# MMA_WARPS) or csrc/flash_prefill.cu (MMA_BLOCKS); a block has 16 query
# rows per warp
VARIANTS = [("as built", {}),
            ("MMA_BLOCKS 3", {"MMA_BLOCKS": 3}),      # 168 registers
            ("NSTAGE 3", {"NSTAGE": 3}),
            ("MMA_WARPS 8", {"MMA_WARPS": 8, "MMA_BLOCKS": 1})]
SHAPES = [("main Sq 256 @ 512, Sk 768", 256, 768, 512),
          ("long Sq 4096 @ 0, Sk 4096", 4096, 4096, 0),
          ("chunk Sq 512 @ 3584, Sk 4096", 512, 4096, 3584)]


def build_variant(name: str, consts: dict):
    """Point the port's builder at a copy of csrc/ with ``consts`` set (in
    prefill_core.cuh, the block's ring and warps, or flash_prefill.cu, the
    blocks an SM) and build flash_prefill.cu from it."""
    from repro_torch.kernels import _build
    src = HERE / "build" / "sweep" / ("flash_" + re.sub(r"\W+", "_", name))
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(HERE / "src/repro_torch/kernels/csrc", src)
    files = {f: (src / f).read_text()
             for f in ("prefill_core.cuh", "flash_prefill.cu")}
    for const, value in consts.items():
        hits = 0
        for f, text in files.items():
            files[f], n = re.subn(rf"constexpr int {const} = \d+;",
                                  f"constexpr int {const} = {value};", text)
            hits += n
        if hits != 1:
            raise RuntimeError(f"no single constant {const}")
    for f, text in files.items():
        (src / f).write_text(text)
    _build.CSRC, _build.BUILD_DIR = src, src / "lib"
    _build._libs.clear()
    for line in _build.build_all(("flash_prefill",))["flash_prefill"] \
            .splitlines():
        if ("registers" in line or "spill" in line) and "Used" in line:
            print(f"[sweep] {name:12s} ptxas: {line.strip()}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_prefill_sweep: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE / "src"))
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from repro_torch.kernels.flash_prefill import occupancy
    card = cs.card_line()
    H, G, Dh = 32, 8, 128
    for name, consts in VARIANTS:
        build_variant(name, consts)
        occupancy.cache_clear()
        blocks, smem = occupancy(torch.cuda.current_device(), Dh)
        print(f"[sweep] {name:12s} Dh {Dh}: {blocks} blocks an SM, "
              f"{smem / 1024:.0f} KB shared memory each [{card}]",
              flush=True)
        for label, Sq, Sk, off in SHAPES:
            rec = cs.check_flash(np.random.default_rng(0), label,
                                 torch.bfloat16, 1, Sq, Sk, H, G, Dh, off)
            print(f"[sweep] {name:12s} {label:30s} max_abs_err="
                  f"{rec['max_abs_err']:.2e} ms={rec['ms']:.4f} "
                  f"cold_ms={rec['cold_ms']:.4f} "
                  f"bound_ms={rec['bound_ms']:.4f} "
                  f"library_ms={rec['library_ms']:.4f} [{card}]",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
