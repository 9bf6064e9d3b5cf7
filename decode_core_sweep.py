#!/usr/bin/env python3
"""Rebuild the port's cluster decode core (``csrc/decode_core.cuh``) with
other ring depths and warp counts, and time both cluster kernels at the
main path's shapes for every cluster size, on one NVIDIA card.

    python3 decode_core_sweep.py

For each variant it writes a copy of the kernel sources with the
constants changed into ``build/sweep/<variant>/`` (git ignores ``build/``),
builds ``paged_decode.cu`` and ``duet_attention.cu`` from it, and for
C = 1, 2, 4, 8 (forced in place of the wrappers' own choice) and for the
wrappers' own C holds each kernel to its plain version and times it hot
and cold with ``chip_smoke.py``'s checks and timers (bf16). One line per
(variant, shape, C); the shapes are the kernels phase's main decode cases
and the profile step's (8 rows at 1000 tokens). Without CUDA it exits
non-zero and prints no result.
"""
from __future__ import annotations

import importlib
import re
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
# (variant, {constant: value}) applied to csrc/decode_core.cuh
VARIANTS = [("as built", {}),
            ("NSTAGE 2", {"NSTAGE": 2}),
            ("MMA_WARPS 2", {"MMA_WARPS": 2})]
CLUSTERS = (1, 2, 4, 8, None)       # None: the wrappers' own choice


def build_variant(name: str, consts: dict):
    """Point the port's builder at a copy of csrc/ with ``consts`` set and
    build the two cluster kernels from it."""
    from repro_torch.kernels import _build
    src = HERE / "build" / "sweep" / re.sub(r"\W+", "_", name)
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(HERE / "src/repro_torch/kernels/csrc", src)
    core = (src / "decode_core.cuh").read_text()
    for const, value in consts.items():
        core, n = re.subn(rf"constexpr int {const} = \d+;",
                          f"constexpr int {const} = {value};", core)
        if n != 1:
            raise RuntimeError(f"decode_core.cuh has no constant {const}")
    (src / "decode_core.cuh").write_text(core)
    _build.CSRC, _build.BUILD_DIR = src, src / "lib"
    _build._libs.clear()
    _build.build_all(("paged_decode", "duet_attention"))


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_core_sweep: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE / "src"))
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    # the modules, not the package's functions of the same names
    paged = importlib.import_module("repro_torch.kernels.paged_decode")
    slab = importlib.import_module("repro_torch.kernels.duet_attention")
    own = {paged: paged.cluster_for, slab: slab.cluster_for}
    card = cs.card_line()
    B, H, G, Dh, ps = 8, 32, 8, 128, 16
    lens = np.linspace(256, 2048, B).astype(np.int64)
    slab_rows = [(b, int(c) - 1) for b, c in
                 enumerate(np.linspace(256, 1000, B).astype(np.int64))]
    step_rows = [(b, 999) for b in range(B)]
    bf16 = torch.bfloat16
    cases = [
        ("paged main", lambda rng: cs.check_decode(
            rng, "main B=8 ctx 256-2048", bf16, B, H, G, Dh, B * 128 + 65,
            ps, 128, lengths=lens, distinct=True)),
        ("paged step", lambda rng: cs.check_decode(
            rng, "step B=8 ctx 1000", bf16, B, H, G, Dh, B * 64 + 1, ps, 64,
            lengths=(1000,) * B, distinct=True)),
        ("slab main", lambda rng: cs.check_duet_slab(
            rng, "slab B=8 ctx 256-1000", bf16, B, 1024, G, H, Dh,
            slab_rows, [], bq=1)),
        ("slab step", lambda rng: cs.check_duet_slab(
            rng, "slab B=8 ctx 1000", bf16, B, 1024, G, H, Dh, step_rows, [],
            bq=1))]
    for name, consts in VARIANTS:
        build_variant(name, consts)
        for mod in own:
            mod.occupancy.cache_clear()
        for C in CLUSTERS:
            for mod, pick in own.items():
                mod.cluster_for = pick if C is None else \
                    (lambda *_, c=C: c)
            for label, check in cases:
                rec = check(np.random.default_rng(0))
                print(f"[sweep] {name:12s} {label:11s} "
                      f"{'own' if C is None else 'forced':6s} "
                      f"{rec['case']:28s} max_abs_err="
                      f"{rec['max_abs_err']:.2e} ms={rec['ms']:.4f} "
                      f"cold_ms={rec['cold_ms']:.4f} "
                      f"bound_ms={rec['bound_ms']:.4f} "
                      f"library_ms={rec['library_ms']:.4f} [{card}]",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
