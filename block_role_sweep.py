#!/usr/bin/env python3
"""paged_decode's block role on both blocks, in turns on one card:
granite-20b's heads (48 on one KV head, Dh 128, bf16, pages of 16), each
case timed on the warpgroup block (``csrc/wg_block.cuh``) with the host's
cluster cap (``ops.cluster_cap``: up to 16 where clusters of 16 give at
most 64 CTAs, else up to 8), with clusters of up to 16 always ("C<=16"),
with clusters of up to 8 always ("C<=8"), and on prefill_core.cuh's
mma.sync block, in the order of ORDER, with chip_smoke.py's checks (the
plain version, hot and cold ms, the bound). The host's table rule
(``ops.PAGED_WG_MIN_KEYS``) is set aside for the run, so this reads where
each block wins.

    python3 block_role_sweep.py [case-name prefix ...]

Cases: 8 requests of 256..2048 (the kernels phase's main shape); equal
contexts at the low and high end of each table width the engine buckets
(the table is the next power of two of pages above the longest request,
so a table of P pages holds requests of 8P + 1 .. 16P tokens): 1000 over
64 pages, 1100 / 1300 / 1600 / 2000 over 128, 2100 / 2600 / 3200 over
256, 4200 over 512, at a batch of 8; 1100 over 128 at 16 and 32; 1100,
2000 over 128 and 4200 over 512 at 1, 2 and 4; 8 of 1024..4096 and 32 of
1024..8192. Then (with no prefix given) granite-20b's replayed decode
step (13 layers, 8 rows at 1100 and at 2000 over tables of 128 pages,
CUDA graphs captured on each of STEP_BLOCKS) in five rounds of that
order and its reverse, within this one process. Prints a line a case and
block, each case's mean ratios to mma, with the card's name and power
limit. Needs the card."""
import importlib
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WG = ("warpgroup", "warpgroup C<=16", "warpgroup C<=8")
ORDER = ("warpgroup", "mma", "warpgroup C<=16", "warpgroup C<=8",
         "warpgroup C<=8", "warpgroup C<=16", "mma", "warpgroup")
STEP_ROUNDS = 5
STEP_WORLDS = ((1100, 128), (2000, 128))
STEP_BLOCKS = ("warpgroup", "warpgroup C<=16", "mma")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("block_role_sweep.py: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    ops = importlib.import_module("repro_torch.kernels.ops")
    paged = importlib.import_module("repro_torch.kernels.paged_decode")
    card = cs.card_line()
    bf, H, G, Dh, ps = torch.bfloat16, 48, 1, 128, 16

    def case(B, P, lengths):
        return lambda r, label: cs.check_decode(
            r, label, bf, B, H, G, Dh, B * P + 1, ps, P,
            lengths=np.asarray(lengths, np.int64), distinct=True)
    cases = {"B=8 ctx 256-2048 P=128": case(
        8, 128, np.linspace(256, 2048, 8).astype(np.int64))}
    for B, ctx, P in ((8, 1000, 64), (8, 1100, 128), (8, 1300, 128),
                      (8, 1600, 128), (8, 2000, 128), (8, 2100, 256),
                      (8, 2600, 256), (8, 3200, 256), (8, 4200, 512),
                      (32, 1100, 128), (16, 1100, 128), (16, 4200, 512)):
        cases[f"B={B} ctx {ctx} P={P}"] = case(B, P, np.full(B, ctx))
    for B in (1, 2, 4):
        for ctx, P in ((1100, 128), (2000, 128), (4200, 512)):
            cases[f"B={B} ctx {ctx} P={P}"] = case(B, P, np.full(B, ctx))
    cases["B=8 ctx 1024-4096 P=256"] = case(
        8, 256, np.linspace(1024, 4096, 8).astype(np.int64))
    cases["B=32 ctx 1024-8192 P=512"] = case(
        32, 512, np.linspace(1024, 8192, 32).astype(np.int64))

    rule = (ops.BLOCK_CLUSTER_MAX, ops.BLOCK_WIDE_CTAS)

    def use(block):
        paged.PAGED_WG_MIN_KEYS = 0 if block.startswith("warpgroup") \
            else 1 << 30
        ops.BLOCK_CLUSTER_MAX, ops.BLOCK_WIDE_CTAS = rule
        if block.endswith("C<=8"):
            ops.BLOCK_CLUSTER_MAX = 8
        elif block.endswith("C<=16"):
            ops.BLOCK_WIDE_CTAS = 1 << 30
        paged.occupancy.cache_clear()
    only = sys.argv[1:]
    if only:
        cases = {k: v for k, v in cases.items()
                 if any(k.startswith(o) for o in only)}
    print(f"[sweep] card: {card}", flush=True)
    for name, fn in cases.items():
        got = {b: [] for b in ORDER}
        for block in ORDER:
            use(block)
            rec = fn(np.random.default_rng(0), name)
            got[block].append((rec["ms"], rec["cold_ms"]))
            print(f"[sweep] {name:26s} {block:15s} {rec['case']:30s} "
                  f"ms={rec['ms']:.4f} cold_ms={rec['cold_ms']:.4f} "
                  f"bound_ms={rec['bound_ms']:.4g} "
                  f"({rec['bound_ms'] / rec['cold_ms']:.1%} of cold) "
                  f"max_abs_err={rec['max_abs_err']:.2e} [{card}]",
                  flush=True)
        m = np.mean(got["mma"], axis=0)
        ratios = "; ".join(
            f"{b} / mma: hot {w[0] / m[0]:.3f}, cold {w[1] / m[1]:.3f}"
            for b, w in ((b, np.mean(got[b], axis=0)) for b in WG))
        print(f"[sweep] {name:26s} {ratios} [{card}]", flush=True)
    if not only:
        step_turns(cs, paged, use, card)
    use("warpgroup")
    return 0


def step_turns(cs, paged, use, card):
    """granite-20b's decode bucket at ROOFLINE_LAYERS' depth, 8 rows at
    each of STEP_WORLDS, captured once on each block of STEP_BLOCKS and
    replayed in STEP_ROUNDS rounds of that order and its reverse (device
    ms of one replay, chip_smoke._replayer)."""
    import torch
    from repro_torch.models import Model
    cfg = cs._cut("granite-20b", cs.ROOFLINE_LAYERS["granite-20b"])
    model = Model.init(cfg, seed=0, dtype=torch.bfloat16, device="cuda",
                       attn_kernel=True)
    for ctx, P in STEP_WORLDS:
        replay = {}
        for block in STEP_BLOCKS:
            use(block)
            before = dict(paged.block_launches)
            replay[block] = cs._replayer(model, "decode", ctx, P)
            took = {k: v - before[k] for k, v in paged.block_launches.items()}
            engine = "mma" if block == "mma" else "warpgroup"
            assert took[engine] > 0 and sum(took.values()) == took[engine]
        got = {b: [] for b in STEP_BLOCKS}
        for _ in range(STEP_ROUNDS):
            for block in STEP_BLOCKS + STEP_BLOCKS[::-1]:
                got[block].append(replay[block]())
        med = {b: float(np.median(got[b])) for b in STEP_BLOCKS}
        for block in STEP_BLOCKS:
            print(f"[sweep] granite-20b decode step, {cfg.num_layers} "
                  f"layers, 8 rows at ctx {ctx} over {P} pages, {block}: "
                  f"ms {' '.join(f'{x:.4f}' for x in got[block])}; median "
                  f"{med[block]:.4f}, / mma {med[block] / med['mma']:.4f} "
                  f"[{card}]", flush=True)
        del replay
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
