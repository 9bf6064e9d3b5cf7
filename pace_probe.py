#!/usr/bin/env python3
"""The card's pace over time, with and without a green context.

    python3 pace_probe.py                   # makes no green context
    python3 pace_probe.py --split           # an SmSplit alive from reading 3

Builds full-width qwen3-4b (bf16, random from seed 0, kernel path) on one
CUDA card, captures its decode bucket (chip_smoke.py's roofline shape: 8
rows at ctx 1000) and a graph of 3,000 one-element adds, then reads both
every ``--every`` seconds, ``--readings`` times: held device ms
(chip_smoke.py's ``_graph_ms``: the replays queued behind a spin). A
thread samples nvidia-smi's SM and memory clocks every 100 ms meanwhile;
each line gives the clocks sampled during its reading. With ``--split``
an SmSplit of 32 TPCs (``core.device.SmSplit``) is made before reading 3
and closed before the last. Prints one line a reading, then the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import threading
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, HERE)


def sample_clocks(samples, stop):
    """(time.time(), SM MHz, memory MHz) every 100 ms into ``samples``."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        for line in proc.stdout:
            if stop.is_set():
                break
            sm, mem = (int(v) for v in line.split(","))
            samples.append((time.time(), sm, mem))
    finally:
        proc.terminate()
        proc.wait()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--readings", type=int, default=8)
    ap.add_argument("--every", type=float, default=3.0)
    ap.add_argument("--split", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pace_probe.py needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.core.device import SmSplit
    from repro_torch.kernels import _build
    from repro_torch.models import Model
    _build.build_all()
    model = Model.init(get_config("qwen3-4b"), seed=0, dtype=torch.bfloat16,
                       device="cuda", attn_kernel=True)
    decode_ms = chip_smoke._replayer(model, "decode")
    tiny = torch.zeros(1, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tiny.add_(1)
    torch.cuda.current_stream().wait_stream(side)
    adds = torch.cuda.CUDAGraph()
    with torch.cuda.graph(adds):
        for _ in range(3000):
            tiny.add_(1)
    samples, stop = [], threading.Event()
    sampler = threading.Thread(target=sample_clocks, args=(samples, stop),
                               daemon=True)
    sampler.start()
    split = None
    t0 = time.time()
    for i in range(args.readings):
        if args.split and i == 2:
            split = SmSplit("cuda", 32)
        if split is not None and i == args.readings - 1:
            split.close()
            split = None
        start = time.time()
        dec = decode_ms()
        add = chip_smoke._graph_ms(adds.replay, 5)
        end = time.time()
        seen = [(sm, mem) for t, sm, mem in samples if start <= t <= end]
        clocks = (f"SM {min(s for s, _ in seen)}-{max(s for s, _ in seen)} "
                  f"MHz, memory {min(m for _, m in seen)}-"
                  f"{max(m for _, m in seen)} MHz in {len(seen)} samples"
                  if seen else "no clock sample")
        print(f"[pace] t {start - t0:6.2f} s: decode {dec:.3f} ms, 3000 adds "
              f"{add:.3f} ms; {clocks}; split "
              f"{'alive' if split is not None else 'none'}", flush=True)
        time.sleep(args.every)
    stop.set()
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
