#!/usr/bin/env python3
"""Two trees' kernels phase taken in turns on one card: each tree's
``chip_smoke.py --phases build,kernels``, run in the order given (by
default parent, this, this, parent), and every record of the kernels
compared case by case: the mean hot ms and cold ms of each tree's runs
and their ratio. With ``--phases build,roofline`` the replayed buckets'
measured device ms of the roofline phase are compared instead (as hot
ms; no cold reading).

    python3 kernel_turns.py build/parent              # parent = that tree
    python3 kernel_turns.py build/parent --order ptp   # fewer runs
    python3 kernel_turns.py build/parent --phases build,roofline

A case is the record's kernel, dtype and case label without the cluster
size the label carries (" C=n"), so the two trees' records of one shape
meet even where they pick different clusters. Writes
the table to chiprun_out/kernel_turns.json and prints each case, the
slower ones marked; the card's name and power limit head the output.
Needs the card; each run builds its tree's kernels in its own build
directory."""
import argparse
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
LINE = re.compile(r"\[kernels\] (\S+)\s+(torch\.\w+)\s+(.*?)\s+"
                  r"max_abs_err=\S+ .*?\bms=(\S+) cold_ms=(\S+)")
GEOMETRY = re.compile(r" C=\d+")
BUCKET = re.compile(r"\[roofline\] (\S+ (?:decode|prefill|duet))\s+card "
                    r".*?measured\s+(\S+)")


def run_tree(root: str, phases: str) -> dict:
    """{(kernel, dtype, case): (ms, cold_ms)} of one kernels phase, and
    {("bucket", "", what): (ms, nan)} of a roofline phase's replays."""
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py", "--phases", phases],
        cwd=root, capture_output=True, text=True, timeout=1500)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: chip_smoke.py exit {proc.returncode}:"
                           f"\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    out = {}
    for line in proc.stdout.splitlines():
        m = LINE.search(line)
        if m:
            key = (m.group(1), m.group(2), GEOMETRY.sub("", m.group(3)))
            out[key] = (float(m.group(4)), float(m.group(5)))
        m = BUCKET.search(line)
        if m:
            out[("bucket", "", m.group(1))] = (float(m.group(2)),
                                               float("nan"))
    print(f"[turns] {root}: {len(out)} records in {time.time() - t0:.1f} s",
          flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", help="the other tree's root (with its own "
                    "chip_smoke.py)")
    ap.add_argument("--order", default="pttp",
                    help="p (parent) and t (this tree), in run order")
    ap.add_argument("--phases", default="build,kernels",
                    help="chip_smoke.py's phases for each run")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_turns.py: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"[turns] card: {card}", flush=True)
    roots = {"p": os.path.abspath(args.parent), "t": HERE}
    runs = {"p": [], "t": []}
    for who in args.order:
        runs[who].append(run_tree(roots[who], args.phases))
    table = []
    keys = [k for k in runs["t"][0] if all(k in r for r in runs["p"])]
    for key in keys:
        row = {"kernel": key[0], "dtype": key[1], "case": key[2]}
        for who in "pt":
            for i, what in enumerate(("ms", "cold_ms")):
                vals = [r[key][i] for r in runs[who] if key in r]
                row[f"{who}_{what}"] = sum(vals) / len(vals)
                row[f"{who}_{what}_runs"] = vals
        row["hot_ratio"] = row["t_ms"] / row["p_ms"]
        row["cold_ratio"] = row["t_cold_ms"] / row["p_cold_ms"]
        table.append(row)
        mark = "  SLOWER" if row["hot_ratio"] > 1 or \
            row["cold_ratio"] > 1 else ""
        print(f"[turns] {key[0]:27s} {key[1]:15s} {key[2]:52s} hot "
              f"{row['p_ms']:.4f} -> {row['t_ms']:.4f} "
              f"({row['hot_ratio']:.3f}) cold {row['p_cold_ms']:.4f} -> "
              f"{row['t_cold_ms']:.4f} ({row['cold_ratio']:.3f}){mark}",
              flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    name = "kernel_turns" + ("" if args.phases == "build,kernels" else
                             "_" + args.phases.replace(",", "_"))
    with open(os.path.join(HERE, "chiprun_out", f"{name}.json"), "w") as f:
        json.dump({"card": card, "order": args.order, "phases": args.phases,
                   "cases": table}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
