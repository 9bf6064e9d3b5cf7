#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) works on
one NVIDIA H100.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --phases build,kernels

Phases (each raises on failure; nothing is swallowed):

1. build   — compile every CUDA source of the port with nvcc (in
             parallel), print the build seconds and ptxas' registers and
             spills of each kernel, by name.
2. kernels — hold each kernel against its plain PyTorch version on the card
             at the serving path's shapes, at the small GQA/MQA/MHA,
             odd-length, dead-split and ragged shapes of the kernel tests
             and at the cluster decode kernels' edges, in fp32 and bf16
             (paged_decode_splitkv against both its plain versions: the
             cluster's span split it runs and the reference's table
             split; flash_prefill also at a whole 4096-token prompt and at
             the last 512-token chunk of one, and at its tile edges;
             duet_attention_paged at the async engine's tiles of 64 // rep
             rows, the main record, and at one row a tile, and at its tile
             edges, against both its plain versions, pad rows zero);
             then every GQA head shape of the registered configs
             (granite-20b's rep 48, yi-9b's rep 8, minicpm-2b's rep 1 at
             Dh 64, qwen3-14b's rep 5, granite-moe-3b-a800m's rep 3 at
             Dh 64) through paged_decode, split-KV,
             the slab decode and the paged duet launch at each config's
             engine tiles, flash_prefill at rep 3, 5, 48, 96 and 128 and
             at Dh 256, and rep 96 and 128 (head blocks) through the
             decode and duet kernels.
             Each case prints its max error beside the tolerance, the
             kernel's time with its inputs in L2 (ms, back-to-back calls)
             and with a cold L2 (cold_ms), the plain version's and a
             library call's time (SDPA over the gathered, head-repeated KV
             with the same mask; for flash_prefill also SDPA with the
             lower-right causal bias where that is the same function;
             timed here only, never used by the port) from CUDA events, and
             the bound (the least time for the bytes and operations the
             inputs need, at the card's published 3.35 TB/s and 989 bf16 /
             67 fp32 TFLOP/s) with its share of cold_ms. Then the cluster
             kernels' and flash_prefill's occupancy at the main shapes
             (the paged duet kernel's at C = 1, 2, 4, 8 with registers),
             with the role each decode kernel's CTAs take (granite-20b's
             too).
3. parity  — full-width qwen3-4b cut to 4 layers, then yi-9b, minicpm-2b,
             granite-20b and granite-moe-3b-a800m cut to 2, fp32 with
             TF32 off: the kernel path's logits against the port's plain
             path for one paged prefill, one paged decode step, one duet
             step (the engine's tiles, and one row a tile for qwen3-4b),
             and one slab decode step after a chunked slab prefill; and,
             for qwen3-4b, flash_prefill on the port's gqa_prefill q/K/V
             against gqa_prefill's own attention. Then deepseek-v2-lite-16b
             cut to 2 layers (its dense MLA layer and one MLA + MoE layer;
             MLA runs no kernel): the paged decode with the latent
             up-projections absorbed against expanded, and the paged
             prefill and decode against the slab's. Then zamba2-1.2b cut
             to 6 layers (5 mamba2 + 1 shared_attn): its kernel path
             against its plain path (paged prefill and decode, slab
             decode); and zamba2 and xlstm-350m cut to 4 layers (3 mlstm
             + 1 slstm): a 600-token prompt prefilled in chunks of 256 and
             8 decode steps, paged and slab, each step's logits against
             one whole prefill of the same tokens.
4. serve   — full qwen3-4b (36 layers, bf16, random weights from a seed)
             serves azure-conv requests on two paths, each with
             attn_kernel=True and strict_kernel=True and the launch counts
             reset to 0 just before it and read just after it:
             the paged path (4 of the 8 requests, those with the shortest
             outputs, through the async engine, the sync engine, and the
             async engine again with split_kv_threshold=256) and the slab
             path (all 8 requests; paged=False: the sync and the async
             engine). The kernels line's launches sum both paths. Every
             request must finish, the async runs must keep host_syncs <=
             super_iterations, the paged async runs must make at least one
             duet dispatch, and every kernel of a path must have launched
             on it. Wall-clock tokens/s on the card are printed as measured.
             A profile step then times one full-width decode step of each
             path and one fused duet super-iteration (kb 1, a 256-row
             chunk), with the duet kernel's share. Then yi-9b, minicpm-2b,
             granite-20b, granite-moe-3b-a800m and deepseek-v2-lite-16b,
             one at a time at full depth (bf16, random weights from seed 0,
             their measured weight bytes and peak memory printed), each
             serve 4 requests of at most 64 output tokens through the
             async engine on the paged path (the duet kernel on for the
             GQA configs; deepseek's MLA runs no kernel, and its paths
             must launch none) and on the slab path, each path's launch
             counts reset just before it and read just after it; a decode
             step of granite-moe is profiled as qwen3-4b's. zamba2-1.2b
             (Mamba2 + a shared attention block) and xlstm-350m (mLSTM +
             sLSTM) serve the same way, their per-slot state bytes
             printed: zamba2's paths must launch paged_decode (paged) and
             the slab duet_attention (slab) and no duet_attention_paged
             (the engines fuse duet steps for all-GQA configs only),
             xlstm's none; a paged decode step of each is profiled. Last,
             slot reuse: zamba2 cut to 12 layers, fp32, the sync engine at
             2 slots serves 4 requests, and each stream must equal the
             request's stream served alone.

Before the last line it prints the card's name and power limit
(``nvidia-smi``) and a ``{"kernels": [...]}`` JSON line (flash_prefill
has no serving path: the reference calls it only from its tests, and the
serve phase fails unless its count reads 0); the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the repository
beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("build", "kernels", "parity", "serve")
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the decode and duet kernels in bf16 (paged_decode, split-KV, both
# duet_attention kernels), (atol, rtol): their errors are the bf16
# rounding of the output (an ulp) and of P before P V (about 2^-9 of a
# key's weight times |v|, at most ~3e-3 on rows of a few keys); the
# paged duet's CPU decomposition tests read at most 0.62 of this limit,
# and the card's largest error on these kernels is 7.8e-3 at outputs of
# 1 to 2 (a bf16 ulp there), under its 5e-3 + 1e-2 x |value|
ATTN_BF16_TOL = (5e-3, 1e-2)
# logits (and flash_prefill's attention output) of the kernel path vs the
# plain path, full width, fp32, TF32 off: only the attention reduction
# order differs
PARITY_TOL = 1e-4           # relative to the reference's max |value|
KERNEL_SOURCES = {
    "paged_decode": ("src/repro_torch/kernels/csrc/paged_decode.cu",
                     "src/repro/kernels/paged_decode.py:85"),
    "paged_decode_splitkv": ("src/repro_torch/kernels/csrc/paged_decode.cu",
                             "src/repro/kernels/paged_decode.py:183"),
    "duet_attention_paged": (
        "src/repro_torch/kernels/csrc/duet_attention_paged.cu",
        "src/repro/kernels/duet_attention.py:189"),
    "duet_attention": ("src/repro_torch/kernels/csrc/duet_attention.cu",
                       "src/repro/kernels/duet_attention.py:112"),
    "flash_prefill": ("src/repro_torch/kernels/csrc/flash_prefill.cu",
                      "src/repro/kernels/flash_prefill.py:78"),
}
# the block role (rep > 16: the 64-row tensor-core block) of the kernels
# that pick their role on the host, a record each at granite-20b's shapes
for _name in ("paged_decode", "paged_decode_splitkv", "duet_attention"):
    KERNEL_SOURCES[f"{_name}[block]"] = KERNEL_SOURCES[_name]
# the serving path that must launch each kernel, of the role the config's
# rep takes ("[block]" above 16 heads a group: granite-20b); split-KV runs
# only in qwen3-4b's split_kv_threshold run; flash_prefill is on none (the
# reference calls it only from its tests), and its count must read 0
PATH_OF = {"paged_decode": "paged", "paged_decode[block]": "paged",
           "paged_decode_splitkv": "paged", "duet_attention_paged": "paged",
           "duet_attention": "slab", "duet_attention[block]": "slab"}
PAGED_MAX_OUTPUT = 160      # see phase_serve's requests()
# the registered configs whose GQA head shapes the kernels phase runs at
# the main path's shapes: granite-20b's MQA (rep 48, every CTA on the
# 64-row block; its bf16 records are the block roles' in the kernels
# line), yi-9b's rep 8, minicpm-2b's rep 1 at Dh 64, and qwen3-14b's rep 5
# (12-position duet tiles), and granite-moe-3b-a800m's rep 3 at Dh 64
# (21-position duet tiles)
HEAD_CONFIGS = ("granite-20b", "yi-9b", "minicpm-2b", "qwen3-14b",
                "granite-moe-3b-a800m")
SERVED_CONFIGS = ("yi-9b", "minicpm-2b", "granite-20b",
                  "granite-moe-3b-a800m", "deepseek-v2-lite-16b",
                  "zamba2-1.2b", "xlstm-350m")
SERVE_REQUESTS, SERVE_MAX_OUTPUT = 4, 64    # each served config's runs
# the recurrent configs' parity depth: zamba2's first 6 layers (5 mamba2
# + 1 shared_attn), xlstm's first 4 (3 mlstm + 1 slstm)
RECURRENT_PARITY_LAYERS = {"zamba2-1.2b": 6, "xlstm-350m": 4}
# the chunked-versus-whole check: a prompt of CHUNKED_PROMPT tokens
# prefilled in chunks of CHUNKED_CHUNK, then CHUNKED_DECODE decode steps
CHUNKED_PROMPT, CHUNKED_CHUNK, CHUNKED_DECODE = 600, 256, 8
# the slot-reuse run: zamba2 cut to its first 12 layers (2 shared_attn),
# fp32, 2 slots, 4 requests of at most 32 output tokens
REUSE_LAYERS, REUSE_SLOTS, REUSE_MAX_OUTPUT = 12, 2, 32


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# A spin kernel queued ahead of the timed work keeps the card busy while
# the host queues it, so the events time the card and not the host's pace.
# Where the card was no longer spinning once the host had queued the timed
# work (the start event had completed), the hold grows 4x and the timing
# runs again, HOLD_TRIES times at most.
HOLD_CYCLES = 400_000       # about 0.2 ms at the H100's clock
HOLD_TRIES = 4
FLUSH_BYTES = 128 << 20     # written between cold calls: > the 50 MB L2


def _held(run, hold: int, stats):
    """``run(hold)`` -> (ms, ahead, host_ms) until ``ahead`` (the card was
    still spinning when the host had queued the timed calls), the hold
    growing 4x a try. ``stats`` (a dict or None) gets the host's ms per
    queued call, the tries and whether the card was ahead at the last."""
    for tries in range(1, HOLD_TRIES + 1):
        ms, ahead, host_ms = run(hold)
        if ahead:
            break
        hold *= 4
    if stats is not None:
        stats.update(host_ms=host_ms, tries=tries, ahead=ahead)
    return ms


def time_ms(fn, iters: int = 20, warmup: int = 3, stats=None) -> float:
    """Mean device time of one call, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls (their inputs stay in L2
    where they fit), behind a spin of HOLD_CYCLES per call."""
    for _ in range(warmup):
        fn()

    def run(hold):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(hold)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3 / iters
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters, ahead, host_ms
    return _held(run, HOLD_CYCLES * iters, stats)


def time_cold_ms(fn, iters: int = 10, stats=None) -> float:
    """Mean device time of one call with a cold L2: a FLUSH_BYTES buffer is
    written before each call, and CUDA events time each call alone (the
    flush is not timed), each behind a spin of HOLD_CYCLES."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()

    def run(hold):
        pairs, ahead, host_s = [], True, 0.0
        for i in range(iters):
            flush.fill_(i & 0xFF)
            torch.cuda._sleep(hold)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            fn()
            host_s += time.perf_counter() - t0
            end.record()
            ahead &= not start.query()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return (sum(s.elapsed_time(e) for s, e in pairs) / iters, ahead,
                host_s * 1e3 / iters)
    return _held(run, HOLD_CYCLES, stats)


def _time_kernel(kernel, rec):
    """A kernel's hot and cold ms into ``rec``, with the host's ms to queue
    one hot call and whether the card stayed ahead of the host in both."""
    hot, cold = {}, {}
    rec["ms"] = time_ms(kernel, stats=hot)
    rec["cold_ms"] = time_cold_ms(kernel, stats=cold)
    rec["host_ms"] = hot["host_ms"]
    rec["held"] = hot["ahead"] and cold["ahead"]
    rec["hold_tries"] = (hot["tries"], cold["tries"])


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------
def phase_build():
    from repro_torch.kernels import _build
    t0 = time.time()
    logs = _build.build_all()
    log(f"[build] {len(logs)} sources built in {time.time() - t0:.2f} s "
        f"into {_build.BUILD_DIR}")
    for name, text in logs.items():
        for kernel, line in ptxas_report(text):
            log(f"[build] {name}: {kernel}: {line}")


def ptxas_report(text: str):
    """(kernel, ptxas line) for each register and spill line of an nvcc
    -Xptxas -v log; kernel names demangled with c++filt where it exists."""
    import re
    import shutil
    rows, kernel = [], "?"
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            kernel = m.group(1)
        elif "registers" in line or "spill" in line:
            rows.append((kernel, line.strip()))
    names = sorted({k for k, _ in rows})
    if names and shutil.which("c++filt"):
        out = subprocess.run(["c++filt", *names], capture_output=True,
                             text=True, check=True).stdout.splitlines()
        plain = dict(zip(names, out))
        rows = [(plain.get(k, k), line) for k, line in rows]
    return rows


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def _bound(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _decode_inputs(rng, B, H, G, Dh, N, ps, P, dtype, lengths=None,
                   distinct=False):
    dev = "cuda"
    q = torch.from_numpy(rng.standard_normal((B, H, Dh), np.float32))
    kp = torch.from_numpy(rng.standard_normal((N, ps, G, Dh), np.float32))
    vp = torch.from_numpy(rng.standard_normal((N, ps, G, Dh), np.float32))
    if distinct:     # a real pool: every request owns its own pages
        tables = 1 + rng.permutation(N - 1)[:B * P].reshape(B, P)
    else:
        tables = rng.integers(1, N, (B, P))
    if lengths is None:
        lengths = rng.integers(1, P * ps + 1, (B,))
    return (q.to(dev, dtype), kp.to(dev, dtype), vp.to(dev, dtype),
            torch.tensor(tables, dtype=torch.int32, device=dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def _sdpa_decode(q, kp, vp, tables, lengths):
    """Library yardstick: SDPA over the gathered, head-repeated KV."""
    B, H, Dh = q.shape
    _, ps, G, _ = kp.shape
    P = tables.shape[1]
    k = kp[tables.long()].reshape(B, P * ps, G, Dh)
    v = vp[tables.long()].reshape(B, P * ps, G, Dh)
    k = k.repeat_interleave(H // G, dim=2).transpose(1, 2)
    v = v.repeat_interleave(H // G, dim=2).transpose(1, 2)
    mask = (torch.arange(P * ps, device=q.device)[None, :]
            < lengths[:, None].long())[:, None, None, :]
    qq = q[:, :, None, :]
    fn = torch.nn.functional.scaled_dot_product_attention
    return lambda: fn(qq, k, v, attn_mask=mask)


def _check(name, got, want, dtype, label, record, tol=None):
    atol, rtol = tol or (TOL[dtype], TOL[dtype])
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol)
    record.update(max_abs_err=err, tol=atol, rtol=rtol)
    if not ok:
        raise AssertionError(f"{name} [{label}] disagrees with its plain "
                             f"version: max abs err {err:.3e} > "
                             f"atol {atol:.0e} + rtol {rtol:.0e}")


def check_decode(rng, label, dtype, B, H, G, Dh, N, ps, P, splits=None,
                 lengths=None, distinct=False):
    from repro_torch.kernels.paged_decode import (
        paged_decode, paged_decode_cluster_plain, paged_decode_plain,
        paged_decode_splitkv, paged_decode_splitkv_plain, splitkv_spans)
    q, kp, vp, tables, ln = _decode_inputs(rng, B, H, G, Dh, N, ps, P, dtype,
                                           lengths, distinct)
    if splits is None:
        name = "paged_decode"
        kernel = lambda: paged_decode(q, kp, vp, tables, ln)  # noqa: E731
        plain = lambda: paged_decode_plain(q, kp, vp, tables, ln)  # noqa
    else:
        name = "paged_decode_splitkv"
        kernel = lambda: paged_decode_splitkv(  # noqa: E731
            q, kp, vp, tables, ln, num_splits=splits)
        plain = lambda: paged_decode_splitkv_plain(  # noqa: E731
            q, kp, vp, tables, ln, num_splits=splits)
    if splits is None:
        from repro_torch.kernels.paged_decode import cluster_for
        label += f" C={cluster_for(q, kp, tables)}"
    from repro_torch.kernels.ops import cta_role
    role = cta_role(H // G)
    rec = {"name": name if role == "decode" else f"{name}[{role}]",
           "case": label, "dtype": str(dtype)}
    tol = ATTN_BF16_TOL if dtype == torch.bfloat16 else None
    got = kernel()
    torch.cuda.synchronize()
    if splits is not None:
        # the algorithm the kernel runs: the live pages in C = S spans
        C = splitkv_spans(P, splits)[0]
        _check(name, got, paged_decode_cluster_plain(
            q, kp, vp, tables, ln, cluster=C), dtype, label + " (spans)",
            rec, tol)
        span_err = rec["max_abs_err"]
    _check(name, got, plain(), dtype, label, rec, tol)
    if splits is not None:
        rec["max_abs_err"] = max(rec["max_abs_err"], span_err)
    elt = q.element_size()
    live = int(ln.long().sum().item())
    nbytes = (2 * q.numel() * elt + tables.numel() * 4 + B * 4
              + 2 * live * G * Dh * elt)
    ops = 4.0 * live * H * Dh
    rec["bound_ms"], rec["bound_by"] = _bound(nbytes, ops, dtype)
    _time_kernel(kernel, rec)
    rec["plain_ms"] = time_ms(plain, iters=5)
    rec["library_ms"] = time_ms(_sdpa_decode(q, kp, vp, tables, ln))
    return rec


def check_duet(rng, label, dtype, N, ps, G, H, Dh, P, decode_rows,
               prefill_rows, bq, pad_tile=False, library=True):
    from repro_torch.kernels.duet_attention import (
        duet_attention_paged, duet_attention_paged_plain,
        duet_attention_paged_tiled_plain, paged_cluster_for)
    from repro_torch.kernels.ops import (build_duet_schedule,
                                         pack_duet_queries,
                                         unpack_duet_output)
    dev = "cuda"
    kp = torch.from_numpy(rng.standard_normal((N, ps, G, Dh), np.float32)
                          ).to(dev, dtype)
    vp = torch.from_numpy(rng.standard_normal((N, ps, G, Dh), np.float32)
                          ).to(dev, dtype)
    nslot = max(s for s, _ in decode_rows + prefill_rows) + 1
    tables = torch.tensor(1 + rng.permutation(N - 1)[:nslot * P]
                          .reshape(nslot, P), dtype=torch.int32, device=dev)
    sched = build_duet_schedule(decode_rows, prefill_rows, block_q=bq)
    rows = decode_rows + prefill_rows
    src_q = torch.from_numpy(rng.standard_normal((len(rows), H, Dh),
                                                 np.float32)).to(dev, dtype)
    q = pack_duet_queries(sched, src_q)
    row_pos = torch.tensor(sched.row_pos, device=dev)
    tile_slot = torch.tensor(sched.tile_slot, device=dev)
    if pad_tile:     # one more tile of pad rows on a -1 slot
        q = torch.cat([q, torch.ones_like(q[:bq])])
        row_pos = torch.cat([row_pos, torch.full_like(row_pos[:bq], -1)])
        tile_slot = torch.cat([tile_slot, torch.full_like(tile_slot[:1],
                                                          -1)])
    q, row_pos = q.contiguous(), row_pos[:, None].contiguous()
    kernel = lambda: duet_attention_paged(  # noqa: E731
        q, row_pos, tile_slot, kp, vp, tables, block_q=bq)
    plain = lambda: duet_attention_paged_plain(  # noqa: E731
        q, row_pos, tile_slot, kp, vp, tables, block_q=bq)
    C = paged_cluster_for(q, tile_slot, kp, tables)
    label += f" C={C}"
    rec = {"name": "duet_attention_paged", "case": label,
           "dtype": str(dtype)}
    out = kernel()
    torch.cuda.synchronize()
    got = unpack_duet_output(sched, out[:len(sched.row_src)], len(rows))
    want = unpack_duet_output(sched, plain()[:len(sched.row_src)],
                              len(rows))
    tol = ATTN_BF16_TOL if dtype == torch.bfloat16 else None
    _check("duet_attention_paged", got, want, dtype, label, rec, tol)
    # the algorithm the kernel runs: roles, C spans of 64-key units, the
    # rank-order combine
    err = rec["max_abs_err"]
    _check("duet_attention_paged", got, unpack_duet_output(
        sched, duet_attention_paged_tiled_plain(
            q, row_pos, tile_slot, kp, vp, tables, block_q=bq,
            cluster=C)[:len(sched.row_src)], len(rows)), dtype,
        label + " (tiles)", rec, tol)
    rec["max_abs_err"] = max(err, rec["max_abs_err"])
    # pad rows come out as zeros
    if torch.count_nonzero(out[row_pos[:, 0] < 0]):
        raise AssertionError(f"duet_attention_paged [{label}]: pad rows "
                             "are not zeros")
    elt = q.element_size()
    chain = {}
    for s, p in rows:
        chain[s] = max(chain.get(s, 0), p + 1)
    kv_tokens = sum(chain.values())
    nbytes = (2 * len(rows) * H * Dh * elt + 2 * kv_tokens * G * Dh * elt
              + tables.numel() * 4 + 4 * (len(rows) + len(sched.tile_slot)))
    ops = 4.0 * H * Dh * sum(p + 1 for _, p in rows)
    rec["bound_ms"], rec["bound_by"] = _bound(nbytes, ops, dtype)
    _time_kernel(kernel, rec)
    rec["plain_ms"] = time_ms(plain, iters=3)
    if not library:      # its head-repeated chains would not fit the card
        rec["library_ms"] = float("nan")
        return rec
    # library yardstick: SDPA with one query row per batch entry over
    # its gathered, head-repeated chain, masked causally by row position
    R = len(rows)
    slots = torch.tensor([s for s, _ in rows], device=dev).long()
    pos = torch.tensor([p for _, p in rows], device=dev)
    chains = tables.long()[slots]
    k = kp[chains].reshape(R, P * ps, G, Dh).repeat_interleave(
        H // G, dim=2).transpose(1, 2)
    v = vp[chains].reshape(R, P * ps, G, Dh).repeat_interleave(
        H // G, dim=2).transpose(1, 2)
    mask = (torch.arange(P * ps, device=dev)[None, :]
            <= pos[:, None])[:, None, None, :]
    qq = src_q[:, :, None, :]
    fn = torch.nn.functional.scaled_dot_product_attention
    rec["library_ms"] = time_ms(lambda: fn(qq, k, v, attn_mask=mask))
    del k, v
    return rec


def check_duet_slab(rng, label, dtype, Ns, S, G, H, Dh, decode_rows,
                    prefill_rows, bq, block_k=128):
    from repro_torch.kernels.duet_attention import (duet_attention,
                                                    duet_attention_plain)
    from repro_torch.kernels.ops import (build_duet_schedule,
                                         pack_duet_queries,
                                         unpack_duet_output)
    dev = "cuda"
    ks = torch.from_numpy(rng.standard_normal((Ns, S, G, Dh), np.float32)
                          ).to(dev, dtype)
    vs = torch.from_numpy(rng.standard_normal((Ns, S, G, Dh), np.float32)
                          ).to(dev, dtype)
    sched = build_duet_schedule(decode_rows, prefill_rows, block_q=bq)
    rows = decode_rows + prefill_rows
    src_q = torch.from_numpy(rng.standard_normal((len(rows), H, Dh),
                                                 np.float32)).to(dev, dtype)
    q = pack_duet_queries(sched, src_q).contiguous()
    row_pos = torch.tensor(sched.row_pos, device=dev)[:, None].contiguous()
    tile_slot = torch.tensor(sched.tile_slot, device=dev)
    kernel = lambda: duet_attention(  # noqa: E731
        q, row_pos, tile_slot, ks, vs, block_q=bq, block_k=block_k)
    plain = lambda: duet_attention_plain(  # noqa: E731
        q, row_pos, tile_slot, ks, vs, block_q=bq)
    from repro_torch.kernels.duet_attention import cluster_for, slab_role
    label += f" C={cluster_for(q, tile_slot, ks, bq)}"
    role = slab_role(bq, H // G)
    rec = {"name": "duet_attention" if role == "decode"
           else f"duet_attention[{role}]", "case": label,
           "dtype": str(dtype)}
    got = unpack_duet_output(sched, kernel(), len(rows))
    torch.cuda.synchronize()
    want = unpack_duet_output(sched, plain(), len(rows))
    _check("duet_attention", got, want, dtype, label, rec,
           ATTN_BF16_TOL if dtype == torch.bfloat16 else None)
    elt = q.element_size()
    live = {}
    for s_, p in rows:
        live[s_] = max(live.get(s_, 0), p + 1)
    nbytes = (2 * len(rows) * H * Dh * elt
              + 2 * sum(live.values()) * G * Dh * elt
              + 4 * (len(rows) + len(sched.tile_slot)))
    ops = 4.0 * H * Dh * sum(p + 1 for _, p in rows)
    rec["bound_ms"], rec["bound_by"] = _bound(nbytes, ops, dtype)
    _time_kernel(kernel, rec)
    rec["plain_ms"] = time_ms(plain, iters=3)
    # library yardstick: SDPA with one query row per batch entry over its
    # slot's head-repeated slab row, masked causally by row position
    slots = torch.tensor([s_ for s_, _ in rows], device=dev).long()
    pos = torch.tensor([p for _, p in rows], device=dev)
    k = ks[slots].repeat_interleave(H // G, dim=2).transpose(1, 2)
    v = vs[slots].repeat_interleave(H // G, dim=2).transpose(1, 2)
    mask = (torch.arange(S, device=dev)[None, :]
            <= pos[:, None])[:, None, None, :]
    qq = src_q[:, :, None, :]
    fn = torch.nn.functional.scaled_dot_product_attention
    rec["library_ms"] = time_ms(lambda: fn(qq, k, v, attn_mask=mask))
    del k, v
    return rec


def check_flash(rng, label, dtype, B, Sq, Sk, H, G, Dh, q_offset,
                kv_len=None):
    """flash_prefill against its plain version, timed with the plain
    version and SDPA."""
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   flash_prefill_plain)
    dev = "cuda"

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            dev, dtype)
    q, k, v = randn(B, Sq, H, Dh), randn(B, Sk, G, Dh), randn(B, Sk, G, Dh)
    kernel = lambda: flash_prefill(  # noqa: E731
        q, k, v, q_offset=q_offset, kv_len=kv_len)
    plain = lambda: flash_prefill_plain(  # noqa: E731
        q, k, v, q_offset=q_offset, kv_len=kv_len)
    rec = {"name": "flash_prefill", "case": label, "dtype": str(dtype)}
    want = plain()
    got = kernel()
    torch.cuda.synchronize()
    _check("flash_prefill", got, want, dtype, label, rec)
    del want, got
    # the work these inputs need: query i sees keys 0..min(q_offset + i,
    # kv_end - 1)
    kv_end = Sk if kv_len is None else min(Sk, kv_len)
    qpos = q_offset + np.arange(Sq)
    pairs = int(np.clip(np.minimum(qpos + 1, kv_end), 0, None).sum())
    keys = min(kv_end, q_offset + Sq)
    elt = q.element_size()
    nbytes = (2 * B * Sq * H * Dh + 2 * B * keys * G * Dh) * elt
    ops = 4.0 * B * H * Dh * pairs
    rec["bound_ms"], rec["bound_by"] = _bound(nbytes, ops, dtype)
    _time_kernel(kernel, rec)
    rec["plain_ms"] = time_ms(plain, iters=5)
    # library yardsticks: SDPA over head-repeated K/V with the
    # causal-offset (and kv_len) mask (library_ms, as for every kernel),
    # and, where the queries are the tail of the keys (q_offset = Sk - Sq,
    # no kv_len cut), SDPA with the lower-right causal bias, which SDPA
    # runs on its fused causal path without a mask (library_causal_ms)
    qq = q.transpose(1, 2)
    kk = k.repeat_interleave(H // G, dim=2).transpose(1, 2)
    vv = v.repeat_interleave(H // G, dim=2).transpose(1, 2)
    kpos = torch.arange(Sk, device=dev)
    mask = (kpos[None, :] <= torch.tensor(qpos, device=dev)[:, None]) \
        & (kpos[None, :] < kv_end)
    fn = torch.nn.functional.scaled_dot_product_attention
    rec["library_ms"] = time_ms(lambda: fn(qq, kk, vv, attn_mask=mask))
    if q_offset == Sk - Sq and kv_end == Sk:
        from torch.nn.attention.bias import causal_lower_right
        bias = causal_lower_right(Sq, Sk)
        ref = fn(qq, kk, vv, attn_mask=mask)
        alt = fn(qq, kk, vv, attn_mask=bias)
        if not torch.allclose(alt.float(), ref.float(), atol=TOL[dtype],
                              rtol=TOL[dtype]):
            raise AssertionError(f"[kernels] SDPA's lower-right causal "
                                 f"bias disagrees with its mask [{label}]")
        rec["library_causal_ms"] = time_ms(
            lambda: fn(qq, kk, vv, attn_mask=bias))
    return rec


def phase_kernels():
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import duet_block_q, num_splits_for
    rng = np.random.default_rng(0)
    records = []
    main = {}
    # the serving path's shapes: qwen3-4b heads, 8 decode slots with
    # contexts 256..2048 tokens (table bucket P=128 pages of 16), one
    # 256-row prefill chunk beside them in the duet launch
    B, H, G, Dh, ps, P = 8, 32, 8, 128, 16, 128
    lens = np.linspace(256, 2048, B).astype(np.int64)
    N = B * P + 1 + 64
    splits = num_splits_for(P, ps, 256)
    duet_bq = duet_block_q(H, G, Dh)
    for dtype in (torch.bfloat16, torch.float32):
        r = check_decode(rng, "main B=8 ctx 256-2048", dtype, B, H, G, Dh, N,
                         ps, P, lengths=lens, distinct=True)
        records.append(r)
        r = check_decode(rng, f"main B=8 ctx 256-2048 S={splits}", dtype, B,
                         H, G, Dh, N, ps, P, splits=splits, lengths=lens,
                         distinct=True)
        records.append(r)
        decode_rows = [(b, int(lens[b]) - 1) for b in range(B)]
        prefill_rows = [(B, 512 + i) for i in range(256)]
        # the async engine's tiles (64 // rep rows: decode rows on the
        # decode core, chunk tiles on the prefill block)
        r = check_duet(rng, f"main 8 decode + 256-row chunk bq={duet_bq}",
                       dtype, (B + 1) * P + 1, ps, G, H, Dh, P, decode_rows,
                       prefill_rows, bq=duet_bq)
        records.append(r)
        # the slab decode step: 8 decode rows (block_q 1) over the engine's
        # slab (8 slots x 1024), contexts 256..1000
        slab_rows = [(b, int(c) - 1) for b, c in
                     enumerate(np.linspace(256, 1000, B).astype(np.int64))]
        records.append(check_duet_slab(
            rng, "main slab 8 decode ctx 256-1000", dtype, B, 1024, G, H,
            Dh, slab_rows, [], bq=1))
        # a slab prefill chunk's shapes: 256 queries at offset 512
        records.append(check_flash(
            rng, "main Sq 256 @ 512, Sk 768", dtype, 1, 256, 768, H, G, Dh,
            512))
        if dtype == torch.bfloat16:      # the serving path's working type
            for rec in records[-5:]:
                main[rec["name"]] = rec
        # the reference's layout, one row a tile
        records.append(check_duet(
            rng, "main 8 decode + 256-row chunk bq=1", dtype,
            (B + 1) * P + 1, ps, G, H, Dh, P, decode_rows, prefill_rows,
            bq=1))
        # a whole 4096-token prompt, and the last 512-token chunk of one
        records.append(check_flash(
            rng, "long Sq 4096 @ 0, Sk 4096", dtype, 1, 4096, 4096, H, G, Dh,
            0))
        records.append(check_flash(
            rng, "chunk Sq 512 @ 3584, Sk 4096", dtype, 1, 512, 4096, H, G,
            Dh, 3584))
        records.append(check_flash(
            rng, "ragged Sq 100 @ 200, Sk 300, kv_len 250", dtype, 2, 100,
            300, H, G, Dh, 200, kv_len=250))
    # the kernel tests' shapes: GQA / MQA / MHA, odd lengths, dead splits
    for dtype in (torch.float32, torch.bfloat16):
        for (Bs, Hs, Gs, Ds, Ns, pss, Ps) in [(2, 4, 2, 64, 16, 16, 4),
                                               (3, 8, 1, 128, 32, 16, 6),
                                               (2, 4, 4, 64, 16, 8, 5)]:
            records.append(check_decode(
                rng, f"sweep B{Bs} H{Hs} G{Gs} Dh{Ds} ps{pss} P{Ps}", dtype,
                Bs, Hs, Gs, Ds, Ns, pss, Ps))
        for (Bs, Hs, Gs, Ds, Ns, pss, Ps, S, ln) in [
                (2, 4, 2, 64, 16, 16, 4, 2, None),
                (2, 4, 2, 64, 16, 16, 5, 2, None),
                (3, 8, 1, 128, 32, 16, 6, 3, None),
                (2, 8, 2, 64, 16, 8, 6, 4, None),
                (2, 4, 2, 64, 16, 8, 1, 4, None),
                (2, 4, 2, 64, 16, 8, 4, 2, (16, 32)),
                (2, 4, 2, 64, 16, 8, 4, 4, (1, 31))]:
            records.append(check_decode(
                rng, f"splitkv B{Bs} H{Hs} G{Gs} P{Ps} S{S} lens {ln}",
                dtype, Bs, Hs, Gs, Ds, Ns, pss, Ps, splits=S, lengths=ln))
        for bq in (1, 4):
            records.append(check_duet(
                rng, f"mixed phases bq={bq}", dtype, 40, 16, 2, 4, 64, 8,
                [(0, 100), (1, 57), (2, 127)],
                [(3, 64 + i) for i in range(20)], bq=bq))
        for bq in (1, 8):
            records.append(check_duet_slab(
                rng, f"slab mixed phases bq={bq}", dtype, 4, 256, 2, 4, 64,
                [(0, 100), (1, 57), (2, 200)],
                [(3, 64 + i) for i in range(20)], bq=bq))
        for (Bs, Sq, Sk, Hs, Gs, Ds, off, kvl) in [
                (1, 128, 128, 4, 2, 64, 0, None),
                (2, 128, 256, 4, 4, 64, 128, None),
                (1, 256, 256, 8, 2, 128, 0, None),
                (1, 128, 128, 4, 1, 64, 0, None),
                (1, 77, 200, 4, 2, 64, 100, 150),
                # the bf16 kernel's tile edges: one query, rows that end
                # mid-block (Sq * rep not a multiple of 64 or 128), keys
                # that end mid-tile (Sk not a multiple of 64), kv_len
                # inside a tile, rep 8 and 64, Dh 32, no valid key at all
                (1, 1, 33, 32, 8, 128, 32, None),
                (2, 45, 130, 32, 8, 128, 85, 100),
                (1, 200, 200, 8, 1, 32, 0, None),
                (1, 67, 129, 64, 1, 64, 62, None),
                (1, 16, 64, 4, 2, 64, 0, 0)]:
            records.append(check_flash(
                rng, f"sweep B{Bs} Sq{Sq} Sk{Sk} H{Hs} G{Gs} Dh{Ds} "
                f"off{off} kv_len {kvl}", dtype, Bs, Sq, Sk, Hs, Gs, Ds, off,
                kv_len=kvl))
    # the cluster kernels' edges: one request or row (C = 8), 32 of them
    # (C = 1 or 2), lengths 1, 16, 17 and 2048, Dh 64 / 128 / 256, slab
    # tiles of block_q 1 and 8
    edge = (1, 16, 17, 2048)
    edge_rows = [(0, 0), (1, 15), (2, 16), (3, 2047)]
    chunk = [(3, 64 + i) for i in range(20)]
    for dtype in (torch.float32, torch.bfloat16):
        for (Bs, Hs, Gs, Ds, ln) in [(1, 32, 8, 128, (2048,)),
                                     (1, 32, 8, 128, (1,)),
                                     (4, 32, 8, 128, edge),
                                     (32, 32, 8, 128, edge * 8),
                                     (4, 8, 2, 64, edge),
                                     (4, 8, 4, 256, edge),
                                     (2, 8, 2, 256, (17, 128))]:
            records.append(check_decode(
                rng, f"edge B{Bs} H{Hs} G{Gs} Dh{Ds} lens {ln[:4]}", dtype,
                Bs, Hs, Gs, Ds, 257, 16, 128, lengths=ln))
        for (bq, drows, prows, S, Hs, Gs, Ds) in [
                (1, [(0, 1000)], [], 1024, 32, 8, 128),
                (1, [(b, (0, 15, 16, 1023)[b % 4]) for b in range(32)], [],
                 1024, 32, 8, 128),
                (1, edge_rows, [], 2048, 8, 2, 64),
                (1, edge_rows, [], 2048, 8, 4, 256),
                (8, edge_rows[:3], chunk, 256, 4, 2, 128),
                (8, edge_rows[:3], chunk, 256, 4, 2, 256)]:
            records.append(check_duet_slab(
                rng, f"edge bq={bq} {len(drows)} decode + {len(prows)} "
                f"S{S} H{Hs} G{Gs} Dh{Ds}", dtype,
                max(s_ for s_, _ in drows + prows) + 1, S, Gs, Hs, Ds, drows,
                prows, bq=bq))
    # the paged duet kernel's tiles at full width (the CPU tile tests'
    # edges): decode contexts 1, 16, 17 and 2048, chunks of 20 and 1 rows
    # (one at position 0), pages of 8, 16 and 32, a pad tile, Dh 64 and
    # 128, and enough tiles for C = 8, 4, 2 and 1
    def edge_rows(n):
        return [(b, (0, 15, 16, 2047)[b % 4]) for b in range(n)]
    for dtype in (torch.float32, torch.bfloat16):
        for (nd, chunk_rows, pss, Ds, pad) in [
                (1, 16, 32, 128, True),     # 3 tiles: C = 8
                (4, 20, 16, 128, False),    # C = 4
                (4, 1, 8, 128, True),       # a one-row chunk at position 0
                (14, 20, 16, 128, False),   # 16 tiles: C = 2
                (32, 20, 16, 128, True),    # 35 tiles: C = 1
                (4, 20, 16, 64, True)]:     # Dh 64
            start = 0 if chunk_rows == 1 else 64
            drows = edge_rows(nd)
            records.append(check_duet(
                rng, f"edge {nd} decode + {chunk_rows} chunk ps{pss} "
                f"Dh{Ds}{' pad tile' if pad else ''}", dtype,
                (nd + 1) * (2048 // pss) + 1, pss, G, H, Ds, 2048 // pss,
                drows, [(nd, start + i) for i in range(chunk_rows)],
                bq=duet_block_q(H, G, Ds), pad_tile=pad))
    # every GQA head shape of the registered configs at the main path's
    # shapes: the decode kernels, the slab decode and the paged duet launch
    # at each config's engine tiles (duet_block_q: 1, 8, 64, 12); then
    # flash_prefill at reps that do not divide 64, above 64 and at Dh 256,
    # and the head blocks of rep 96 and 128 through every kernel
    edge4 = edge_rows(4)
    chunk20 = [(4, 64 + i) for i in range(20)]
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        for cname in HEAD_CONFIGS:
            cfg = get_config(cname)
            Hs, Gs, Ds = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
            first = len(records)
            records.append(check_decode(
                rng, f"{cname} B=8 ctx 256-2048", dtype, B, Hs, Gs, Ds, N,
                ps, P, lengths=lens, distinct=True))
            records.append(check_decode(
                rng, f"{cname} B=8 ctx 256-2048 S={splits}", dtype, B, Hs,
                Gs, Ds, N, ps, P, splits=splits, lengths=lens,
                distinct=True))
            records.append(check_duet_slab(
                rng, f"{cname} slab 8 decode ctx 256-1000", dtype, B, 1024,
                Gs, Hs, Ds, slab_rows, [], bq=1))
            bq = duet_block_q(Hs, Gs, Ds)
            records.append(check_duet(
                rng, f"{cname} 8 decode + 256-row chunk bq={bq}", dtype,
                (B + 1) * P + 1, ps, Gs, Hs, Ds, P, decode_rows,
                prefill_rows, bq=bq, library=bf16))
            for rec in records[first:]:       # the block roles' records
                if bf16 and rec["name"].endswith("[block]"):
                    main.setdefault(rec["name"], rec)
        for (hlabel, Hs, Gs, Ds) in [("rep 3", 24, 8, 64),
                                     ("rep 5", 40, 8, 128),
                                     ("rep 48", 48, 1, 128),
                                     ("Dh 256 rep 8", 8, 1, 256),
                                     ("rep 96", 96, 1, 64),
                                     ("rep 128", 128, 1, 64)]:
            records.append(check_flash(
                rng, f"{hlabel} Sq 256 @ 512, Sk 768", dtype, 1, 256, 768,
                Hs, Gs, Ds, 512))
        for (Hs, Gs, Ds) in [(96, 1, 64), (128, 1, 64)]:
            records.append(check_decode(
                rng, f"rep {Hs} B=8 ctx 256-2048", dtype, B, Hs, Gs, Ds, N,
                ps, P, lengths=lens, distinct=True))
            records.append(check_duet_slab(
                rng, f"rep {Hs} slab 4 decode ctx 1-2048", dtype, 4, 2048,
                Gs, Hs, Ds, edge4, [], bq=1))
            records.append(check_duet(
                rng, f"rep {Hs} 4 decode + 20 chunk bq=1", dtype,
                5 * (2048 // ps) + 1, ps, Gs, Hs, Ds, 2048 // ps, edge4,
                chunk20, bq=1, pad_tile=True, library=bf16))
    card = card_line()
    for rec in records:
        log(f"[kernels] {rec['name']:27s} {rec['dtype']:15s} "
            f"{rec['case']:44s} max_abs_err={rec['max_abs_err']:.3e} "
            f"tol={rec['tol']:.0e}/{rec['rtol']:.0e} ms={rec['ms']:.4f} "
            f"cold_ms={rec['cold_ms']:.4f} "
            f"host_ms={rec['host_ms']:.4f} hold_tries="
            f"{rec['hold_tries'][0]}/{rec['hold_tries'][1]}"
            f"{'' if rec['held'] else ' (host behind the hold)'} "
            f"plain_ms={rec['plain_ms']:.4f} "
            f"library_ms={rec['library_ms']:.4f} "
            f"bound_ms={rec['bound_ms']:.3g} ({rec['bound_by']}, "
            f"{rec['bound_ms'] / rec['cold_ms']:.1%} of cold_ms)"
            + (f" library_causal_ms={rec['library_causal_ms']:.4f}"
               if "library_causal_ms" in rec else "")

            + f" [{card}]")
    report_occupancy(card)
    return main


def report_occupancy(card):
    """The cluster kernels' residency at the main path's shapes (bf16): the
    cluster size the wrappers pick, how many clusters the card holds at
    once (cudaOccupancyMaxActiveClusters) and the ring's loads that can be
    in flight per SM."""
    from repro_torch.kernels.duet_attention import cluster_for as slab_c
    from repro_torch.kernels.duet_attention import occupancy as slab_occ
    from repro_torch.kernels.paged_decode import cluster_for as paged_c
    from repro_torch.kernels.paged_decode import occupancy as paged_occ
    dev = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    B, G, rep, Dh, P, S = 8, 8, 4, 128, 128, 1024
    bf16 = torch.bfloat16
    q = torch.empty((B, G * rep, Dh), dtype=bf16, device="cuda")
    kp = torch.empty((1, 16, G, Dh), dtype=bf16, device="cuda")
    tables = torch.empty((B, P), dtype=torch.int32, device="cuda")
    ks = torch.empty((B, S, G, Dh), dtype=bf16, device="cuda")
    tiles = torch.empty((B,), dtype=torch.int32, device="cuda")
    picks = {"paged_decode": (paged_c(q, kp, tables), lambda C: paged_occ(
                 dev, bf16, Dh, rep, P, C)),
             "duet_attention": (slab_c(q, tiles, ks, 1), lambda C: slab_occ(
                 dev, bf16, Dh, rep, C))}
    from repro_torch.kernels.flash_prefill import occupancy as flash_occ
    blocks, smem = flash_occ(dev, Dh)
    log(f"[kernels] flash_prefill bf16 Dh {Dh}: {blocks} blocks of 4 warps "
        f"(64 rows, {smem / 1024:.0f} KB shared memory each) resident per "
        f"SM [{card}]")
    # granite-20b's heads (rep 48, MQA): both decode kernels' CTAs take the
    # 64-row block role
    from repro_torch.kernels.duet_attention import slab_role
    from repro_torch.kernels.ops import cta_role as paged_role
    qg = torch.empty((B, 48, Dh), dtype=bf16, device="cuda")
    kg = torch.empty((1, 16, 1, Dh), dtype=bf16, device="cuda")
    ksg = torch.empty((B, S, 1, Dh), dtype=bf16, device="cuda")
    grid = {"paged_decode": B, "duet_attention": B}
    picks["paged_decode"] += (paged_role(rep), G)
    picks["duet_attention"] += (slab_role(1, rep), G)
    picks["paged_decode granite"] = (
        paged_c(qg, kg, tables),
        lambda C: paged_occ(dev, bf16, Dh, 48, P, C), paged_role(48), 1)
    picks["duet_attention granite"] = (
        slab_c(qg, tiles, ksg, 1),
        lambda C: slab_occ(dev, bf16, Dh, 48, C), slab_role(1, 48), 1)
    for name, (C, occupancy, role, groups) in picks.items():
        clusters, smem, ahead = occupancy(C)
        per_sm = clusters * C / sms
        ctas = grid[name.split()[0]] * groups * C
        log(f"[kernels] {name} main bf16, {role} role: C={C}, grid {ctas} "
            f"CTAs of "
            f"{smem / 1024:.1f} KB shared memory; {clusters} clusters "
            f"({clusters * C} CTAs, {per_sm:.2f} per SM) resident at once; "
            f"{ahead / 1024:.0f} KB of loads ahead per CTA, up to "
            f"{min(per_sm, ctas / sms) * ahead / 1024:.0f} KB in flight "
            f"per SM [{card}]")
    # the paged duet kernel at the engine's main launch: 8 decode tiles and
    # 16 chunk tiles of 16 rows (T = 24)
    from repro_torch.kernels.duet_attention import (paged_cluster_for,
                                                    paged_occupancy)
    T = 24
    tiles = torch.empty((T,), dtype=torch.int32, device="cuda")
    C = paged_cluster_for(q, tiles, kp, tables)
    for c in sorted({1, 2, 4, 8, C}):
        clusters, smem, regs = paged_occupancy(dev, bf16, Dh, 16, P, c)
        log(f"[kernels] duet_attention_paged main bf16 C={c}"
            f"{' (the wrapper picks it)' if c == C else ''}: grid "
            f"{T * G * c} CTAs of {smem / 1024:.1f} KB shared memory, "
            f"{regs} registers a thread; {clusters} clusters "
            f"({clusters * c} CTAs, {clusters * c / sms:.2f} per SM) "
            f"resident at once [{card}]")


# ---------------------------------------------------------------------------
# phase 3: logits parity, kernel path vs plain path
# ---------------------------------------------------------------------------
def phase_parity():
    """qwen3-4b cut to 4 layers, then each served config
    beyond it cut to 2 layers (full width; the recurrent ones to
    RECURRENT_PARITY_LAYERS), fp32 with TF32 off."""
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[parity] fp32, TF32 off (matmul and cudnn)")
    parity_for("qwen3-4b", 4, flash=True)
    for name in SERVED_CONFIGS:
        cfg = get_config(name)
        if _is_gqa(cfg):
            parity_for(name, 2)
        elif cfg.kv_lora_rank:
            parity_mla(name, 2)
        else:
            parity_recurrent(name, RECURRENT_PARITY_LAYERS[name])


def _is_gqa(cfg) -> bool:
    from repro_torch.configs.base import GQA_KINDS
    return all(k in GQA_KINDS for k in cfg.block_pattern)


def _cut(name, n_layers):
    import dataclasses
    from repro_torch.configs import get_config
    full = get_config(name)
    return dataclasses.replace(full, num_layers=n_layers,
                               block_pattern=full.block_pattern[:n_layers])


def _check_parity(name, n_layers, cfg, checks):
    for what, got, want in checks:
        V = cfg.vocab_size          # padded logit columns hold finfo.min
        got, want = got[..., :V], want[..., :V]
        scale = max(1.0, want.abs().max().item())
        err = (got - want).abs().max().item()
        if not (torch.isfinite(got).all() and err <= PARITY_TOL * scale):
            raise AssertionError(f"[parity] {name} {what}: max abs err "
                                 f"{err:.3e} > {PARITY_TOL:.0e} x "
                                 f"{scale:.3g}")
        log(f"[parity] {name} ({n_layers} layers) {what}: max abs err "
            f"{err:.3e} (tol {PARITY_TOL:.0e} x max|reference| "
            f"{scale:.3g})")


def parity_mla(name, n_layers):
    """An MLA config at full width cut to ``n_layers`` layers (deepseek:
    its dense MLA layer and one MLA + MoE layer), fp32: a 200-token paged
    prefill and one paged decode step with the latent up-projections
    absorbed against expanded, then the same prompt prefilled into the
    slab and one slab decode step against the paged ones. Both prefill in
    chunks of 128 + 72, so the MoE routes the same rows together on both
    layouts."""
    from repro_torch.models import Model
    from repro_torch.serving.kvcache import PagePoolConfig, init_page_pools
    t0 = time.time()
    cfg = _cut(name, n_layers)
    expand = Model.init(cfg, seed=0, dtype=torch.float32, device="cuda")
    absorb = copy.copy(expand)       # the same weights
    absorb.mla_absorb = True
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    ps, P = 16, 16
    tbl = torch.arange(1, 1 + P, dtype=torch.int32, device=dev)[None]
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (1, 201)),
                        device=dev)
    pos = torch.tensor([200], dtype=torch.int32, device=dev)
    state = [None] * cfg.num_layers
    chunks = ((0, 128), (128, 200))   # the same rows routed on both layouts
    with torch.no_grad():
        logits, prefill = {}, {}
        for label, model in (("expand", expand), ("absorb", absorb)):
            pools = init_page_pools(cfg, PagePoolConfig(num_pages=32,
                                                        page_size=ps),
                                    torch.float32, device=dev)
            for s0, s1 in chunks:
                prefill[label], _, _ = model.prefill_paged(
                    toks[:, s0:s1], pools, state, tbl, start_pos=s0)
            logits[label], _, _ = model.decode_step_paged(
                pools, state, toks[:, 200:], pos, tbl)
        cache = expand.init_cache(1, 256)
        for s0, s1 in chunks:
            ls, _ = expand.prefill(toks[:, s0:s1], cache=cache, start_pos=s0)
        lsd, _ = expand.decode_step(cache, toks[:, 200:], pos)
    _check_parity(name, n_layers, cfg, [
        ("paged decode step, absorbed vs expanded", logits["absorb"],
         logits["expand"]),
        ("slab chunked prefill vs paged", ls, prefill["expand"]),
        ("slab decode step vs paged decode step", lsd, logits["expand"])])
    log(f"[parity] {name}: H {cfg.num_heads}, latent rank "
        f"{cfg.kv_lora_rank}, rope {cfg.qk_rope_dim}, layers "
        f"{cfg.block_pattern}, {time.time() - t0:.1f} s")
    del expand, absorb
    torch.cuda.empty_cache()


def parity_recurrent(name, n_layers):
    """A recurrent config at full width cut to ``n_layers`` layers, fp32,
    every recurrent state starting where the engines start it
    (``init_state_cache`` / ``init_cache``). With GQA layers among them
    (zamba2's shared_attn), the kernel path against the plain path: a
    200-token paged prefill, one paged decode step, and one slab decode
    step after a slab prefill in chunks of 128 + 72. Then, on the kernel
    path, a CHUNKED_PROMPT-token prompt prefilled in chunks of
    CHUNKED_CHUNK and CHUNKED_DECODE decode steps, paged and slab, each
    step's logits (and the prefill's last) against one whole prefill (no
    cache) of the same tokens: the chunked SSD and chunkwise mLSTM forms
    and the one-step recurrences across chunk edges at full width."""
    from repro_torch.configs.base import GQA_KINDS
    from repro_torch.models import Model
    from repro_torch.serving.kvcache import PagePoolConfig, init_page_pools
    t0 = time.time()
    cfg = _cut(name, n_layers)
    kern = Model.init(cfg, seed=0, dtype=torch.float32, device="cuda",
                      attn_kernel=True)
    plain = copy.copy(kern)          # the same weights, plain attention
    plain.attn_kernel = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    n = CHUNKED_PROMPT + CHUNKED_DECODE
    ps, P = 16, -(-n // 16)
    tbl = torch.arange(1, 1 + P, dtype=torch.int32, device=dev)[None]
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (1, n)), device=dev)

    def pools():
        return init_page_pools(cfg, PagePoolConfig(num_pages=P + 1,
                                                   page_size=ps),
                               torch.float32, device=dev)

    def at(p):
        return torch.tensor([p], dtype=torch.int32, device=dev)

    checks = []
    with torch.no_grad():
        if any(k in GQA_KINDS for k in cfg.block_pattern):
            got = {}
            for label, model in (("kernel", kern), ("plain", plain)):
                pl, st = pools(), model.init_state_cache(1)
                lp, _, _ = model.prefill_paged(toks[:, :200], pl, st, tbl,
                                               start_pos=0)
                ld, _, _ = model.decode_step_paged(pl, st, toks[:, 200:201],
                                                   at(200), tbl)
                cache = model.init_cache(1, 256)
                for s0, s1 in ((0, 128), (128, 200)):
                    model.prefill(toks[:, s0:s1], cache=cache, start_pos=s0)
                ls, _ = model.decode_step(cache, toks[:, 200:201], at(200))
                got[label] = (lp, ld, ls)
            checks += [(f"kernel vs plain path, {what}", k, p)
                       for what, k, p in zip(
                           ("paged prefill", "paged decode step",
                            "slab decode step"), got["kernel"],
                           got["plain"])]
        # one whole prefill (no cache) per position checked
        whole = torch.stack([kern.prefill(toks[:, :t + 1])[0][0]
                             for t in range(CHUNKED_PROMPT - 1, n)])
        chunks = [(s0, min(s0 + CHUNKED_CHUNK, CHUNKED_PROMPT))
                  for s0 in range(0, CHUNKED_PROMPT, CHUNKED_CHUNK)]
        for path in ("paged", "slab"):
            if path == "paged":
                pl, st = pools(), kern.init_state_cache(1)
                for s0, s1 in chunks:
                    last, _, _ = kern.prefill_paged(toks[:, s0:s1], pl, st,
                                                    tbl, start_pos=s0)
            else:
                cache = kern.init_cache(1, 1024)    # the engines' rows
                for s0, s1 in chunks:
                    last, _ = kern.prefill(toks[:, s0:s1], cache=cache,
                                           start_pos=s0)
            steps = [last[0]]
            for t in range(CHUNKED_PROMPT, n):
                if path == "paged":
                    lg, _, _ = kern.decode_step_paged(
                        pl, st, toks[:, t:t + 1], at(t), tbl)
                else:
                    lg, _ = kern.decode_step(cache, toks[:, t:t + 1], at(t))
                steps.append(lg[0])
            checks.append((
                f"{path}: chunks {[s1 - s0 for s0, s1 in chunks]} + "
                f"{len(steps) - 1} decode steps vs whole prefills "
                f"(positions {CHUNKED_PROMPT - 1}..{n - 1})",
                torch.stack(steps), whole))
    _check_parity(name, n_layers, cfg, checks)
    log(f"[parity] {name}: layers {cfg.block_pattern}, "
        f"{time.time() - t0:.1f} s")
    del kern, plain
    torch.cuda.empty_cache()


def parity_for(name, n_layers, flash=False):
    """The kernel path's logits against the plain path's on one config at
    full width cut to ``n_layers`` layers: a paged prefill, a paged decode
    step, a duet step at one row a tile (qwen3-4b) and at the async
    engine's tiles, and a slab decode step after a chunked slab prefill;
    with ``flash``, flash_prefill on gqa_prefill's q/K/V against
    gqa_prefill's own attention. An MoE config's duet checks run at
    capacity factor 64 (see below); its other checks at its own."""
    import dataclasses
    from repro_torch.kernels import build_duet_schedule
    from repro_torch.kernels.ops import duet_block_q
    from repro_torch.models import Model
    from repro_torch.serving.kvcache import PagePoolConfig, init_page_pools
    t0 = time.time()
    cfg = _cut(name, n_layers)
    kern = Model.init(cfg, seed=0, dtype=torch.float32, device="cuda",
                      attn_kernel=True)
    plain = copy.copy(kern)          # the same weights, plain attention
    plain.attn_kernel = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    ps, P = 16, 16
    pool = PagePoolConfig(num_pages=64, page_size=ps)

    def fresh():
        return init_page_pools(cfg, pool, torch.float32, device=dev)

    tblA = torch.arange(1, 1 + P, dtype=torch.int32, device=dev)[None]
    tblB = torch.arange(1 + P, 1 + 2 * P, dtype=torch.int32,
                        device=dev)[None]
    toksA = torch.tensor(rng.integers(0, cfg.vocab_size, (1, 200)),
                         device=dev)
    toksB = torch.tensor(rng.integers(0, cfg.vocab_size, (1, 64)),
                         device=dev)
    tok = torch.tensor(rng.integers(0, cfg.vocab_size, (1, 1)), device=dev)
    pos = torch.tensor([200], dtype=torch.int32, device=dev)
    state = [None] * cfg.num_layers

    def prefilled():
        pools = fresh()
        plain.prefill_paged(toksA, pools, state, tblA, start_pos=0)
        return pools

    engine_bq = duet_block_q(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    # the duet step against the sequential decode + prefill pair: a duet
    # step routes its decode and chunk rows through the MoE together, the
    # pair apart, so the two agree only where the capacity drops nothing
    dkern, dplain, dnote = kern, plain, ""
    if cfg.is_moe:
        wide = dataclasses.replace(cfg, capacity_factor=64.0)
        dkern, dplain = copy.copy(kern), copy.copy(plain)
        dkern.cfg = dplain.cfg = wide
        dnote = " (MoE capacity factor 64)"
    own = {}                # an MoE's duet step and pair at its capacity
    with torch.no_grad():
        lpk, _, _ = kern.prefill_paged(toksA, fresh(), state, tblA,
                                       start_pos=0)
        lpp, _, _ = plain.prefill_paged(toksA, fresh(), state, tblA,
                                        start_pos=0)
        lk, _, _ = kern.decode_step_paged(prefilled(), state, tok, pos, tblA)
        lp, _, _ = plain.decode_step_paged(prefilled(), state, tok, pos,
                                           tblA)
        C = toksB.shape[1]
        row_tok = torch.cat([tok[:, 0], toksB[0]])[:, None]
        row_pos = torch.cat([pos, torch.arange(C, dtype=torch.int32,
                                               device=dev)])
        row_tbl = torch.cat([tblA, tblB.expand(C, P)])
        duet = {}
        # the reference's tiles (one row each; qwen3-4b) and the async
        # engine's
        for bq in sorted({engine_bq} | ({1} if flash else set())):
            sched = build_duet_schedule([(0, 200)],
                                        [(1, i) for i in range(C)],
                                        block_q=bq)
            order = torch.tensor(sched.row_src, device=dev)
            duet[bq], _, _ = dkern.duet_step_paged(
                prefilled(), state, row_tok, row_pos, row_tbl, order,
                block_q=bq)
            if cfg.is_moe:
                own["duet"], _, _ = kern.duet_step_paged(
                    prefilled(), state, row_tok, row_pos, row_tbl, order,
                    block_q=bq)
        seq_pools = prefilled()
        ls_dec, _, _ = dplain.decode_step_paged(seq_pools, state, tok, pos,
                                                tblA)
        ls_pre, _, _ = dplain.prefill_paged(toksB, seq_pools, state, tblB,
                                            start_pos=0)
        if cfg.is_moe:
            seq_pools = prefilled()
            own["dec"], _, _ = plain.decode_step_paged(seq_pools, state, tok,
                                                       pos, tblA)
            own["pre"], _, _ = plain.prefill_paged(toksB, seq_pools, state,
                                                   tblB, start_pos=0)
        # slab: two slots, 200-token prompts prefilled in chunks of 128 +
        # 72, then one decode step of both
        toks2 = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 201)),
                             device=dev)

        def slab_prefilled():
            cache = plain.init_cache(2, 256)
            for s0, s1 in ((0, 128), (128, 200)):
                plain.prefill(toks2[:, s0:s1], cache=cache, start_pos=s0)
            return cache
        tok2 = toks2[:, 200:]
        pos2 = torch.full((2,), 200, dtype=torch.int32, device=dev)
        lsk, _ = kern.decode_step(slab_prefilled(), tok2, pos2)
        lsp, _ = plain.decode_step(slab_prefilled(), tok2, pos2)
        checks = [("paged prefill", lpk, lpp), ("decode step", lk, lp)]
        for bq, ld in duet.items():
            checks += [(f"duet step bq={bq}, decode row{dnote}", ld[0],
                        ls_dec[0]),
                       (f"duet step bq={bq}, last chunk row{dnote}", ld[C],
                        ls_pre[0])]
        checks.append(("slab decode step", lsk, lsp))
        if flash:
            # flash_prefill's contract: on gqa_prefill's own q/K/V it gives
            # gqa_prefill's attention (the reference's tests/test_kernels.py)
            from repro_torch.kernels import flash_prefill
            from repro_torch.models import attention as attn_mod
            p0 = kern.params["layers"][0]["attn"]
            x = torch.from_numpy(rng.standard_normal(
                (1, 256, cfg.d_model), np.float32)).to(dev)
            positions = torch.arange(256, device=dev)[None]
            out_model, cache = attn_mod.gqa_prefill(p0, cfg, x, positions)
            q, _, _ = attn_mod._project_qkv(p0, cfg, x, positions)
            out_kernel = torch.einsum("bshe,hed->bsd", flash_prefill(
                q.contiguous(), cache.k.contiguous(), cache.v.contiguous()),
                p0["w_o"])
            checks.append(("flash_prefill on gqa_prefill's q/K/V "
                           "(attention output)", out_kernel, out_model))
    _check_parity(name, n_layers, cfg, checks)
    if cfg.is_moe:
        # not held: at the config's own capacity the two route other rows
        # together, so their drops differ (as in the reference)
        V = cfg.vocab_size
        for what, got, want in (("decode row", own["duet"][0], own["dec"][0]),
                                ("last chunk row", own["duet"][C],
                                 own["pre"][0])):
            log(f"[parity] {name}: duet step vs the sequential pair at "
                f"capacity factor {cfg.capacity_factor}, {what}: max abs "
                f"diff {(got[:V] - want[:V]).abs().max().item():.3e} "
                "(not held: the MoE routes other rows together)")
    log(f"[parity] {name}: H {cfg.num_heads} G {cfg.num_kv_heads} Dh "
        f"{cfg.head_dim}, duet tiles of {engine_bq} rows, "
        f"{time.time() - t0:.1f} s")
    del kern, plain
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: full-width serving through the engines
# ---------------------------------------------------------------------------
def _requests(path, n=None, max_output=None):
    """The serve phase's azure-conv requests (8, qps 4, seed 0, clamped to
    max_len 1024). The qwen3-4b paged path's three runs serve those of at
    most PAGED_MAX_OUTPUT output tokens (4 of the 8), which halves their
    decode steps, its slab path all 8; a served config's runs take the
    first ``n`` with outputs cut to ``max_output`` tokens."""
    from repro_torch.launch.serve import _clamp_lengths
    from repro_torch.serving.traces import synth_trace
    reqs = _clamp_lengths(synth_trace("azure-conv", 8, 4.0, seed=0), 1024,
                          True)
    if n is not None:
        reqs = reqs[:n]
        for r in reqs:
            r.output_len = min(r.output_len, max_output)
    elif path == "paged":
        reqs = [r for r in reqs if r.output_len <= PAGED_MAX_OUTPUT]
    return reqs


def _serve_run(label, cls, model, reqs, card, extra):
    """One engine run at max_slots 8, max_len 1024, token budget 256, with
    the kernels on and strict; every request must finish with tokens in the
    vocabulary, the async engine must keep host_syncs <= super_iterations
    and, on the paged path, dispatch a fused duet step where the engine
    fuses them (GQA blocks) and none where it does not (MLA). Returns the
    greedy streams."""
    from repro_torch.kernels import launch_counts
    from repro_torch.serving import AsyncDuetEngine, EngineConfig
    cfg = model.cfg
    ec = EngineConfig(max_slots=8, max_len=1024, token_budget=256,
                      strict_kernel=True, **extra)
    engine = cls(model, ec, seed=0, device="cuda")
    before = launch_counts()
    engine.submit(reqs)
    torch.cuda.synchronize()
    t0 = time.time()
    metrics = engine.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    after = launch_counts()
    summ = metrics.summary()
    n_tok = sum(len(r.output_tokens) for r in metrics.requests)
    if summ["num_finished"] != len(reqs):
        raise AssertionError(f"[serve] {label}: "
                             f"{summ['num_finished']}/{len(reqs)} "
                             "requests finished")
    for r in metrics.requests:
        if len(r.output_tokens) != r.output_len or not all(
                0 <= t < cfg.vocab_size for t in r.output_tokens):
            raise AssertionError(f"[serve] {label}: request "
                                 f"{r.rid} produced bad tokens")
    if engine.kernel_path != "cuda":
        raise AssertionError(f"[serve] {label}: kernel_path "
                             f"{engine.kernel_path}")
    line = (f"[serve] {label}: {len(reqs)} requests, {n_tok} tokens "
            f"in {wall:.2f} s wall = {n_tok / wall:.1f} tokens/s "
            f"measured on the card [{card}]; launches "
            f"{ {k: after[k] - before[k] for k in after} }")
    if cls is AsyncDuetEngine:
        st = engine.dstats
        if not 0 < st.host_syncs <= st.super_iterations:
            raise AssertionError(
                f"[serve] {label}: host_syncs {st.host_syncs} > "
                f"super_iterations {st.super_iterations}")
        line += (f"; super_iterations {st.super_iterations}, "
                 f"host_syncs {st.host_syncs}")
        if ec.paged:
            duet = sum(1 for k in engine._programs if k[-1])
            launched = after["duet_attention_paged"] - \
                before["duet_attention_paged"]
            if engine._duet_kernel and (duet == 0 or launched == 0):
                raise AssertionError(f"[serve] {label}: no duet "
                                     "dispatch")
            if not engine._duet_kernel and (duet or launched):
                raise AssertionError(f"[serve] {label}: a duet dispatch "
                                     "on a config the engine does not "
                                     "fuse")
            line += f", duet buckets {duet}"
    log(line)
    log(f"[serve] {label}: virtual-clock summary (TPU v5e roofline "
        f"prediction, not a card measurement): mean TTFT "
        f"{summ['mean_ttft_s']} s, mean TBT {summ['mean_tbt_s']} s")
    del engine
    torch.cuda.empty_cache()
    return {r.rid: list(r.output_tokens) for r in metrics.requests}


def _path_counts(path, counts, cfg, split_kv=False):
    """Read a path's launches (reset just before it), add them to
    ``counts`` and fail if a kernel of the path, of the role the config's
    rep takes (split-KV where ``split_kv``), never launched. A config
    with GQA layers among others (zamba2's shared_attn beside Mamba2)
    runs the decode kernels but no fused duet step, so its paths must not
    launch ``duet_attention_paged``; a config without GQA layers (MLA,
    xLSTM) runs no kernel, so its paths must launch none."""
    from repro_torch.configs.base import GQA_KINDS
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.ops import cta_role
    got = launch_counts()
    log(f"[serve] {path} path launches: {got}")
    gqa = any(k in GQA_KINDS for k in cfg.block_pattern)
    fused = _is_gqa(cfg)
    block = cta_role(cfg.num_heads // cfg.num_kv_heads) == "block"
    for name, n in got.items():
        counts[name] = counts.get(name, 0) + n
        needed = (gqa and PATH_OF.get(name) == path.split()[-1]
                  and (fused if name == "duet_attention_paged"
                       else name.endswith("[block]") == block)
                  and (split_kv or "splitkv" not in name))
        if needed and n <= 0:
            raise AssertionError(f"[serve] kernel {name} was never "
                                 f"launched on the {path} path")
        if n and (not gqa or (name == "duet_attention_paged"
                              and not fused)):
            raise AssertionError(f"[serve] kernel {name} launched {n} "
                                 f"times on the path {path}, which must "
                                 "not launch it")


def phase_serve():
    from repro_torch.configs import get_config
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import Model
    from repro_torch.serving import AsyncDuetEngine, DuetEngine
    cfg = get_config("qwen3-4b")
    t0 = time.time()
    model = Model.init(cfg, seed=0, dtype=torch.bfloat16, device="cuda",
                       attn_kernel=True)
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, bf16 weights "
        f"{sum(b.numel() for b in model.buffers()) * 2 / 1e9:.2f} GB, "
        f"random from seed 0 in {time.time() - t0:.1f} s")
    card = card_line()
    paths = {
        "paged": [("async", AsyncDuetEngine, {}),
                  ("sync", DuetEngine, {}),
                  ("async split_kv_threshold=256", AsyncDuetEngine,
                   {"split_kv_threshold": 256})],
        "slab": [("slab sync", DuetEngine, {"paged": False}),
                 ("slab async", AsyncDuetEngine, {"paged": False})],
    }
    outputs, counts = {}, {}
    for path, runs in paths.items():
        reset_launch_counts()        # this path's launches start here
        for label, cls, extra in runs:
            outputs[label] = _serve_run(label, cls, model, _requests(path),
                                        card, extra)
        # this path's launches end here
        _path_counts(path, counts, cfg, split_kv=path == "paged")
    if counts["flash_prefill"] != 0:
        raise AssertionError("[serve] flash_prefill launched "
                             f"{counts['flash_prefill']} times on a serving "
                             "path (the reference serves without it)")
    for a_label, b_label in (("async", "sync"), ("slab async", "slab sync"),
                             ("slab sync", "sync")):
        a, b = outputs[a_label], outputs[b_label]
        a = {r: a[r] for r in b if r in a}     # the paged path serves fewer
        same = sum(a[r] == b[r] for r in a)
        first = {r: next((i for i, (x, y) in enumerate(zip(a[r], b[r]))
                          if x != y), None) for r in a}
        log(f"[serve] {a_label} vs {b_label} greedy streams identical for "
            f"{same}/{len(a)} requests (bf16; the kernels differ in "
            f"summation order); first differing token index per request: "
            f"{first}")
    for slab in (False, True):
        profile_decode(model, card, slab)
    profile_duet(model, card)
    del model
    torch.cuda.empty_cache()
    for name in SERVED_CONFIGS:
        serve_config(name, counts, card)
    if counts["flash_prefill"] != 0:
        raise AssertionError("[serve] flash_prefill launched on a served "
                             "config's path")
    serve_slot_reuse(card)
    return counts


def serve_slot_reuse(card):
    """Slot reuse on the card: zamba2 at full width cut to its first
    REUSE_LAYERS layers, fp32 with TF32 off, the sync engine on the paged
    path (kernels on, strict) at REUSE_SLOTS slots serves SERVE_REQUESTS
    requests of at most REUSE_MAX_OUTPUT output tokens, so later requests
    take slots that earlier ones left; each request's greedy stream must
    equal the same request served alone on a fresh engine of the same
    geometry (the chunk boundaries may differ between the two, which is
    why this runs in fp32). The engines reset a slot's recurrent state
    when a prefill starts at position 0; without it a request would start
    from its slot's last occupant's state. Launches here come after the
    main path's counts were read."""
    from repro_torch.models import Model
    from repro_torch.serving import DuetEngine, EngineConfig
    t0 = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _cut("zamba2-1.2b", REUSE_LAYERS)
    model = Model.init(cfg, seed=0, dtype=torch.float32, device="cuda",
                       attn_kernel=True)
    ec = EngineConfig(max_slots=REUSE_SLOTS, max_len=1024, token_budget=256,
                      strict_kernel=True)

    def serve(reqs):
        engine = DuetEngine(model, ec, seed=0, device="cuda")
        engine.submit(reqs)
        metrics = engine.run()
        if metrics.summary()["num_finished"] != len(reqs):
            raise AssertionError("[serve] slot reuse: a request did not "
                                 "finish")
        return {r.rid: list(r.output_tokens) for r in metrics.requests}

    def reqs():
        return _requests("paged", SERVE_REQUESTS, REUSE_MAX_OUTPUT)

    together = serve(reqs())
    alone = {}
    for i in range(SERVE_REQUESTS):
        alone.update(serve(reqs()[i:i + 1]))
    first = {r: next((i for i, (x, y) in enumerate(zip(together[r],
                                                        alone[r]))
                      if x != y), None) for r in alone}
    log(f"[serve] slot reuse: zamba2 cut to {REUSE_LAYERS} layers "
        f"({cfg.block_pattern.count('shared_attn')} shared_attn), fp32, "
        f"sync paged, {SERVE_REQUESTS} requests on {REUSE_SLOTS} slots "
        f"(outputs {[len(t) for t in together.values()]}) against each "
        f"served alone: first differing token index per request {first} "
        f"[{card}], {time.time() - t0:.1f} s")
    if together != alone:
        raise AssertionError("[serve] slot reuse: a request's greedy stream "
                             "differs from the one it gives alone")
    del model
    torch.cuda.empty_cache()


def serve_config(name, counts, card):
    """One served config at full depth, bf16, random weights from seed 0
    (``Model.init`` draws each leaf on the card, in fp32, and casts it
    before the next, so the peak stays near the weights' own bytes), alone
    on the card: a paged run through the async engine (the fused duet
    kernel on for GQA configs) and a slab run through the async engine,
    each path's launch counts reset just before it and read just after,
    SERVE_REQUESTS requests of at most SERVE_MAX_OUTPUT output tokens; the
    peak allocated memory after both runs; an MoE config with GQA blocks
    (granite-moe) and the recurrent configs then profile one paged decode
    step. A recurrent config also prints its per-slot state bytes."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RECURRENT_KINDS
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.ops import duet_block_q
    from repro_torch.models import Model
    from repro_torch.serving import AsyncDuetEngine
    cfg = get_config(name)
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    model = Model.init(cfg, seed=0, dtype=torch.bfloat16, device="cuda",
                       attn_kernel=True)
    torch.cuda.synchronize()
    nbytes = sum(b.numel() * b.element_size() for b in model.buffers())
    gqa = _is_gqa(cfg)
    recurrent = [k for k in cfg.block_pattern if k in RECURRENT_KINDS]
    if gqa:
        bq = duet_block_q(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        heads = (f"G {cfg.num_kv_heads} Dh {cfg.head_dim}, duet tiles of "
                 f"{bq} rows")
    elif cfg.kv_lora_rank:
        heads = (f"MLA latent rank {cfg.kv_lora_rank} + rope "
                 f"{cfg.qk_rope_dim}, no duet kernel")
    else:
        state = sum(t.numel() * t.element_size()
                    for c in model.init_state_cache(1) if c is not None
                    for t in c)
        kinds = {k: cfg.block_pattern.count(k)
                 for k in dict.fromkeys(cfg.block_pattern)}
        heads = (f"G {cfg.num_kv_heads} Dh {cfg.head_dim}; layers {kinds}"
                 f" (SSM heads {cfg.ssm_heads} x {cfg.ssm_head_dim}, state "
                 f"{cfg.ssm_state})" if "mamba2" in kinds else
                 f"G {cfg.num_kv_heads}; layers {kinds}")
        heads += (f"; recurrent state {state} bytes a slot ({state / 1e6:.2f}"
                  f" MB over {len(recurrent)} layers, "
                  f"{8 * state / 1e6:.1f} MB for 8 slots); no duet kernel")
    moe = (f"; MoE {cfg.num_experts} experts top-{cfg.moe_top_k} width "
           f"{cfg.moe_d_ff}, {cfg.num_shared_experts} shared"
           if cfg.is_moe else "")
    log(f"[serve] {name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"H {cfg.num_heads} {heads}{moe}; bf16 weights {nbytes / 1e9:.3f} "
        f"GB on the card ({nbytes} bytes), random from seed 0 in "
        f"{time.time() - t0:.1f} s, peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]")
    for path, extra in (("paged", {}), ("slab", {"paged": False})):
        reset_launch_counts()        # this path's launches start here
        label = f"{name} {'slab ' if extra else ''}async"
        _serve_run(label, AsyncDuetEngine, model,
                   _requests(path, SERVE_REQUESTS, SERVE_MAX_OUTPUT), card,
                   extra)
        _path_counts(f"{name} {path}", counts, cfg)
    log(f"[serve] {name}: peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB over the weights "
        f"and both runs (max_slots 8, max_len 1024) [{card}]")
    if (cfg.is_moe and gqa) or recurrent:
        profile_decode(model, card, slab=False, top=14)
    del model
    torch.cuda.empty_cache()


def profile_decode(model, card, slab: bool, top: int = 8):
    """Where one full-width decode step's time goes: 8 slots at 1000 tokens
    of context through the kernel path (paged pool, or slab cache with the
    engine's 1024-token rows), timed on the host clock without the
    profiler, then traced with torch.profiler for the device time by
    kernel. Device busy share = summed kernel time / wall time. A config
    with recurrent layers also lists the top aten ops by device time and
    profiles the step again without the inactive-slot freeze (no
    ``active_mask``: no ``where`` over the recurrent state), to read what
    the freeze costs. Launches made here come after the main path's counts
    were read."""
    from repro_torch.core.lookahead import lookahead_decode
    from repro_torch.models.transformer import RECURRENT
    from repro_torch.serving.kvcache import PagePoolConfig, init_page_pools
    cfg, B, P, ps, steps = model.cfg, 8, 64, 16, 4
    pos = torch.full((B,), 1000, dtype=torch.int32, device="cuda")
    tok = torch.zeros((B, 1), dtype=torch.int32, device="cuda")
    if slab:
        cache = model.init_cache(B, 1024)
        active = torch.ones((B,), dtype=torch.bool, device="cuda")

        def step():   # the engine's slab step: decode + inactive freeze
            lookahead_decode(model, cache, tok, pos, 1, active_mask=active)
    else:
        pools = init_page_pools(cfg, PagePoolConfig(num_pages=B * P + 1,
                                                    page_size=ps),
                                torch.bfloat16, device="cuda")
        tables = torch.arange(1, B * P + 1, dtype=torch.int32,
                              device="cuda").reshape(B, P)
        state = model.init_state_cache(B)
        active = torch.ones((B,), dtype=torch.bool, device="cuda")

        def step(mask=active):   # the engine's paged step: decode + freeze
            model.decode_step_paged(pools, state, tok, pos, tables,
                                    active_mask=mask)

    def run(**kw):
        for _ in range(steps):
            step(**kw)
        torch.cuda.synchronize()

    what = (f"{cfg.name} {'slab' if slab else 'paged'} decode step, "
            f"{cfg.num_layers} layers, B={B}, ctx 1000, bf16")
    wall, events, ops = _profile(run, steps)
    log_profile(what, wall, events, steps, card, top=top)
    if slab or not any(k in RECURRENT for k in cfg.block_pattern):
        return
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile]   {e.self_device_time_total / steps / 1e3:8.3f} "
            f"ms/step  {e.count // steps:5d} calls/step  {e.key} (aten op)")
    wall0, events0, _ = _profile(lambda: run(mask=None), steps)
    dev = sum(e.self_device_time_total for e in events) / steps / 1e3
    dev0 = sum(e.self_device_time_total for e in events0) / steps / 1e3
    log(f"[profile] {what}: the inactive-slot freeze of the recurrent "
        f"state (its torch.where) adds {dev - dev0:.3f} ms of device time a "
        f"step ({dev:.3f} with it, {dev0:.3f} without) and "
        f"{wall - wall0:.2f} ms of wall ({wall:.2f} / {wall0:.2f}) "
        f"[{card}]")


def log_profile(what, wall, events, steps, card, extra="", top=8):
    """Print a profiled step: wall ms, device kernel ms and busy share, the
    kernels (and copies) launched a step, and the ``top`` kernels with the
    most device time."""
    dev = sum(e.self_device_time_total for e in events) / steps / 1e3
    launched = sum(e.count for e in events) // steps
    busy = (f"{dev:.2f} ms/step (torch.profiler); device busy "
            f"{100 * dev / wall:.1f}%; {launched} kernels a step" if dev > 0
            else "not measured (the profiler recorded no device time)")
    log(f"[profile] {what}: wall {wall:.2f} ms/step (host clock, no "
        f"profiler); device kernel time {busy}{extra} [{card}]")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile]   {e.self_device_time_total / steps / 1e3:8.3f} "
            f"ms/step  {e.count // steps:5d} calls/step  {e.key[:70]}")


def _profile(run, steps):
    """(wall ms per step on the host clock without the profiler, device
    kernel events of a traced run, the run's aten ops that launched
    device work) of ``run``, which does ``steps`` steps and
    synchronises."""
    from torch.profiler import ProfilerActivity, profile
    run()
    t0 = time.time()
    run()
    wall = (time.time() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    cuda = torch.autograd.DeviceType.CUDA
    averages = prof.key_averages()
    return wall, [e for e in averages if e.device_type == cuda], [
        e for e in averages if e.device_type != cuda
        and e.key.startswith("aten::") and e.self_device_time_total > 0]


def profile_duet(model, card):
    """Where one fused duet super-iteration's time goes: the async engine's
    program for kb = 1 and a 256-row chunk (8 decode slots at 1000 tokens
    of context, the chunk at positions 512..767 of a ninth request; bf16,
    the engine's tiles of 64 // rep rows), timed on the host clock without
    the profiler, then traced for the device time by kernel and the duet
    kernel's share."""
    from repro_torch.core.lookahead import make_superiter_fn
    from repro_torch.kernels.ops import build_duet_schedule, duet_block_q
    from repro_torch.serving.kvcache import PagePoolConfig, init_page_pools
    cfg, B, P, ps, chunk, steps = model.cfg, 8, 64, 16, 256, 4
    dev = "cuda"
    bq = duet_block_q(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    prog = make_superiter_fn(model, 1, paged=True, chunk=chunk,
                             duet_kernel=True, duet_block_q=bq)
    pools = init_page_pools(cfg, PagePoolConfig(num_pages=(B + 1) * P + 1,
                                                page_size=ps),
                            torch.bfloat16, device=dev)
    tables = torch.arange(1, B * P + 1, dtype=torch.int32,
                          device=dev).reshape(B, P)
    pre_tbl = torch.arange(B * P + 1, (B + 1) * P + 1, dtype=torch.int32,
                           device=dev)[None]
    sched = build_duet_schedule([(b, 0) for b in range(B)],
                                [(B, i) for i in range(chunk)], block_q=bq)
    order = torch.tensor(sched.row_src, dtype=torch.int32, device=dev)
    last_tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    pos = torch.full((B,), 1000, dtype=torch.int32, device=dev)
    pre_toks = torch.zeros((1, chunk), dtype=torch.int32, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = model.init_state_cache(B)

    def run():
        for _ in range(steps):
            prog(pools, state, last_tok, pos, tables, gen, active, pre_toks,
                 pre_tbl, 512, 0, 0, order)
        torch.cuda.synchronize()

    wall, events, _ = _profile(run, steps)
    duet = [e for e in events if "duet_attention_paged" in e.key]
    duet_ms = sum(e.self_device_time_total for e in duet) / steps / 1e3
    calls = sum(e.count for e in duet) // steps
    log_profile(f"duet super-iteration, {cfg.num_layers} layers, B={B} at "
                f"ctx 1000 + a {chunk}-row chunk at 512, kb=1, bq={bq}, "
                f"bf16", wall, events, steps, card,
                f"; duet_attention_paged {duet_ms:.3f} ms/step over {calls} "
                f"calls ({duet_ms / max(calls, 1):.4f} ms a call)")


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's smoke test "
              "needs one card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    import repro_torch  # noqa: F401  (fails outside the repository)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} card {torch.cuda.get_device_name(0)}")
    t0 = time.time()
    main_rec, counts = {}, {}
    for phase in (p for p in PHASES if p in phases):
        t_phase = time.time()
        if phase == "build":
            phase_build()
        elif phase == "kernels":
            main_rec = phase_kernels()
        elif phase == "parity":
            phase_parity()
        elif phase == "serve":
            counts = phase_serve()
        log(f"[time] {phase} phase {time.time() - t_phase:.1f} s")
    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        rec = main_rec.get(name, {})
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": counts[name] if counts else None,
            "max_abs_err": rec.get("max_abs_err"), "ms": rec.get("ms"),
            "cold_ms": rec.get("cold_ms"), "plain_ms": rec.get("plain_ms"),
            "bound_ms": rec.get("bound_ms"),
            "bound_by": rec.get("bound_by"),
            "library_ms": rec.get("library_ms")})
    log(f"[done] {time.time() - t0:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
