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
             edges, against both its plain versions, pad rows zero).
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
             (the paged duet kernel's at C = 1, 2, 4, 8 with registers).
3. parity  — full-width qwen3-4b cut to 4 layers, fp32 with TF32 off: the
             kernel path's logits against the port's plain path for one
             paged decode step, one duet step (one row a tile and the
             engine's tiles), and one slab decode step
             after a chunked slab prefill; and flash_prefill on the port's
             gqa_prefill q/K/V against gqa_prefill's own attention.
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
             chunk), with the duet kernel's share.

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
# the paged duet kernel in bf16, (atol, rtol): its errors are the bf16
# rounding of the output (an ulp) and of P before P V (about 2^-9 of a
# key's weight times |v|, at most ~3e-3 on rows of a few keys); the
# CPU decomposition tests read at most 0.62 of this limit
DUET_BF16_TOL = (5e-3, 1e-2)
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
# the serving path that must launch each kernel; flash_prefill is on none
# (the reference calls it only from its tests), and its count must read 0
PATH_OF = {"paged_decode": "paged", "paged_decode_splitkv": "paged",
           "duet_attention_paged": "paged", "duet_attention": "slab"}
PAGED_MAX_OUTPUT = 160      # see phase_serve's requests()


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
    rec = {"name": name, "case": label, "dtype": str(dtype)}
    got = kernel()
    torch.cuda.synchronize()
    if splits is not None:
        # the algorithm the kernel runs: the live pages in C = S spans
        C = splitkv_spans(P, splits)[0]
        _check(name, got, paged_decode_cluster_plain(
            q, kp, vp, tables, ln, cluster=C), dtype, label + " (spans)",
            rec)
        span_err = rec["max_abs_err"]
    _check(name, got, plain(), dtype, label, rec)
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
               prefill_rows, bq, pad_tile=False):
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
    tol = DUET_BF16_TOL if dtype == torch.bfloat16 else None
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
    from repro_torch.kernels.duet_attention import cluster_for
    label += f" C={cluster_for(q, tile_slot, ks, bq)}"
    rec = {"name": "duet_attention", "case": label, "dtype": str(dtype)}
    got = unpack_duet_output(sched, kernel(), len(rows))
    torch.cuda.synchronize()
    want = unpack_duet_output(sched, plain(), len(rows))
    _check("duet_attention", got, want, dtype, label, rec)
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
    card = card_line()
    for rec in records:
        log(f"[kernels] {rec['name']:22s} {rec['dtype']:15s} "
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
    for name, (C, occupancy) in picks.items():
        clusters, smem, ahead = occupancy(C)
        per_sm = clusters * C / sms
        log(f"[kernels] {name} main bf16: C={C}, grid {B * G * C} CTAs of "
            f"{smem / 1024:.1f} KB shared memory; {clusters} clusters "
            f"({clusters * C} CTAs, {per_sm:.2f} per SM) resident at once; "
            f"{ahead / 1024:.0f} KB of loads ahead per CTA, up to "
            f"{min(per_sm, B * G * C / sms) * ahead / 1024:.0f} KB in flight "
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
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import build_duet_schedule
    from repro_torch.kernels.ops import duet_block_q
    from repro_torch.models import Model
    from repro_torch.serving.kvcache import PagePoolConfig, init_page_pools
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[parity] fp32, TF32 off (matmul and cudnn)")
    full = get_config("qwen3-4b")
    cfg = dataclasses.replace(full, num_layers=4,
                              block_pattern=full.block_pattern[:4])
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

    with torch.no_grad():
        lk, _, _ = kern.decode_step_paged(prefilled(), state, tok, pos, tblA)
        lp, _, _ = plain.decode_step_paged(prefilled(), state, tok, pos,
                                           tblA)
        C = toksB.shape[1]
        row_tok = torch.cat([tok[:, 0], toksB[0]])[:, None]
        row_pos = torch.cat([pos, torch.arange(C, dtype=torch.int32,
                                               device=dev)])
        row_tbl = torch.cat([tblA, tblB.expand(C, P)])
        duet = {}
        # the reference's tiles (one row each) and the async engine's
        for bq in (1, duet_block_q(cfg.num_heads, cfg.num_kv_heads,
                                   cfg.head_dim)):
            sched = build_duet_schedule([(0, 200)],
                                        [(1, i) for i in range(C)],
                                        block_q=bq)
            order = torch.tensor(sched.row_src, device=dev)
            duet[bq], _, _ = kern.duet_step_paged(
                prefilled(), state, row_tok, row_pos, row_tbl, order,
                block_q=bq)
        seq_pools = prefilled()
        ls_dec, _, _ = plain.decode_step_paged(seq_pools, state, tok, pos,
                                               tblA)
        ls_pre, _, _ = plain.prefill_paged(toksB, seq_pools, state, tblB,
                                           start_pos=0)
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
        # flash_prefill's contract: on gqa_prefill's own q/K/V it gives
        # gqa_prefill's attention (the reference's tests/test_kernels.py)
        from repro_torch.kernels import flash_prefill
        from repro_torch.models import attention as attn_mod
        p0 = kern.params["layers"][0]["attn"]
        x = torch.from_numpy(rng.standard_normal((1, 256, cfg.d_model),
                                                 np.float32)).to(dev)
        positions = torch.arange(256, device=dev)[None]
        out_model, cache = attn_mod.gqa_prefill(p0, cfg, x, positions)
        q, _, _ = attn_mod._project_qkv(p0, cfg, x, positions)
        out_kernel = torch.einsum("bshe,hed->bsd", flash_prefill(
            q.contiguous(), cache.k.contiguous(), cache.v.contiguous()),
            p0["w_o"])
    checks = [("decode step", lk, lp)]
    for bq, ld in duet.items():
        checks += [(f"duet step bq={bq}, decode row", ld[0], ls_dec[0]),
                   (f"duet step bq={bq}, last chunk row", ld[C], ls_pre[0])]
    for name, got, want in checks + [
                            ("slab decode step", lsk, lsp),
                            ("flash_prefill on gqa_prefill's q/K/V "
                             "(attention output)", out_kernel, out_model)]:
        V = cfg.vocab_size          # padded logit columns hold finfo.min
        got, want = got[..., :V], want[..., :V]
        scale = max(1.0, want.abs().max().item())
        err = (got - want).abs().max().item()
        if not (torch.isfinite(got).all() and err <= PARITY_TOL * scale):
            raise AssertionError(f"[parity] {name}: max abs err {err:.3e} > "
                                 f"{PARITY_TOL:.0e} x {scale:.3g}")
        log(f"[parity] {name}: max abs err {err:.3e} "
            f"(tol {PARITY_TOL:.0e} x max|reference| {scale:.3g})")
    del kern, plain
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: full-width serving through the engines
# ---------------------------------------------------------------------------
def phase_serve():
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import _clamp_lengths
    from repro_torch.models import Model
    from repro_torch.serving import (AsyncDuetEngine, DuetEngine,
                                     EngineConfig)
    from repro_torch.serving.traces import synth_trace
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

    def requests(path):
        reqs = _clamp_lengths(synth_trace("azure-conv", 8, 4.0, seed=0),
                              1024, True)
        # the paged path's three runs serve the trace's requests of at most
        # PAGED_MAX_OUTPUT output tokens (4 of the 8), which halves their
        # decode steps; the slab path serves all 8
        if path == "paged":
            reqs = [r for r in reqs if r.output_len <= PAGED_MAX_OUTPUT]
        return reqs

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
            ec = EngineConfig(max_slots=8, max_len=1024, token_budget=256,
                              strict_kernel=True, **extra)
            engine = cls(model, ec, seed=0, device="cuda")
            before = launch_counts()
            reqs = requests(path)
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
                if path == "paged":
                    duet = sum(1 for k in engine._programs if k[-1])
                    if duet == 0 or after["duet_attention_paged"] == \
                            before["duet_attention_paged"]:
                        raise AssertionError(f"[serve] {label}: no duet "
                                             "dispatch")
                    line += f", duet buckets {duet}"
            log(line)
            outputs[label] = {r.rid: list(r.output_tokens)
                              for r in metrics.requests}
            log(f"[serve] {label}: virtual-clock summary (TPU v5e roofline "
                f"prediction, not a card measurement): mean TTFT "
                f"{summ['mean_ttft_s']} s, mean TBT {summ['mean_tbt_s']} s")
            del engine
            torch.cuda.empty_cache()
        got = launch_counts()        # this path's launches end here
        log(f"[serve] {path} path launches: {got}")
        for name, n in got.items():
            counts[name] = counts.get(name, 0) + n
            if PATH_OF.get(name) == path and n <= 0:
                raise AssertionError(f"[serve] kernel {name} was never "
                                     f"launched on the {path} path")
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
    return counts


def profile_decode(model, card, slab: bool):
    """Where one full-width decode step's time goes: 8 slots at 1000 tokens
    of context through the kernel path (paged pool, or slab cache with the
    engine's 1024-token rows), timed on the host clock without the
    profiler, then traced with torch.profiler for the device time by
    kernel. Device busy share = summed kernel time / wall time. Launches
    made here come after the main path's counts were read."""
    from repro_torch.core.lookahead import lookahead_decode
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

        def step():
            model.decode_step_paged(pools, state, tok, pos, tables)

    def run():
        for _ in range(steps):
            step()
        torch.cuda.synchronize()

    wall, events = _profile(run, steps)
    log_profile(f"{'slab' if slab else 'paged'} decode step, "
                f"{cfg.num_layers} layers, B={B}, ctx 1000, bf16", wall,
                events, steps, card)


def log_profile(what, wall, events, steps, card, extra=""):
    """Print a profiled step: wall ms, device kernel ms and busy share, and
    the 8 kernels with the most device time."""
    dev = sum(e.self_device_time_total for e in events) / steps / 1e3
    busy = (f"{dev:.2f} ms/step (torch.profiler); device busy "
            f"{100 * dev / wall:.1f}%" if dev > 0 else
            "not measured (the profiler recorded no device time)")
    log(f"[profile] {what}: wall {wall:.2f} ms/step (host clock, no "
        f"profiler); device kernel time {busy}{extra} [{card}]")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[profile]   {e.self_device_time_total / steps / 1e3:8.3f} "
            f"ms/step  {e.count // steps:5d} calls/step  {e.key[:70]}")


def _profile(run, steps):
    """(wall ms per step on the host clock without the profiler, device
    kernel events of a traced run) of ``run``, which does ``steps`` steps
    and synchronises."""
    from torch.profiler import ProfilerActivity, profile
    run()
    t0 = time.time()
    run()
    wall = (time.time() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    return wall, [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]


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

    wall, events = _profile(run, steps)
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
