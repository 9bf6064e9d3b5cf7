"""Causal GQA flash attention for prefill: a CUDA kernel for Hopper + its
plain versions.

Replaces the Pallas TPU kernel ``flash_prefill`` of
``src/repro/kernels/flash_prefill.py`` (``_kernel``). Query i sits at
absolute position ``q_offset + i``, so chunked prefill (queries are the
tail of the key range) uses the same kernel; ``kv_len`` masks padded keys
beyond the true length.

Kernel source: ``csrc/flash_prefill.cu`` (design notes there). A block of
query rows — (position, head) pairs of one KV group, so the rep heads
share every K/V tile — loops over the KV tiles up to its causal limit, so
Sq and Sk need not divide by any block size (the Pallas kernel wants
multiples of 128). Bound on an H100: operations (4 * Dh flops per valid
(query head, key) pair at 989 bf16 TFLOP/s). bf16 runs on the tensor
cores (``mma.sync``, FlashAttention-2 style: blocks of 64 rows, 64-key
K/V tiles through a ``cp.async`` ring, the online softmax in registers);
:func:`flash_prefill_tiled_plain` is that schedule in plain PyTorch. fp32 has no tensor-core type of its precision
and runs FMAs on the CUDA cores in blocks of 64 rows.

A query row with no valid key (only possible with ``kv_len`` <= 0) comes
out as zeros here and in the plain versions. On a CPU tensor the wrapper
runs :func:`flash_prefill_plain`; on a CUDA tensor it launches the kernel
or raises. :data:`launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ops import (DENOM_EPS, MASKED_M_THRESHOLD, NEG_INF,
                                     default_sm_scale, gqa_split_heads)

launches = {"flash_prefill": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROWS = 64     # query rows (positions x heads of one group) a block (csrc)
BLOCK_N = 64  # keys a K/V tile of the bf16 kernel (csrc BN)
LOG2E = 1.4426950408889634


def flash_prefill_plain(q, k, v, *, q_offset: int = 0,
                        kv_len: Optional[int] = None):
    """Plain PyTorch version: fp32 scores of each query head against its
    group's keys, the causal-offset and ``kv_len`` masks, softmax, and the
    probability-weighted sum of V."""
    B, Sq, H, Dh = q.shape
    Sk, G = k.shape[1], k.shape[2]
    kv_end = Sk if kv_len is None else min(Sk, int(kv_len))
    qg = gqa_split_heads(q.float(), G)                       # (B,Sq,G,r,D)
    s = torch.einsum("bsgrd,btgd->bgrst", qg, k.float()) * \
        default_sm_scale(Dh)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    mask = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < kv_end)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(dim=-1)[:, None], p, torch.zeros_like(p))
    out = torch.einsum("bgrst,btgd->bsgrd", p, v.float())
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def flash_prefill_tiled_plain(q, k, v, *, q_offset: int = 0,
                              kv_len: Optional[int] = None):
    """The bf16 kernel's schedule in plain PyTorch: each KV group's rows
    packed as (position, head) pairs, :data:`ROWS` rows a block, each block
    walking :data:`BLOCK_N`-key tiles up to its causal limit (its last
    position's) with the online softmax in the log2 domain, P rounded to
    q's type before P V (fp32 accumulation), ``acc / max(l, DENOM_EPS)``
    at the end. Rows and keys may end mid-block."""
    B, Sq, H, Dh = q.shape
    Sk, G = k.shape[1], k.shape[2]
    rep = H // G
    kv_end = Sk if kv_len is None else max(0, min(Sk, int(kv_len)))
    bq = ROWS // rep
    qs = default_sm_scale(Dh) * LOG2E
    rows = gqa_split_heads(q, G).permute(0, 2, 1, 3, 4).reshape(
        B, G, Sq * rep, Dh).float()
    kg = k.permute(0, 2, 1, 3).float()                  # (B, G, Sk, Dh)
    vg = v.permute(0, 2, 1, 3).float()
    out = torch.zeros_like(rows)
    for q0 in range(0, Sq, bq):
        n = min(bq, Sq - q0)
        pos = q_offset + torch.arange(q0, q0 + n, device=q.device)
        lim = pos.clamp(max=kv_end - 1).repeat_interleave(rep)   # (R,)
        r = rows[:, :, q0 * rep:(q0 + n) * rep]
        m = torch.full(r.shape[:3], NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(r)
        for k0 in range(0, max(0, min(kv_end, q_offset + q0 + n)), BLOCK_N):
            keys = torch.arange(k0, min(k0 + BLOCK_N, Sk), device=q.device)
            s = r @ kg[:, :, keys].transpose(-1, -2)
            s = torch.where(keys[None, :] <= lim[:, None], s,
                            torch.full_like(s, NEG_INF))
            mx = torch.maximum(m, s.amax(dim=-1))
            msc = torch.where(mx > MASKED_M_THRESHOLD, mx * qs,
                              torch.zeros_like(mx))
            alpha = torch.exp2(m * qs - msc)
            p = torch.exp2(s * qs - msc[..., None]).to(q.dtype).float()
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + p @ vg[:, :, keys]
            m = mx
        out[:, :, q0 * rep:(q0 + n) * rep] = \
            acc / l.clamp(min=DENOM_EPS)[..., None]
    return out.reshape(B, G, Sq, rep, Dh).permute(0, 2, 1, 3, 4).reshape(
        B, Sq, H, Dh).to(q.dtype)


@functools.lru_cache(maxsize=None)
def occupancy(device: int, Dh: int):
    """(blocks of the bf16 kernel an SM holds at once, shared memory bytes
    per block) for head dim ``Dh``
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor; a host query)."""
    res = (ctypes.c_int * 2)()
    with torch.cuda.device(device):
        err = _build.load("flash_prefill").flash_prefill_occupancy(
            Dh, ctypes.addressof(res))
    _build.check(err, "flash_prefill occupancy")
    return tuple(res)


def _launch(q, k, v, q_offset, kv_len):
    B, Sq, H, Dh = q.shape
    _, Sk, G, Dk = k.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_prefill: unsupported dtype {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.shape != k.shape:
            raise ValueError(f"flash_prefill: {name} must be {q.dtype} "
                             f"{tuple(k.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_prefill: {name} is not on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_prefill: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_prefill: {name} is not 16-byte aligned")
    if k.shape[0] != B or Dk != Dh or Dh not in (32, 64, 128) or H % G \
            or ROWS % (H // G):
        raise ValueError(f"flash_prefill: unsupported B={B} H={H} G={G} "
                         f"Dh={Dh}")
    if q_offset < 0:
        raise ValueError(f"flash_prefill: q_offset {q_offset} < 0")
    kv_end = Sk if kv_len is None else max(0, min(Sk, int(kv_len)))
    out = torch.empty_like(q)
    lib = _build.load("flash_prefill")
    err = lib.flash_prefill_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk,
        H, G, Dh, int(q_offset), kv_end, default_sm_scale(Dh),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_prefill")
    launches["flash_prefill"] += 1
    return out


def flash_prefill(q, k, v, *, q_offset: int = 0,
                  kv_len: Optional[int] = None):
    """q (B,Sq,H,Dh); k,v (B,Sk,G,Dh); returns (B,Sq,H,Dh).

    ``q_offset`` (int) shifts query positions for chunked prefill;
    ``kv_len`` masks out padded keys beyond the true length. H % G == 0.
    """
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, q_offset=q_offset, kv_len=kv_len)
    return _launch(q, k, v, q_offset, kv_len)
