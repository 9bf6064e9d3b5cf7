"""Causal GQA flash attention for prefill: a CUDA kernel for Hopper + its
plain version.

Replaces the Pallas TPU kernel ``flash_prefill`` of
``src/repro/kernels/flash_prefill.py`` (``_kernel``). Query i sits at
absolute position ``q_offset + i``, so chunked prefill (queries are the
tail of the key range) uses the same kernel; ``kv_len`` masks padded keys
beyond the true length.

Kernel source: ``csrc/flash_prefill.cu`` (design notes there). One block
per (query block, KV group, batch) loops over the KV tiles up to its causal
limit, so Sq and Sk need not divide by any block size (the Pallas kernel
wants multiples of 128). Bound on an H100: operations at the serving
path's chunk shapes (4 * Dh flops per valid (query head, key) pair at
989 bf16 TFLOP/s); this first kernel runs fp32 FMAs on the CUDA cores.

A query row with no valid key (only possible with ``kv_len`` <= 0) comes
out as zeros here and in the plain version. On a CPU tensor the wrapper
runs the plain version; on a CUDA tensor it launches the kernel or raises.
:data:`launches` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ops import (NEG_INF, default_sm_scale,
                                     gqa_split_heads)

launches = {"flash_prefill": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROWS = 64     # query rows (positions x heads of one group) per block (csrc)


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
