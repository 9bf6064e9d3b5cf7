"""Paged decode attention: CUDA kernels for Hopper + their plain versions.

One new query token per request attends over its paged KV cache
(PagedAttention layout: pages (N, page_size, G, Dh) + per-request block
tables).

Replaces the Pallas TPU kernels of ``src/repro/kernels/paged_decode.py``:

* :func:`paged_decode` — ``paged_decode`` (``_kernel``): sequential page
  walk, one running (m, l, acc) per request.
* :func:`paged_decode_splitkv` — ``paged_decode_splitkv``
  (``_splitkv_kernel``): flash decoding, each request's page chain split
  into ``num_splits`` contiguous spans with their own (m, l, acc).

Kernel source: ``csrc/paged_decode.cu`` (design notes there). Bound on an
H100: memory — each live KV byte is read once at 3.35 TB/s; the arithmetic
(4 FLOP per KV element) is far below the card's ridge. The plain walk has
one block per (request, KV group), which leaves most SMs idle at small
batch; the split-KV variant multiplies the blocks by the split count and
pays a second launch (the log-sum-exp combine) because blocks on the card
run in no order and cannot carry partials from one to the next.

On a CPU tensor each wrapper runs its plain PyTorch version; on a CUDA
tensor it launches the kernel or raises. :data:`launches` counts kernel
launches per wrapper (one per call; the split-KV call is two launches and
counts once).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.ops import (DENOM_EPS, MASKED_M_THRESHOLD, NEG_INF,
                                     default_sm_scale, gqa_repeat_kv)

launches = {"paged_decode": 0, "paged_decode_splitkv": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_QUERY_ROWS = 16      # query rows of one block (csrc: 4 warps x 4 rows)


# ---------------------------------------------------------------------------
# plain versions (CPU tests; chip_smoke.py compares the kernels with them)
# ---------------------------------------------------------------------------
# the gathered-chain oracle: gather every table page, mask tok < lengths,
# fp32 softmax
paged_decode_plain = _ref.paged_decode_ref


def splitkv_spans(num_pages: int, num_splits: int):
    """(S, pages per split, pad pages): the table splits into S contiguous
    spans of ``pps`` pages, the last padded with null pages."""
    S = max(1, min(num_splits, num_pages))
    pps = -(-num_pages // S)
    return S, pps, S * pps - num_pages


def paged_decode_splitkv_plain(q, k_pages, v_pages, tables, lengths, *,
                               num_splits: int):
    """The split-KV algorithm in plain PyTorch: per-split (m, l, acc)
    partials with the dead-split guard, then the log-sum-exp combine."""
    B, H, Dh = q.shape
    N, ps, G, _ = k_pages.shape
    rep = H // G
    S, pps, pad = splitkv_spans(tables.shape[1], num_splits)
    tbl = torch.nn.functional.pad(tables.long(), (0, pad))    # null pages
    L = pps * ps
    k = gqa_repeat_kv(k_pages[tbl].reshape(B, S, L, G, Dh), rep).float()
    v = gqa_repeat_kv(v_pages[tbl].reshape(B, S, L, G, Dh), rep).float()
    s = torch.einsum("bhd,bslhd->bshl", q.float(), k) * default_sm_scale(Dh)
    tok = torch.arange(S * L, device=q.device).reshape(S, L)
    valid = tok[None, :, None, :] < lengths[:, None, None, None]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)                                       # (B,S,H)
    live = m > MASKED_M_THRESHOLD
    p = torch.where(live[..., None], torch.exp(s - m[..., None]),
                    torch.zeros_like(s))
    l_part = p.sum(dim=-1)
    acc = torch.einsum("bshl,bslhd->bshd", p, v)
    m_star = m.amax(dim=1, keepdim=True)
    w = torch.where(live, torch.exp(m - m_star), torch.zeros_like(m))
    l_star = (w * l_part).sum(dim=1)                          # (B,H)
    out = (acc * w[..., None]).sum(dim=1)
    return (out / l_star.clamp(min=DENOM_EPS)[..., None]).to(q.dtype)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------
def _check_inputs(q, k_pages, v_pages, tables, lengths):
    B, H, Dh = q.shape
    N, ps, G, Dk = k_pages.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_decode: unsupported dtype {q.dtype}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != q.dtype or t.shape != k_pages.shape:
            raise ValueError(f"paged_decode: {name} must be {q.dtype} "
                             f"{tuple(k_pages.shape)}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("tables", tables), ("lengths", lengths)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"paged_decode: {name} is not on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_decode: {name} is not contiguous")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_decode: tables and lengths must be int32")
    if Dk != Dh or Dh not in (32, 64, 128, 256) or H % G:
        raise ValueError(f"paged_decode: unsupported H={H} G={G} Dh={Dh}")
    if H // G > MAX_QUERY_ROWS:
        raise ValueError(f"paged_decode: rep={H // G} > {MAX_QUERY_ROWS}")
    if tables.shape[0] != B or lengths.shape != (B,):
        raise ValueError("paged_decode: tables (B,P) / lengths (B,) mismatch")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_decode: page pools must be 16-byte aligned")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_paged_decode(q, k_pages, v_pages, tables, lengths):
    _check_inputs(q, k_pages, v_pages, tables, lengths)
    B, H, Dh = q.shape
    _, ps, G, _ = k_pages.shape
    out = torch.empty_like(q)
    lib = _build.load("paged_decode")
    err = lib.paged_decode_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, H, G, Dh, ps, tables.shape[1], default_sm_scale(Dh),
        _DTYPES[q.dtype], _stream(q))
    _build.check(err, "paged_decode")
    launches["paged_decode"] += 1
    return out


def _launch_splitkv(q, k_pages, v_pages, tables, lengths, num_splits):
    _check_inputs(q, k_pages, v_pages, tables, lengths)
    B, H, Dh = q.shape
    _, ps, G, _ = k_pages.shape
    P = tables.shape[1]
    S, _, _ = splitkv_spans(P, num_splits)
    m_part = torch.empty((B, S, H), dtype=torch.float32, device=q.device)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((B, S, H, Dh), dtype=torch.float32,
                           device=q.device)
    out = torch.empty_like(q)
    lib = _build.load("paged_decode")
    err = lib.paged_decode_partials_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), m_part.data_ptr(),
        l_part.data_ptr(), acc_part.data_ptr(), B, H, G, Dh, ps, P, S,
        default_sm_scale(Dh), _DTYPES[q.dtype], _stream(q))
    _build.check(err, "paged_decode_splitkv partials")
    err = lib.paged_decode_combine_launch(
        m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
        out.data_ptr(), B, H, Dh, S, _DTYPES[q.dtype], _stream(q))
    _build.check(err, "paged_decode_splitkv combine")
    launches["paged_decode_splitkv"] += 1
    return out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def paged_decode(q, k_pages, v_pages, tables, lengths):
    """q (B,H,Dh); k/v_pages (N,ps,G,Dh); tables (B,P) int32 page ids;
    lengths (B,) int32 true context lengths (>= 1). Returns (B,H,Dh).

    Unused table slots must point at a valid (e.g. null) page — they are
    masked by ``lengths``.
    """
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pages, v_pages, tables, lengths)
    return _launch_paged_decode(q, k_pages, v_pages, tables, lengths)


def paged_decode_splitkv(q, k_pages, v_pages, tables, lengths, *,
                         num_splits: int):
    """Flash-decoding variant of :func:`paged_decode`: same contract; the
    page walk is partitioned into ``num_splits`` contiguous spans of the
    block table whose (m, l, acc) partials are LSE-combined."""
    if q.device.type == "cpu":
        return paged_decode_splitkv_plain(q, k_pages, v_pages, tables,
                                          lengths, num_splits=num_splits)
    return _launch_splitkv(q, k_pages, v_pages, tables, lengths, num_splits)
