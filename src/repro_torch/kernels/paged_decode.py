"""Paged decode attention: a CUDA kernel for Hopper + its plain versions.

One new query token per request attends over its paged KV cache
(PagedAttention layout: pages (N, page_size, G, Dh) + per-request block
tables).

Replaces the Pallas TPU kernels of ``src/repro/kernels/paged_decode.py``:

* :func:`paged_decode` — ``paged_decode`` (``_kernel``): sequential page
  walk, one running (m, l, acc) per request.
* :func:`paged_decode_splitkv` — ``paged_decode_splitkv``
  (``_splitkv_kernel``): flash decoding, each request's page chain split
  into ``num_splits`` contiguous spans with their own (m, l, acc).

Kernel source: ``csrc/paged_decode.cu`` (design notes there and in
``csrc/decode_core.cuh``). Bound on an H100: memory — each live KV byte is
read once at 3.35 TB/s; the arithmetic (4 FLOP per KV element) is far
below the card's ridge. Both wrappers are one launch of the same cluster
kernel: each (request, KV group) owns a cluster of C CTAs, each walking
one span of the request's live pages through a cp.async ring, combined
through distributed shared memory. :func:`paged_decode` picks C with
:func:`~repro_torch.kernels.ops.cluster_size` on the host (no device
read): the most CTAs the card runs in one wave, capped at 8 and at the
table's width. :func:`paged_decode_splitkv` launches C = ``num_splits``
(the caller's static choice, at most 8, ``ops.CLUSTER_MAX``; clamped to
the table's width as the reference clamps it): its splits are the cluster's spans of the live pages, so the partials
never reach HBM. :func:`paged_decode_cluster_plain` is that span split in
plain PyTorch; :func:`paged_decode_splitkv_plain` is the reference's split
of the whole table, the CPU path.

A group of more than 16 query heads (rep > 16: granite-20b's 48) does not
fit the decode core's row buckets; its CTAs take the "block" role
(:func:`~repro_torch.kernels.ops.cta_role`): a 64-row block over the same
kind of spans, with the same combine, and head blocks of at most 64 heads
(:func:`~repro_torch.kernels.ops.head_split`) above rep 64. In bf16 at Dh
64-256 over tables of at least 2048 keys it is the warpgroup block of
``csrc/wg_block.cuh`` (wgmma, the pages copied by TMA onto an mbarrier
ring; clusters of up to 16 where they give at most 64 CTAs, granite-20b's
batches of up to 4, else of up to 8: ``ops.cluster_cap``;
:func:`paged_decode_block_plain` is its walk in plain PyTorch), else the
block of ``csrc/prefill_core.cuh`` (:func:`paged_engine`). The role and
block follow rep, dtype, Dh and the table's keys, so the host picks the
kernel, and :func:`occupancy` / :func:`cluster_for` price the one
launched.

On a CPU tensor each wrapper runs its plain PyTorch version; on a CUDA
tensor it launches the kernel or raises. :data:`launches` counts kernel
launches per wrapper and role (one per call; ``"<wrapper>[block]"`` for
the block role).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.duet_attention import online_tiles, rank_combine
from repro_torch.kernels.ops import (CLUSTER_MAX, DENOM_EPS,
                                     MASKED_M_THRESHOLD, NEG_INF,
                                     PAGED_WG_MIN_KEYS, WG_HEAD_DIMS,
                                     block_tile_keys, cluster_cap,
                                     cluster_size, cluster_spans, cta_role,
                                     default_sm_scale, gqa_repeat_kv,
                                     gqa_split_heads, head_split,
                                     split_stream_kw)

launches = {"paged_decode": 0, "paged_decode[block]": 0,
            "paged_decode_splitkv": 0, "paged_decode_splitkv[block]": 0}
# the block-role launches of both wrappers by the block they ran
# (paged_engine): which block a serving path's steps took
block_launches = {"warpgroup": 0, "mma": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LOG2E = 1.4426950408889634


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


def _split_attend(q, k, v, valid):
    """Split attention in plain PyTorch: per-split (m, l, acc) partials
    with the dead-split guard, then the log-sum-exp combine in split order.
    q (B,H,Dh); k/v (B,S,L,G,Dh) the splits' gathered keys; valid (B,S,L)."""
    Dh = q.shape[-1]
    rep = q.shape[1] // k.shape[3]
    k = gqa_repeat_kv(k, rep).float()
    v = gqa_repeat_kv(v, rep).float()
    s = torch.einsum("bhd,bslhd->bshl", q.float(), k) * default_sm_scale(Dh)
    s = torch.where(valid[:, :, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)                                       # (B,S,H)
    live = m > MASKED_M_THRESHOLD
    p = torch.where(live[..., None], torch.exp(s - m[..., None]),
                    torch.zeros_like(s))
    l_part = p.sum(dim=-1)
    acc = torch.einsum("bshl,bslhd->bshd", p, v)
    return lse_combine(m, l_part, acc, dim=1).to(q.dtype)


def lse_combine(m, l, acc, dim: int):
    """The log-sum-exp combine of partials stacked on ``dim``, in that
    order: m (natural-log max or log-sum-exp; a partial at or below
    MASKED_M_THRESHOLD, -inf included, weighs 0), l (its denominator) and
    acc (its unnormalised sum, one more dim of Dh). Returns
    sum_i w_i acc_i / max(sum_i w_i l_i, DENOM_EPS), w_i = exp(m_i - max
    m), in fp32. Split-KV's splits, and a context-parallel decode's ranks
    (normalised outputs with l = 1, m their log-sum-exp), combine
    through it."""
    live = m > MASKED_M_THRESHOLD
    m_star = m.amax(dim=dim, keepdim=True)
    w = torch.where(live, torch.exp(m - m_star), torch.zeros_like(m))
    l_star = (w * l).sum(dim=dim)
    out = (acc * w[..., None]).sum(dim=dim)
    return out / l_star.clamp(min=DENOM_EPS)[..., None]


def paged_decode_splitkv_plain(q, k_pages, v_pages, tables, lengths, *,
                               num_splits: int):
    """The split-KV algorithm in plain PyTorch: the table cut into
    ``num_splits`` spans of whole pages (the same spans for every request),
    then :func:`_split_attend`."""
    B = q.shape[0]
    N, ps, G, Dh = k_pages.shape
    S, pps, pad = splitkv_spans(tables.shape[1], num_splits)
    tbl = torch.nn.functional.pad(tables.long(), (0, pad))    # null pages
    L = pps * ps
    tok = torch.arange(S * L, device=q.device).reshape(S, L)
    return _split_attend(q, k_pages[tbl].reshape(B, S, L, G, Dh),
                         v_pages[tbl].reshape(B, S, L, G, Dh),
                         tok[None] < lengths[:, None, None])


def paged_decode_cluster_plain(q, k_pages, v_pages, tables, lengths, *,
                               cluster: int):
    """The cluster kernel's algorithm in plain PyTorch: each request's live
    pages ceil(lengths / ps) cut into ``cluster`` spans by
    :func:`~repro_torch.kernels.ops.cluster_spans` (so the spans follow
    each request's length), then :func:`_split_attend`."""
    B = q.shape[0]
    N, ps, G, Dh = k_pages.shape
    P = tables.shape[1]
    live = [min(P, -(-max(n, 0) // ps)) for n in lengths.tolist()]
    width = max(1, -(-P // cluster))            # pages of the longest span
    idx = torch.full((B, cluster, width), -1, dtype=torch.long)
    for b, n in enumerate(live):
        for r, (p0, p1) in enumerate(cluster_spans(n, cluster)):
            idx[b, r, :p1 - p0] = torch.arange(p0, p1)
    idx = idx.to(q.device)
    pages = tables.long().gather(1, idx.clamp(min=0).reshape(B, -1))
    key = idx[..., None] * ps + torch.arange(ps, device=q.device)
    valid = (idx[..., None] >= 0) & (key < lengths[:, None, None, None])
    L = width * ps
    return _split_attend(q, k_pages[pages].reshape(B, cluster, L, G, Dh),
                         v_pages[pages].reshape(B, cluster, L, G, Dh),
                         valid.reshape(B, cluster, L))


def paged_decode_block_plain(q, k_pages, v_pages, tables, lengths, *,
                             cluster: int):
    """The warpgroup block role's walk (rep > 16, bf16 on the card) in
    plain PyTorch: each request's live pages cut into ``cluster`` spans
    (:func:`~repro_torch.kernels.ops.cluster_spans`, up to
    ``ops.BLOCK_CLUSTER_MAX`` ranks), each span walked in tiles of
    ``ops.block_tile_keys(ps)`` keys (whole pages) from its first key by
    one online softmax (P rounded to q's dtype), the ranks' partials
    combined in rank order."""
    B, H, Dh = q.shape
    N, ps, G, _ = k_pages.shape
    P = tables.shape[1]
    tk = block_tile_keys(ps)[0]
    qs = default_sm_scale(Dh) * LOG2E
    out = torch.empty_like(q)
    for b, n in enumerate(lengths.tolist()):
        n = max(n, 0)
        live = min(P, -(-n // ps))
        keys = torch.arange(min(n, live * ps), device=q.device)
        page = tables[b].long()[keys // ps]
        k_chain = k_pages[page, keys % ps].float()
        v_chain = v_pages[page, keys % ps].float()
        qt = gqa_split_heads(q[b].float(), G)               # (G, rep, Dh)
        lim = torch.full((H // G,), n - 1, device=q.device)
        parts = []
        for p0, p1 in cluster_spans(live, cluster):
            k0, k1 = p0 * ps, min(p1 * ps, n)
            parts.append(online_tiles(
                qt, lim, [keys[s:min(s + tk, k1)] for s in range(k0, k1, tk)],
                k_chain, v_chain, qs, q.dtype))
        _, l, acc = rank_combine(*(torch.stack(x) for x in zip(*parts)))
        out[b] = (acc / l.clamp(min=DENOM_EPS)[..., None]).reshape(
            H, Dh).to(q.dtype)
    return out


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------
def paged_engine(dtype, Dh: int, keys: int) -> str:
    """The block a :func:`paged_decode` block-role CTA runs over tables of
    ``keys`` keys (width times page size): "warpgroup" (csrc/wg_block.cuh)
    in bf16 at a head dim of ``ops.WG_HEAD_DIMS`` from
    ``ops.PAGED_WG_MIN_KEYS`` keys, else "mma" (prefill_core.cuh's).
    Host-known values only; the CUDA source takes the answer as its
    ``wg`` argument."""
    return ("warpgroup" if dtype == torch.bfloat16 and Dh in WG_HEAD_DIMS
            and keys >= PAGED_WG_MIN_KEYS else "mma")


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
    if tables.shape[0] != B or lengths.shape != (B,):
        raise ValueError("paged_decode: tables (B,P) / lengths (B,) mismatch")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_decode: page pools must be 16-byte aligned")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def occupancy(device: int, dtype, Dh: int, rows: int, P: int, engine: str,
              C: int, stream: int = 0):
    """(clusters of C CTAs the card runs at once, shared memory bytes per
    CTA, bytes each CTA's ring loads ahead) of the :func:`paged_decode`
    kernel of the role (``ops.cta_role(rows)``) that ``rows`` = rep query
    rows of a group take, for tables of width P, the block role on
    ``engine``'s block (:func:`paged_engine`)
    (cudaOccupancyMaxActiveClusters; a host query, no device sync). With
    ``stream`` an SM split's green-context stream (a raw handle), the
    clusters its context's SMs run at once."""
    res = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        err = _build.load("paged_decode").paged_decode_occupancy(
            Dh, rows, P, C, _DTYPES[dtype], int(engine == "warpgroup"),
            ctypes.addressof(res), stream)
    _build.check(err, "paged_decode occupancy")
    return tuple(res)


def cluster_for(q, k_pages, tables) -> int:
    """The cluster size :func:`paged_decode` launches these inputs with: one
    wave of its B x G x head-block clusters of the role and block it
    takes, from shapes alone."""
    B, H, Dh = q.shape
    ps, G = k_pages.shape[1:3]
    P = tables.shape[1]
    hb, _ = head_split(H // G, 1)
    dev = q.device.index if q.device.index is not None else \
        torch.cuda.current_device()
    on = split_stream_kw(q.device)
    engine = paged_engine(q.dtype, Dh, P * ps)
    return cluster_size(B * G * hb, P, lambda C: C * occupancy(
        dev, q.dtype, Dh, H // G, P, engine, C, **on)[0],
        cap=cluster_cap(H // G, engine, B * G * hb))


def _launch(name, q, k_pages, v_pages, tables, lengths, C):
    """One launch of the kernel of the role rep takes (and, for the block
    role, the block :func:`paged_engine` picks) with clusters of C CTAs
    (inputs checked by the caller), counted as ``name``'s."""
    B, H, Dh = q.shape
    N, ps, G, _ = k_pages.shape
    P = tables.shape[1]
    on = split_stream_kw(q.device)
    engine = paged_engine(q.dtype, Dh, P * ps)
    if on and occupancy(q.device.index, q.dtype, Dh, H // G, P, engine, C,
                        **on)[0] < 1:
        raise ValueError(f"{name}: the SMs of the current green context "
                         f"cannot hold a cluster of {C} CTAs")
    out = torch.empty_like(q)
    err = _build.load("paged_decode").paged_decode_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, H, G, Dh, ps, P, N, C, default_sm_scale(Dh), _DTYPES[q.dtype],
        int(engine == "warpgroup"), _stream(q))
    _build.check(err, "paged_decode")
    role = cta_role(H // G)
    launches[name if role == "decode" else f"{name}[{role}]"] += 1
    if role == "block":
        block_launches[engine] += 1
    return out


def _launch_paged_decode(q, k_pages, v_pages, tables, lengths):
    _check_inputs(q, k_pages, v_pages, tables, lengths)
    return _launch("paged_decode", q, k_pages, v_pages, tables, lengths,
                   cluster_for(q, k_pages, tables))


def _launch_splitkv(q, k_pages, v_pages, tables, lengths, num_splits):
    _check_inputs(q, k_pages, v_pages, tables, lengths)
    if num_splits > CLUSTER_MAX:
        raise ValueError(f"paged_decode_splitkv: num_splits {num_splits} > "
                         f"{CLUSTER_MAX} (the cluster size limit)")
    S, _, _ = splitkv_spans(tables.shape[1], num_splits)
    return _launch("paged_decode_splitkv", q, k_pages, v_pages, tables,
                   lengths, S)


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
    page walk is partitioned into ``num_splits`` contiguous spans whose
    (m, l, acc) partials are LSE-combined (on the card: the spans of each
    request's live pages, one CTA of a cluster each; ``num_splits`` <= 8
    there)."""
    if q.device.type == "cpu":
        return paged_decode_splitkv_plain(q, k_pages, v_pages, tables,
                                          lengths, num_splits=num_splits)
    return _launch_splitkv(q, k_pages, v_pages, tables, lengths, num_splits)
