"""Public dispatchers for the port's attention kernels + the duet schedule
builder.

A dispatcher launches the CUDA kernel for a CUDA tensor and the kernel's
plain PyTorch version for a CPU tensor (the kernel modules decide on the
tensor's device; there is no fallback and no ``try``).

This module is also the single source of truth for the kernel-wide
conventions: the masking constant (:data:`NEG_INF`), the softmax scale
(:func:`default_sm_scale`) and the GQA head-grouping layout
(:func:`gqa_split_heads` / :func:`gqa_repeat_kv`). The helpers live ABOVE
the kernel imports below so the kernel modules can import them during this
module's own (partial) initialization without a cycle. The CUDA sources
restate the constants in ``csrc/attn_common.cuh``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Shared kernel conventions (imported by kernels/{paged_decode,
# duet_attention,flash_prefill,ref}.py — keep above the kernel imports).
# ---------------------------------------------------------------------------
NEG_INF = -1e30
# an online-softmax denominator is clamped to this before any division
DENOM_EPS = 1e-20
# masked-split guard: a running max still at NEG_INF means "saw no valid
# token yet" — compare against half the sentinel so float error can't flip it
MASKED_M_THRESHOLD = NEG_INF * 0.5


def default_sm_scale(head_dim: int) -> float:
    """The shared 1/sqrt(Dh) softmax scale."""
    return 1.0 / float(head_dim) ** 0.5


def gqa_split_heads(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """(..., H, Dh) -> (..., G, rep, Dh). Query head h serves kv group
    h // rep — the layout every kernel and reference assumes."""
    *lead, H, Dh = x.shape
    assert H % num_groups == 0, (H, num_groups)
    return x.reshape(*lead, num_groups, H // num_groups, Dh)


def gqa_merge_heads(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`gqa_split_heads`: (..., G, rep, Dh) -> (..., H, Dh)."""
    *lead, G, rep, Dh = x.shape
    return x.reshape(*lead, G * rep, Dh)


def gqa_repeat_kv(kv: torch.Tensor, rep: int) -> torch.Tensor:
    """Broadcast kv heads to query heads on the head axis (-2):
    (..., G, Dh) -> (..., G*rep, Dh), matching :func:`gqa_split_heads`."""
    return torch.repeat_interleave(kv, rep, dim=-2)


def num_splits_for(num_pages: int, page_size: int,
                   split_threshold: Optional[int]) -> int:
    """Static split count for one paged-decode launch.

    The decision is made on the table's token *capacity* (a static shape),
    not the lengths, so it never reads a device value: the engine's
    table-width bucketing already tracks context growth. Returns 1 (no
    split) below the threshold; above it, enough splits to bring each split
    under the threshold, capped at 8 and at one page per split.
    """
    if not split_threshold or split_threshold <= 0:
        return 1
    capacity = num_pages * page_size
    if capacity <= split_threshold:
        return 1
    return max(2, min(num_pages, -(-capacity // split_threshold), 8))


# The key split of the cluster kernels (csrc/decode_core.cuh):
# ``paged_decode`` splits a request's live pages, the slab
# ``duet_attention`` and ``duet_attention_paged`` a tile's keys in units of
# SPLIT_KEYS, over a cluster of C CTAs.
CLUSTER_MAX = 8          # the portable cluster size
SPLIT_KEYS = 64          # the duet kernels' split unit (keys)


def cluster_size(ctas: int, max_units: int, holds) -> int:
    """C for a launch of ``ctas`` (request or tile, KV group) clusters: the
    largest power of two, at most :data:`CLUSTER_MAX` and at most
    ``max_units`` (the split units of the longest row; the host passes a
    bound that needs no device read: the table's width in pages, or the
    64-key units of the slab or of the table), whose grid of ``ctas * C``
    CTAs the card runs in one wave. ``holds(C)`` is how many CTAs of
    clusters of C the card runs at once (cudaOccupancyMaxActiveClusters).
    1 when the grid already fills the card."""
    C = 1
    while (2 * C <= min(CLUSTER_MAX, max_units)
           and ctas * 2 * C <= holds(2 * C)):
        C *= 2
    return C


# A CTA of every kernel holds the (row, head) pairs of one (tile, KV
# group): up to DUET_DECODE_ROWS of them on the cluster decode core
# (csrc/decode_core.cuh), more (up to DUET_TILE_ROWS) on the 64-row
# tensor-core block (csrc/prefill_core.cuh, the "block role"; the paged duet
# kernel's prefill role). A tile with more pairs than that splits its
# group's heads into head blocks (:func:`head_split`).
DUET_TILE_ROWS = 64
DUET_DECODE_ROWS = 16


def head_split(rep: int, block_q: int,
               max_pairs: int = DUET_TILE_ROWS) -> Tuple[int, int]:
    """(head blocks, heads per block) of one (tile, KV group): a tile of
    ``block_q`` positions of a group of ``rep`` heads holds block_q * rep
    (row, head) pairs; where they are more than ``max_pairs``, the heads
    split into blocks of at most max_pairs // block_q heads, balanced (the
    last may hold fewer), each a CTA of its own. One block for every
    registered config at the engine's tiles; 2 at rep 96 or 128. The CUDA
    sources restate it (``attn::head_split``)."""
    per = max(1, max_pairs // max(block_q, 1))
    hb = -(-rep // per)
    return hb, -(-rep // hb)


def cta_role(pairs: int) -> str:
    """The role a CTA of ``pairs`` (row, head) pairs takes: "decode" (the
    cluster decode core) up to :data:`DUET_DECODE_ROWS`, "block" (the
    64-row tensor-core block) above. The paged duet kernel reads each
    tile's live rows on the card and calls its block role "prefill"."""
    return "decode" if pairs <= DUET_DECODE_ROWS else "block"


def duet_block_q(num_heads: int, num_kv_heads: int, head_dim: int) -> int:
    """Query rows of one tile of the engine's fused duet launch: as many
    chunk positions as fill one tile of the paged duet kernel (64 // rep,
    e.g. 16 at qwen3-4b's rep 4, 12 at qwen3-14b's rep 5, 1 from rep 33 on,
    as at granite-20b's rep 48), at every head dim. Scheduling only: the
    numerics do not depend on it."""
    return max(1, DUET_TILE_ROWS // (num_heads // num_kv_heads))


def cluster_spans(n_units: int, C: int) -> List[Tuple[int, int]]:
    """The [start, end) units each rank of a cluster of C walks: contiguous
    spans of ceil(n_units / C) in rank order, clipped to ``n_units`` (ranks
    past the last live unit get empty spans). The kernels compute the same
    spans on the card from the row's live length."""
    span = -(-n_units // C)
    return [(min(r * span, n_units), min((r + 1) * span, n_units))
            for r in range(C)]


# the kernel wrappers, re-exported as this module's dispatchers
from repro_torch.kernels.duet_attention import (  # noqa: E402,F401
    duet_attention, duet_attention_paged)
from repro_torch.kernels.flash_prefill import flash_prefill  # noqa: E402,F401
from repro_torch.kernels.paged_decode import (  # noqa: E402,F401
    lse_combine, paged_decode, paged_decode_splitkv)


# launches of the sharded route (each also counts under the inner
# kernel's own name in kernels/paged_decode.py)
launches = {"paged_decode_sharded": 0}


def paged_decode_sharded(q, k_pages, v_pages, tables, lengths, *, ctx,
                         num_splits: int = 1):
    """The TP > 1 decode route: this rank's head shard through
    :func:`paged_decode` (``num_splits`` 1) or
    :func:`paged_decode_splitkv`, the reference's ``shard_map`` over the
    KV-head axis (``src/repro/kernels/ops.py:115``) with one process a
    rank. q (B, H/tp, Dh) and the pools (N, ps, G/tp, Dh) are the rank's
    shards, allocated at that width (the kernels need contiguous,
    16-byte-aligned pools); tables (B, P) and lengths (B,) are whole.
    Softmax is per head and the heads are partitioned, so no reduction
    crosses ranks. Raises on a shape that is not the rank's shard of
    ``ctx.cfg``; counts a launch where the kernel launches (CUDA)."""
    cfg, tp = ctx.cfg, ctx.tp
    if not ctx.sharded("kv_heads"):
        raise ValueError(
            f"paged_decode_sharded: kv heads ({cfg.num_kv_heads}) of "
            f"{cfg.name} do not shard over tp={tp}")
    B, H, Dh = q.shape
    _, _, G, Dk = k_pages.shape
    want = (cfg.num_heads // tp, cfg.num_kv_heads // tp, cfg.head_dim)
    if (H, G, Dh) != want or Dk != Dh or v_pages.shape != k_pages.shape:
        raise ValueError(
            f"paged_decode_sharded: q heads {H}, pool kv heads {G}, Dh "
            f"{Dh} (v {tuple(v_pages.shape)}); rank {ctx.rank} of tp={tp} "
            f"holds {want[0]} / {want[1]} at Dh {want[2]}")
    if tables.shape[0] != B or tuple(lengths.shape) != (B,):
        raise ValueError("paged_decode_sharded: tables (B,P) / lengths (B,) "
                         "must be whole (rank-global)")
    if num_splits > 1:
        out = paged_decode_splitkv(q, k_pages, v_pages, tables, lengths,
                                   num_splits=num_splits)
    else:
        out = paged_decode(q, k_pages, v_pages, tables, lengths)
    if q.is_cuda:
        launches["paged_decode_sharded"] += 1
    return out


def paged_decode_auto(q, k_pages, v_pages, tables, lengths, *, ctx=None,
                      split_threshold: Optional[int] = 0):
    """Kernel-path dispatcher used by the model's decode step: the sharded
    route when ``ctx`` cuts the KV heads across TP ranks, and there or
    elsewhere (one device, or KV heads every rank holds whole) the split-KV
    kernel when the table capacity crosses the (roofline-priced)
    threshold, the plain page walk otherwise."""
    splits = num_splits_for(tables.shape[1], k_pages.shape[1],
                            split_threshold)
    if ctx is not None and ctx.sharded("kv_heads"):
        return paged_decode_sharded(q, k_pages, v_pages, tables, lengths,
                                    ctx=ctx, num_splits=splits)
    if splits > 1:
        return paged_decode_splitkv(q, k_pages, v_pages, tables, lengths,
                                    num_splits=splits)
    return paged_decode(q, k_pages, v_pages, tables, lengths)


# ---------------------------------------------------------------------------
# Duet schedule builder (host side)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class DuetSchedule:
    """Tile layout for one fused duet launch.

    ``order`` maps kernel tile index -> (kind, original index) for unpacking;
    decode tiles are interleaved among prefill tiles at the Algorithm-1 ratio
    so they retire early in the grid (the TBT guarantee)."""
    tile_slot: np.ndarray            # (T,) int32
    row_slot: np.ndarray             # (T*bq,) int32 (-1 pad)
    row_pos: np.ndarray              # (T*bq,) int32 (-1 pad)
    row_src: np.ndarray              # (T*bq,) int32 index into the packed
    # source row list (-1 pad), used to scatter kernel output back
    num_decode_tiles: int
    num_prefill_tiles: int


def build_duet_schedule(decode_rows: Sequence[Tuple[int, int]],
                        prefill_rows: Sequence[Tuple[int, int]],
                        *, block_q: int = 8,
                        decode_share: float = 0.25) -> DuetSchedule:
    """Group rows into per-slot tiles and interleave the two phases.

    Args:
      decode_rows: [(slot, pos)] one per active decode request.
      prefill_rows: [(slot, pos)] one per query position of the prefill chunk.
      decode_share: S_d / (S_d + S_p) from the partition optimizer — sets the
        interleave ratio (a decode tile is placed after every
        ``(1-share)/share`` prefill tiles).
    Rows are indexed in the order given: row_src refers to
    list(decode_rows) + list(prefill_rows).
    """
    def tiles_for(rows, base):
        by_slot: dict = {}
        for i, (slot, pos) in enumerate(rows):
            by_slot.setdefault(slot, []).append((base + i, pos))
        tiles = []
        for slot, items in sorted(by_slot.items()):
            for off in range(0, len(items), block_q):
                chunk = items[off:off + block_q]
                tiles.append((slot, chunk))
        return tiles

    d_tiles = tiles_for(decode_rows, 0)
    p_tiles = tiles_for(prefill_rows, len(decode_rows))

    # interleave: after every `stride` prefill tiles, insert one decode tile
    order: List[Tuple[int, list]] = []
    if not p_tiles:
        order = d_tiles
    elif not d_tiles:
        order = p_tiles
    else:
        stride = max(1, round((1.0 - decode_share) / max(decode_share, 1e-6)))
        di, pi = 0, 0
        while di < len(d_tiles) or pi < len(p_tiles):
            if di < len(d_tiles):
                order.append(d_tiles[di])
                di += 1
            take = min(stride, len(p_tiles) - pi)
            order.extend(p_tiles[pi:pi + take])
            pi += take

    T = max(1, len(order))
    tile_slot = np.full((T,), -1, np.int32)
    row_slot = np.full((T * block_q,), -1, np.int32)
    row_pos = np.full((T * block_q,), -1, np.int32)
    row_src = np.full((T * block_q,), -1, np.int32)
    for t, (slot, items) in enumerate(order):
        tile_slot[t] = slot
        for r, (src, pos) in enumerate(items):
            row_slot[t * block_q + r] = slot
            row_pos[t * block_q + r] = pos
            row_src[t * block_q + r] = src
    return DuetSchedule(tile_slot=tile_slot, row_slot=row_slot,
                        row_pos=row_pos, row_src=row_src,
                        num_decode_tiles=len(d_tiles),
                        num_prefill_tiles=len(p_tiles))


def pack_duet_queries(schedule: DuetSchedule,
                      src_q: torch.Tensor) -> torch.Tensor:
    """Scatter packed source query rows (Nsrc, H, Dh) into tile layout."""
    idx = torch.as_tensor(np.maximum(schedule.row_src, 0),
                          device=src_q.device, dtype=torch.long)
    valid = torch.as_tensor(schedule.row_src >= 0, device=src_q.device)
    return torch.where(valid[:, None, None], src_q[idx],
                       torch.zeros((), dtype=src_q.dtype,
                                   device=src_q.device))


def unpack_duet_output(schedule: DuetSchedule, out: torch.Tensor,
                       num_src: int) -> torch.Tensor:
    """Gather kernel output rows back to packed source order (Nsrc, H, Dh)."""
    valid = schedule.row_src >= 0
    dst = torch.as_tensor(schedule.row_src[valid], device=out.device,
                          dtype=torch.long)
    src = torch.as_tensor(np.where(valid)[0], device=out.device,
                          dtype=torch.long)
    res = torch.zeros((num_src,) + tuple(out.shape[1:]), dtype=out.dtype,
                      device=out.device)
    res[dst] = out[src]
    return res
