"""Fused duet attention, over the slab cache and over the paged pool: CUDA
kernels for Hopper + their plain versions.

Replaces the Pallas TPU kernels of ``src/repro/kernels/duet_attention.py``:
``duet_attention`` (slab, ``_kernel``) and ``duet_attention_paged``
(``_paged_kernel``), with their shared ``_attend_tile`` / ``_write_tile``.

Work items are *rows*: a decode row is one request's single query token; a
prefill row is one query position of the chunk being prefilled. Rows are
grouped into per-slot tiles of ``block_q`` rows; tile t reads the KV of
``tile_slot[t]`` (a slab slot, or a block-table row -> pages) and every
row attends causally over it (``k_pos <= row_pos``). Decode rows and the
prefill chunk run in ONE launch — the reference's stand-in for the paper's
SM partition. The tile ORDER (``ops.build_duet_schedule``) is scheduling
only; the numerics do not depend on it.

Kernel sources: ``csrc/duet_attention.cu`` (slab, on the cluster decode
core ``csrc/decode_core.cuh``) and ``csrc/duet_attention_paged.cu`` (pages,
on ``csrc/attn_common.cuh``); design notes there. Bound on an H100: memory
(the unique live KV bytes of the tiles at 3.35 TB/s). Every tile has its
own CTAs, so keys shared by a prefill chunk's tiles are read once per tile.
Both stop after the key of the tile's largest ``row_pos`` (the Pallas
grids walk all of S, or all P pages). The slab kernel splits a tile's keys
over a cluster of C CTAs (each a span of whole 64-key units, combined
through distributed shared memory); C comes from
:func:`~repro_torch.kernels.ops.cluster_size` on the host: the most CTAs
the card runs in one wave, capped at 8 and at the slab's 64-key units.

Pad rows (``row_pos < 0``) and pad tiles (``tile_slot < 0``) come out as
zeros here and in the plain versions (the reference kernels leave the mean
of V there); callers read only unpacked rows. On a CPU tensor a wrapper
runs the plain version; on a CUDA tensor it launches the kernel or raises.
:data:`launches` counts kernel launches per wrapper.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ops import (NEG_INF, SPLIT_KEYS, cluster_size,
                                     default_sm_scale, gqa_split_heads)

launches = {"duet_attention": 0, "duet_attention_paged": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_QUERY_ROWS = 16      # block_q * rep of one block (csrc: 16 at most)
_PLAIN_ROWS = 16         # rows per gathered chunk in the plain versions


def _attend_rows(q, pos, live, k, v):
    """Masked fp32 softmax attention of n query rows, each over its own
    keys: q (n,H,Dh); pos, live (n,); k/v (n,L,G,Dh). Dead rows give
    zeros."""
    n, H, Dh = q.shape
    G = k.shape[2]
    kpos = torch.arange(k.shape[1], device=q.device)
    qg = gqa_split_heads(q.float(), G)                              # (n,G,r,D)
    s = torch.einsum("ngrd,nkgd->ngrk", qg, k.float()) * default_sm_scale(Dh)
    mask = (kpos[None, :] <= pos[:, None]) & live[:, None]          # (n,L)
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(live[:, None, None, None], p, torch.zeros_like(p))
    o = torch.einsum("ngrk,nkgd->ngrd", p, v.float())
    return o.reshape(n, H, Dh).to(q.dtype)


def _plain(q, row_pos, tile_slot, block_q, gather_kv):
    """Rows go in chunks of 16 so the gathered keys stay small at serving
    widths; ``gather_kv(slots)`` gives the chunk's (k, v) (n,L,G,Dh)."""
    row_slot = tile_slot.long().repeat_interleave(block_q)          # (R,)
    pos = row_pos.reshape(-1).long()
    live = (row_slot >= 0) & (pos >= 0)
    out = torch.empty_like(q)
    for r0 in range(0, q.shape[0], _PLAIN_ROWS):
        sl = slice(r0, r0 + _PLAIN_ROWS)
        k, v = gather_kv(row_slot[sl].clamp(min=0))
        out[sl] = _attend_rows(q[sl], pos[sl], live[sl], k, v)
    return out


def duet_attention_plain(q, row_pos, tile_slot, k_slab, v_slab, *,
                         block_q: int = 8):
    """Plain PyTorch version of :func:`duet_attention`: each row reads its
    tile's slab slot and runs a masked fp32 softmax. Pad rows and pad
    tiles give zeros."""
    return _plain(q, row_pos, tile_slot, block_q,
                  lambda slots: (k_slab[slots], v_slab[slots]))


def duet_attention_paged_plain(q, row_pos, tile_slot, k_pages, v_pages,
                               tables, *, block_q: int = 8):
    """Plain PyTorch version of :func:`duet_attention_paged`: each row
    gathers its tile's page chain and runs a masked fp32 softmax. Pad rows
    and pad tiles give zeros."""
    N, ps, G, Dh = k_pages.shape
    L = tables.shape[1] * ps

    def gather(slots):
        chain = tables[slots].long()                                # (n,P)
        return (k_pages[chain].reshape(len(slots), L, G, Dh),
                v_pages[chain].reshape(len(slots), L, G, Dh))
    return _plain(q, row_pos, tile_slot, block_q, gather)


def _check_launch(name, q, row_pos, tile_slot, kv, ints, block_q):
    """The checks both CUDA wrappers make before a launch. ``kv``: the two
    KV tensors, (..., G, Dh); ``ints``: the int32 index tensors."""
    R, H, Dh = q.shape
    G, Dk = kv[0].shape[-2:]
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: unsupported dtype {q.dtype}")
    for label, t in zip(("k", "v"), kv):
        if t.dtype != q.dtype or t.shape != kv[0].shape:
            raise ValueError(f"{name}: {label} must be {q.dtype} "
                             f"{tuple(kv[0].shape)}")
    for label, t in (("q", q), ("row_pos", row_pos), ("tile_slot", tile_slot),
                     ("k", kv[0]), ("v", kv[1]), *ints.items()):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name}: {label} is not on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} is not contiguous")
    for label, t in (("row_pos", row_pos), ("tile_slot", tile_slot),
                     *ints.items()):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {label} must be int32")
    if R != tile_slot.shape[0] * block_q or row_pos.numel() != R:
        raise ValueError(f"{name}: rows != tiles * block_q")
    if Dk != Dh or Dh not in (32, 64, 128, 256) or H % G:
        raise ValueError(f"{name}: unsupported H={H} G={G} Dh={Dh}")
    if block_q * (H // G) > MAX_QUERY_ROWS:
        raise ValueError(f"{name}: block_q * rep = {block_q * (H // G)} > "
                         f"{MAX_QUERY_ROWS}")
    if kv[0].data_ptr() % 16 or kv[1].data_ptr() % 16:
        raise ValueError(f"{name}: k and v must be 16-byte aligned")


@functools.lru_cache(maxsize=None)
def occupancy(device: int, dtype, Dh: int, rows: int, C: int):
    """(clusters of C CTAs the card runs at once, shared memory bytes per
    CTA, bytes each CTA's ring loads ahead) of the slab
    :func:`duet_attention` kernel for ``rows`` (block_q * rep) query rows
    per CTA (cudaOccupancyMaxActiveClusters; a host query, no device
    sync)."""
    res = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        err = _build.load("duet_attention").duet_attention_occupancy(
            Dh, rows, C, _DTYPES[dtype], ctypes.addressof(res))
    _build.check(err, "duet_attention occupancy")
    return tuple(res)


def cluster_for(q, tile_slot, k_slab, block_q) -> int:
    """The cluster size the slab :func:`duet_attention` launches these
    inputs with."""
    H, Dh = q.shape[1:]
    S, G = k_slab.shape[1:3]
    dev = q.device.index if q.device.index is not None else \
        torch.cuda.current_device()
    return cluster_size(
        tile_slot.shape[0] * G, -(-S // SPLIT_KEYS),
        lambda C: C * occupancy(dev, q.dtype, Dh, block_q * (H // G), C)[0])


def _launch(q, row_pos, tile_slot, k_slab, v_slab, block_q):
    S = k_slab.shape[1]
    _check_launch("duet_attention", q, row_pos, tile_slot, (k_slab, v_slab),
                  {}, block_q)
    R, H, Dh = q.shape
    T, G = tile_slot.shape[0], k_slab.shape[2]
    C = cluster_for(q, tile_slot, k_slab, block_q)
    out = torch.empty_like(q)
    lib = _build.load("duet_attention")
    err = lib.duet_attention_launch(
        q.data_ptr(), row_pos.data_ptr(), tile_slot.data_ptr(),
        k_slab.data_ptr(), v_slab.data_ptr(), out.data_ptr(), T, block_q, H,
        G, Dh, S, C, default_sm_scale(Dh), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "duet_attention")
    launches["duet_attention"] += 1
    return out


def _launch_paged(q, row_pos, tile_slot, k_pages, v_pages, tables, block_q):
    _check_launch("duet_attention_paged", q, row_pos, tile_slot,
                  (k_pages, v_pages), {"tables": tables}, block_q)
    R, H, Dh = q.shape
    N, ps, G, _ = k_pages.shape
    out = torch.empty_like(q)
    lib = _build.load("duet_attention_paged")
    err = lib.duet_attention_paged_launch(
        q.data_ptr(), row_pos.data_ptr(), tile_slot.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(), tables.data_ptr(),
        out.data_ptr(), tile_slot.shape[0], block_q, H, G, Dh, ps,
        tables.shape[1], default_sm_scale(Dh), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "duet_attention_paged")
    launches["duet_attention_paged"] += 1
    return out


def duet_attention(q, row_pos, tile_slot, k_slab, v_slab, *,
                   block_q: int = 8, block_k: int = 128):
    """Fused mixed-phase attention over the slab cache.

    Args:
      q:         (T*block_q, H, Dh) query rows, tile-grouped. Tile t's rows
                 all target slab slot ``tile_slot[t]`` (host groups + pads).
      row_pos:   (T*block_q, 1) int32 absolute position per row (-1 = pad
                 row).
      tile_slot: (T,) int32 slab slot per tile (-1 = pad tile). The ORDER
                 of tiles is the duet schedule (decode tiles interleaved).
      k_slab/v_slab: (Ns, S, G, Dh) slab KV (chunk K/V pre-written).
      block_k:   the reference's KV tile; S must be a multiple of it (the
                 reference's contract). The CUDA kernel stages its own
                 tiles and the result does not depend on it.
    Returns (T*block_q, H, Dh).
    """
    if k_slab.shape[1] % block_k:
        raise ValueError(f"duet_attention: S={k_slab.shape[1]} is not a "
                         f"multiple of block_k={block_k}")
    if q.device.type == "cpu":
        return duet_attention_plain(q, row_pos, tile_slot, k_slab, v_slab,
                                    block_q=block_q)
    return _launch(q, row_pos, tile_slot, k_slab, v_slab, block_q)


def duet_attention_paged(q, row_pos, tile_slot, k_pages, v_pages, tables, *,
                         block_q: int = 8):
    """Fused mixed-phase attention over the paged pool.

    Args:
      q:         (T*block_q, H, Dh) query rows, tile-grouped.
      row_pos:   (T*block_q, 1) int32 absolute position per row (-1 = pad).
      tile_slot: (T,) int32 — index into ``tables`` rows per tile (-1 = pad
                 tile).
      k_pages/v_pages: (N, ps, G, Dh) device page pools.
      tables:    (B, P) int32 block tables; row ``tile_slot[t]`` is tile
                 t's page chain. Unused entries must hold a valid (null)
                 page id.
    Returns (T*block_q, H, Dh).
    """
    if q.device.type == "cpu":
        return duet_attention_paged_plain(q, row_pos, tile_slot, k_pages,
                                          v_pages, tables, block_q=block_q)
    return _launch_paged(q, row_pos, tile_slot, k_pages, v_pages, tables,
                         block_q)
