"""Fused duet attention over the paged pool: a CUDA kernel for Hopper + its
plain version.

Replaces the Pallas TPU kernel ``duet_attention_paged`` of
``src/repro/kernels/duet_attention.py`` (``_paged_kernel``,
``_attend_tile``, ``_write_tile``). The slab variant ``duet_attention``
(``_kernel``) is not yet ported.

Work items are *rows*: a decode row is one request's single query token; a
prefill row is one query position of the chunk being prefilled. Rows are
grouped into per-slot tiles of ``block_q`` rows; tile t resolves
``tile_slot[t]`` -> block-table row -> pages, and every row attends
causally over that chain (``k_pos <= row_pos``). Decode rows and the
prefill chunk run in ONE launch — the reference's stand-in for the paper's
SM partition. The tile ORDER (``ops.build_duet_schedule``) is scheduling
only; the numerics do not depend on it.

Kernel source: ``csrc/duet_attention_paged.cu`` (design notes there).
Bound on an H100: memory (the unique KV bytes of the tiles' chains at
3.35 TB/s). This first kernel gives every tile its own block, so chain
pages shared by a prefill chunk's tiles are read once per tile.

Pad rows (``row_pos < 0``) and pad tiles (``tile_slot < 0``) come out as
zeros here and in the plain version (the reference kernel leaves the mean
of V there); callers read only unpacked rows. On a CPU tensor the wrapper
runs the plain version; on a CUDA tensor it launches the kernel or raises.
:data:`launches` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ops import (NEG_INF, default_sm_scale,
                                     gqa_split_heads)

launches = {"duet_attention_paged": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_QUERY_ROWS = 16      # block_q * rep of one block (csrc: 4 warps x 4)
_PLAIN_ROWS = 16         # rows per gathered chunk in the plain version


def duet_attention_paged_plain(q, row_pos, tile_slot, k_pages, v_pages,
                               tables, *, block_q: int = 8):
    """Plain PyTorch version: each row gathers its tile's chain and runs a
    masked fp32 softmax; rows go in chunks of 16 so the gathered chains
    stay small at serving widths. Pad rows and pad tiles give zeros."""
    R, H, Dh = q.shape
    N, ps, G, _ = k_pages.shape
    P = tables.shape[1]
    L = P * ps
    rep = H // G
    row_slot = tile_slot.long().repeat_interleave(block_q)          # (R,)
    pos = row_pos.reshape(-1).long()
    live = (row_slot >= 0) & (pos >= 0)
    kpos = torch.arange(L, device=q.device)
    out = torch.empty_like(q)
    for r0 in range(0, R, _PLAIN_ROWS):
        sl = slice(r0, r0 + _PLAIN_ROWS)
        chain = tables[row_slot[sl].clamp(min=0)].long()            # (n,P)
        n = chain.shape[0]
        k = k_pages[chain].reshape(n, L, G, Dh).float()
        v = v_pages[chain].reshape(n, L, G, Dh).float()
        qg = gqa_split_heads(q[sl].float(), G)                      # (n,G,r,D)
        s = torch.einsum("ngrd,nkgd->ngrk", qg, k) * default_sm_scale(Dh)
        mask = (kpos[None, :] <= pos[sl, None]) & live[sl, None]    # (n,L)
        s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        p = torch.where(live[sl, None, None, None], p, torch.zeros_like(p))
        o = torch.einsum("ngrk,nkgd->ngrd", p, v)
        out[sl] = o.reshape(n, G * rep, Dh).to(q.dtype)
    return out


def _launch(q, row_pos, tile_slot, k_pages, v_pages, tables, block_q):
    R, H, Dh = q.shape
    N, ps, G, Dk = k_pages.shape
    T = tile_slot.shape[0]
    if q.dtype not in _DTYPES:
        raise TypeError(f"duet_attention_paged: unsupported dtype {q.dtype}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != q.dtype or t.shape != k_pages.shape:
            raise ValueError(f"duet_attention_paged: {name} must be "
                             f"{q.dtype} {tuple(k_pages.shape)}")
    for name, t in (("q", q), ("row_pos", row_pos), ("tile_slot", tile_slot),
                    ("k_pages", k_pages), ("v_pages", v_pages),
                    ("tables", tables)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(
                f"duet_attention_paged: {name} is not on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"duet_attention_paged: {name} is not "
                             "contiguous")
    for name, t in (("row_pos", row_pos), ("tile_slot", tile_slot),
                    ("tables", tables)):
        if t.dtype != torch.int32:
            raise TypeError(f"duet_attention_paged: {name} must be int32")
    if R != T * block_q or row_pos.numel() != R:
        raise ValueError("duet_attention_paged: rows != tiles * block_q")
    if Dk != Dh or Dh not in (32, 64, 128, 256) or H % G:
        raise ValueError(
            f"duet_attention_paged: unsupported H={H} G={G} Dh={Dh}")
    if block_q * (H // G) > MAX_QUERY_ROWS:
        raise ValueError(f"duet_attention_paged: block_q * rep = "
                         f"{block_q * (H // G)} > {MAX_QUERY_ROWS}")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("duet_attention_paged: page pools must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    lib = _build.load("duet_attention_paged")
    err = lib.duet_attention_paged_launch(
        q.data_ptr(), row_pos.data_ptr(), tile_slot.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(), tables.data_ptr(),
        out.data_ptr(), T, block_q, H, G, Dh, ps, tables.shape[1],
        default_sm_scale(Dh), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "duet_attention_paged")
    launches["duet_attention_paged"] += 1
    return out


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
    return _launch(q, row_pos, tile_slot, k_pages, v_pages, tables, block_q)
