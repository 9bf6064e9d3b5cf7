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
on ``decode_core.cuh`` and the prefill core ``csrc/prefill_core.cuh``);
design notes there. Bound on an H100: memory (the unique live KV bytes of
the tiles at 3.35 TB/s). Both stop after the key of the tile's largest
``row_pos`` (the Pallas grids walk all of S, or all P pages) and split a
tile's keys over a cluster of C CTAs (each a span of whole 64-key units,
combined through distributed shared memory); C comes from
:func:`~repro_torch.kernels.ops.cluster_size` on the host: the most CTAs
the card runs in one wave, capped at 8 and at the 64-key units of the
slab row or the table. A CTA holds the (row, head) pairs of one (tile, KV
group); a tile of more than 64 (``ops.DUET_TILE_ROWS``) splits its
group's heads into head blocks on the grid
(:func:`~repro_torch.kernels.ops.head_split`). The slab kernel runs a
launch whose CTAs hold up to 16 pairs on the decode core, and one with
more (the slab decode's one-row tiles at rep > 16, prefill tiles) on
``flash_prefill``'s 64-row tensor-core block (the role is picked on the
host, :func:`slab_role`). The paged kernel picks a role per tile on the
card: a tile of at most 16 live pairs (``ops.DUET_DECODE_ROWS``; a decode
row at rep <= 16) runs on the decode core, a larger one (a tile of the
prefill chunk, or a decode row at rep > 16) on the tensor-core block with
its K/V gathered through the page table, so a chunk's chain is read once
per tile of 64 / rep positions. :func:`duet_attention_paged_tiled_plain`
is that schedule in plain PyTorch.

Pad rows (``row_pos < 0``) and pad tiles (``tile_slot < 0``) come out as
zeros here and in the plain versions (the reference kernels leave the mean
of V there); callers read only unpacked rows.

The slab kernel can also return each row's natural-log log-sum-exp over
the keys it saw (``return_lse``; -inf for a row that saw none): a rank of a
context-parallel decode runs it over its span of the cache's sequence,
with ``row_pos`` shifted by the span's first key, and the sequence group
combines the ranks' ``(out, lse)`` partials
(``core.device.DeviceContext.combine_partials``). On a CPU tensor a wrapper
runs the plain version; on a CUDA tensor it launches the kernel or raises.
:data:`launches` counts kernel launches per wrapper, and the slab
kernel's per role (``"duet_attention[block]"`` for the block role).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ops import (DENOM_EPS, DUET_DECODE_ROWS,
                                     DUET_TILE_ROWS, MASKED_M_THRESHOLD,
                                     NEG_INF, SPLIT_KEYS, cluster_size,
                                     cluster_spans, cta_role,
                                     default_sm_scale, gqa_split_heads,
                                     head_split)

launches = {"duet_attention": 0, "duet_attention[block]": 0,
            "duet_attention_paged": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PLAIN_ROWS = 16         # rows per gathered chunk in the plain versions
LOG2E = 1.4426950408889634
BLOCK_N = 64             # keys a K/V tile of the paged walk (csrc)


def _attend_rows(q, pos, live, k, v, with_lse: bool):
    """Masked fp32 softmax attention of n query rows, each over its own
    keys: q (n,H,Dh); pos, live (n,); k/v (n,L,G,Dh). Returns (out
    (n,H,Dh), with ``with_lse`` the scores' fp32 natural-log log-sum-exp
    over the valid keys (n,H), else None). Dead rows give zeros and
    -inf."""
    n, H, Dh = q.shape
    G = k.shape[2]
    kpos = torch.arange(k.shape[1], device=q.device)
    qg = gqa_split_heads(q.float(), G)                              # (n,G,r,D)
    s = torch.einsum("ngrd,nkgd->ngrk", qg, k.float()) * default_sm_scale(Dh)
    mask = (kpos[None, :] <= pos[:, None]) & live[:, None]          # (n,L)
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    lse = None
    if with_lse:
        lse = torch.logsumexp(torch.where(
            mask[:, None, None, :], s, torch.full_like(s, float("-inf"))),
            dim=-1).reshape(n, H)
    p = torch.softmax(s, dim=-1)
    p = torch.where(live[:, None, None, None], p, torch.zeros_like(p))
    o = torch.einsum("ngrk,nkgd->ngrd", p, v.float())
    return o.reshape(n, H, Dh).to(q.dtype), lse


def _plain(q, row_pos, tile_slot, block_q, gather_kv, with_lse=False):
    """Rows go in chunks of 16 so the gathered keys stay small at serving
    widths; ``gather_kv(slots)`` gives the chunk's (k, v) (n,L,G,Dh).
    Returns (out, lse or None)."""
    row_slot = tile_slot.long().repeat_interleave(block_q)          # (R,)
    pos = row_pos.reshape(-1).long()
    live = (row_slot >= 0) & (pos >= 0)
    out = torch.empty_like(q)
    lse = (torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
           if with_lse else None)
    for r0 in range(0, q.shape[0], _PLAIN_ROWS):
        sl = slice(r0, r0 + _PLAIN_ROWS)
        k, v = gather_kv(row_slot[sl].clamp(min=0))
        out[sl], part = _attend_rows(q[sl], pos[sl], live[sl], k, v,
                                     with_lse)
        if with_lse:
            lse[sl] = part
    return out, lse


def duet_attention_plain(q, row_pos, tile_slot, k_slab, v_slab, *,
                         block_q: int = 8, return_lse: bool = False):
    """Plain PyTorch version of :func:`duet_attention`: each row reads its
    tile's slab slot and runs a masked fp32 softmax. Pad rows and pad
    tiles give zeros (and a log-sum-exp of -inf)."""
    out, lse = _plain(q, row_pos, tile_slot, block_q,
                      lambda slots: (k_slab[slots], v_slab[slots]),
                      return_lse)
    return (out, lse) if return_lse else out


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
    return _plain(q, row_pos, tile_slot, block_q, gather)[0]


def duet_tile_plan(row_pos, tile_slot, *, block_q: int, rep: int):
    """What the paged kernel does with each tile, read from its rows as
    the kernel reads them on the card: (role, live rows, keys) per tile.
    The live rows are the tile's rows up to its last one with row_pos >= 0,
    the keys 0 .. the largest row_pos; a tile whose live rows times the
    heads of a head block (:func:`~repro_torch.kernels.ops.head_split`)
    are at most ``ops.DUET_DECODE_ROWS`` (row, head) pairs takes the
    "decode" role in every head block, a larger one the "prefill" role
    (where a tile splits into head blocks, a last, smaller block of at most
    8 pairs still takes the decode role; the numerics do not depend on
    it); a pad tile (or one without live rows) is (None, 0, 0)."""
    pos = row_pos.reshape(-1).tolist()
    _, hpc = head_split(rep, block_q)
    plan = []
    for t, slot in enumerate(tile_slot.tolist()):
        rows = pos[t * block_q:(t + 1) * block_q]
        live = [i for i, p in enumerate(rows) if p >= 0]
        if slot < 0 or not live:
            plan.append((None, 0, 0))
            continue
        nlive = live[-1] + 1
        role = "decode" if nlive * hpc <= DUET_DECODE_ROWS else "prefill"
        plan.append((role, nlive, max(rows) + 1))
    return plan


def _online(qt, lim, chunks, k_chain, v_chain, qs, dtype):
    """Online softmax in the log2 domain of rows qt (G,n,Dh) (row i sees
    keys <= lim[i]) over the key chunks in order (each a (k,) tensor of key
    positions), P rounded to ``dtype`` before P V. Returns (m in log2
    units, NEG_INF for a row that saw no valid key; l; acc): (G,n), (G,n),
    (G,n,Dh)."""
    G, n, Dh = qt.shape
    m = torch.full((G, n), NEG_INF, device=qt.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((G, n, Dh), device=qt.device)
    for keys in chunks:
        s = torch.einsum("gnd,kgd->gnk", qt, k_chain[keys])
        valid = keys[None, :] <= lim[:, None]                       # (n,k)
        s = torch.where(valid[None], s, torch.full_like(s, NEG_INF))
        mx = torch.maximum(m, s.amax(dim=-1))
        msc = torch.where(mx > MASKED_M_THRESHOLD, mx * qs,
                          torch.zeros_like(mx))
        alpha = torch.exp2(m * qs - msc)
        p = torch.exp2(s * qs - msc[..., None]).to(dtype).float()
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("gnk,kgd->gnd", p,
                                                    v_chain[keys])
        m = mx
    return (torch.where(m > MASKED_M_THRESHOLD, m * qs,
                        torch.full_like(m, NEG_INF)), l, acc)


def _combine(m, l, acc):
    """Log-sum-exp combine of (m, l, acc) partials stacked on dim 0, in
    that order (a partial whose max is at or below MASKED_M_THRESHOLD
    weighs 0)."""
    ms = m.amax(dim=0)
    w = torch.where(m > MASKED_M_THRESHOLD, torch.exp2(m - ms),
                    torch.zeros_like(m))
    l_sum = torch.zeros_like(ms)
    acc_sum = torch.zeros_like(acc[0])
    for i in range(m.shape[0]):
        l_sum = l_sum + w[i] * l[i]
        acc_sum = acc_sum + w[i][..., None] * acc[i]
    return ms, l_sum, acc_sum


def duet_attention_paged_tiled_plain(q, row_pos, tile_slot, k_pages, v_pages,
                                     tables, *, block_q: int = 8,
                                     cluster: int = 1):
    """The paged kernel's schedule in plain PyTorch: each tile's role
    (:func:`duet_tile_plan`), its keys in ``cluster`` spans of whole 64-key
    units (:func:`~repro_torch.kernels.ops.cluster_spans`) gathered through
    its table row, per span one online softmax over 64-key tiles (either
    role), then the spans' partials combined in rank order, and
    ``acc / max(l, DENOM_EPS)``. Pad rows and pad tiles give zeros."""
    R, H, Dh = q.shape
    N, ps, G, _ = k_pages.shape
    rep = H // G
    qs = default_sm_scale(Dh) * LOG2E
    pos = row_pos.reshape(-1).long()
    out = torch.zeros_like(q)
    plan = duet_tile_plan(row_pos, tile_slot, block_q=block_q, rep=rep)
    for t, (role, nlive, n_keys) in enumerate(plan):
        if role is None:
            continue
        n_keys = min(n_keys, tables.shape[1] * ps)
        rows = slice(t * block_q, t * block_q + nlive)
        qt = gqa_split_heads(q[rows].float(), G).permute(1, 0, 2, 3) \
            .reshape(G, nlive * rep, Dh)
        lim = pos[rows].repeat_interleave(rep)
        keys = torch.arange(n_keys, device=q.device)
        page = tables[int(tile_slot[t])].long()[keys // ps]
        k_chain = k_pages[page, keys % ps].float()                 # (L,G,D)
        v_chain = v_pages[page, keys % ps].float()
        parts = []
        for u0, u1 in cluster_spans(-(-n_keys // SPLIT_KEYS), cluster):
            k0, k1 = u0 * SPLIT_KEYS, min(u1 * SPLIT_KEYS, n_keys)
            chunks = [keys[s:min(s + BLOCK_N, k1)]
                      for s in range(k0, k1, BLOCK_N)]
            parts.append(_online(qt, lim, chunks, k_chain, v_chain, qs,
                                 q.dtype))
        _, l, acc = _combine(*(torch.stack(x) for x in zip(*parts)))
        o = acc / l.clamp(min=DENOM_EPS)[..., None]
        out[rows] = o.reshape(G, nlive, rep, Dh).permute(1, 0, 2, 3) \
            .reshape(nlive, H, Dh).to(q.dtype)
    return out


def _check_launch(name, q, row_pos, tile_slot, kv, ints, block_q):
    """The checks both CUDA wrappers make before a launch. ``kv``: the two
    KV tensors, (..., G, Dh); ``ints``: the int32 index tensors. Any GQA
    head shape is taken (head blocks split a tile of more than 64 (row,
    head) pairs); a tile of more than 64 rows is a layout the kernels do
    not take."""
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
    if not 1 <= block_q <= DUET_TILE_ROWS:
        raise ValueError(f"{name}: block_q {block_q} is not in 1.."
                         f"{DUET_TILE_ROWS}")
    if kv[0].data_ptr() % 16 or kv[1].data_ptr() % 16:
        raise ValueError(f"{name}: k and v must be 16-byte aligned")


def slab_role(block_q: int, rep: int) -> str:
    """The role every CTA of a slab :func:`duet_attention` launch takes:
    "decode" when a CTA holds at most 16 (row, head) pairs (block_q times
    the heads of a head block), "block" above."""
    return cta_role(block_q * head_split(rep, block_q)[1])


@functools.lru_cache(maxsize=None)
def occupancy(device: int, dtype, Dh: int, rows: int, C: int):
    """(clusters of C CTAs the card runs at once, shared memory bytes per
    CTA, bytes each CTA's ring loads ahead) of the slab
    :func:`duet_attention` kernel of the role ``rows`` (block_q times the
    heads of a head block) query rows per CTA take
    (cudaOccupancyMaxActiveClusters; a host query, no device sync)."""
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
    hb, hpc = head_split(H // G, block_q)
    dev = q.device.index if q.device.index is not None else \
        torch.cuda.current_device()
    return cluster_size(
        tile_slot.shape[0] * G * hb, -(-S // SPLIT_KEYS),
        lambda C: C * occupancy(dev, q.dtype, Dh, block_q * hpc, C)[0])


def _launch(q, row_pos, tile_slot, k_slab, v_slab, block_q, return_lse):
    S = k_slab.shape[1]
    _check_launch("duet_attention", q, row_pos, tile_slot, (k_slab, v_slab),
                  {}, block_q)
    R, H, Dh = q.shape
    T, G = tile_slot.shape[0], k_slab.shape[2]
    C = cluster_for(q, tile_slot, k_slab, block_q)
    out = torch.empty_like(q)
    lse = (torch.empty((R, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = _build.load("duet_attention")
    err = lib.duet_attention_launch(
        q.data_ptr(), row_pos.data_ptr(), tile_slot.data_ptr(),
        k_slab.data_ptr(), v_slab.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), T, block_q, H, G, Dh, S, C,
        default_sm_scale(Dh), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "duet_attention")
    role = slab_role(block_q, H // G)
    launches["duet_attention" if role == "decode"
             else f"duet_attention[{role}]"] += 1
    return (out, lse) if return_lse else out


@functools.lru_cache(maxsize=None)
def paged_occupancy(device: int, dtype, Dh: int, ps: int, P: int, C: int):
    """(clusters of C CTAs the card runs at once, shared memory bytes per
    CTA, registers per thread) of the :func:`duet_attention_paged` kernel
    for tables of width P over pages of ps tokens
    (cudaOccupancyMaxActiveClusters, cudaFuncGetAttributes; a host query,
    no device sync)."""
    res = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        err = _build.load(
            "duet_attention_paged").duet_attention_paged_occupancy(
            Dh, ps, P, C, _DTYPES[dtype], ctypes.addressof(res))
    _build.check(err, "duet_attention_paged occupancy")
    return tuple(res)


def paged_cluster_for(q, tile_slot, k_pages, tables) -> int:
    """The cluster size :func:`duet_attention_paged` launches these inputs
    with: one wave of the T x G x head-block clusters, at most the
    table's 64-key units."""
    H, Dh = q.shape[1:]
    ps, G = k_pages.shape[1:3]
    P = tables.shape[1]
    T = tile_slot.shape[0]
    hb, _ = head_split(H // G, q.shape[0] // max(T, 1))
    dev = q.device.index if q.device.index is not None else \
        torch.cuda.current_device()
    return cluster_size(
        T * G * hb, -(-P * ps // SPLIT_KEYS),
        lambda C: C * paged_occupancy(dev, q.dtype, Dh, ps, P, C)[0])


def _launch_paged(q, row_pos, tile_slot, k_pages, v_pages, tables, block_q):
    R, H, Dh = q.shape
    _check_launch("duet_attention_paged", q, row_pos, tile_slot,
                  (k_pages, v_pages), {"tables": tables}, block_q)
    N, ps, G, _ = k_pages.shape
    C = paged_cluster_for(q, tile_slot, k_pages, tables)
    out = torch.empty_like(q)
    lib = _build.load("duet_attention_paged")
    err = lib.duet_attention_paged_launch(
        q.data_ptr(), row_pos.data_ptr(), tile_slot.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(), tables.data_ptr(),
        out.data_ptr(), tile_slot.shape[0], block_q, H, G, Dh, ps,
        tables.shape[1], C, default_sm_scale(Dh), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "duet_attention_paged")
    launches["duet_attention_paged"] += 1
    return out


def duet_attention(q, row_pos, tile_slot, k_slab, v_slab, *,
                   block_q: int = 8, block_k: int = 128,
                   return_lse: bool = False):
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
      return_lse: also return each row's and head's fp32 natural-log
                 log-sum-exp of its scores over the keys it saw, (T*block_q,
                 H) (-inf for a pad row or one that saw no key).
    Returns (T*block_q, H, Dh), or (that, lse).
    """
    if k_slab.shape[1] % block_k:
        raise ValueError(f"duet_attention: S={k_slab.shape[1]} is not a "
                         f"multiple of block_k={block_k}")
    if q.device.type == "cpu":
        return duet_attention_plain(q, row_pos, tile_slot, k_slab, v_slab,
                                    block_q=block_q, return_lse=return_lse)
    return _launch(q, row_pos, tile_slot, k_slab, v_slab, block_q,
                   return_lse)


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
    On the card ``block_q`` is at most 64 (any head shape). Returns
    (T*block_q, H, Dh).
    """
    if q.device.type == "cpu":
        return duet_attention_paged_plain(q, row_pos, tile_slot, k_pages,
                                          v_pages, tables, block_q=block_q)
    return _launch_paged(q, row_pos, tile_slot, k_pages, v_pages, tables,
                         block_q)
