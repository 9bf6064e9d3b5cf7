"""GQA and MLA attention over the slab cache and the paged KV pool — the
serving engine's paths.

Ports the reference's ``repro.models.attention``:

* slab cache (:class:`AttnCache`, one (B, S_max|W, G, Dh) row per slot):
  full-sequence prefill (:func:`gqa_prefill`), chunked prefill into the
  slab (:func:`gqa_prefill_cached`), one-token decode (:func:`gqa_decode`,
  with the sliding ring buffer) and its kernel hook
  (:func:`gqa_decode_kernel`, the slab ``duet_attention`` kernel);
* paged pool: chunked prefill (:func:`gqa_prefill_paged`), one-token
  decode with the kernel hook (:func:`gqa_decode_paged`) and the fused
  mixed-phase duet step (:func:`gqa_duet_paged`);
* MLA (DeepSeek-V2 multi-head latent attention), whose cache holds the
  compressed latent and the shared rope key (:class:`MLACache`):
  full-sequence, slab-chunked and paged prefill (:func:`mla_prefill`,
  :func:`mla_prefill_cached`, :func:`mla_prefill_paged`) and one-token
  decode over the slab and the pool (:func:`mla_decode`,
  :func:`mla_decode_paged`), each with the up-projections expanded per
  step or absorbed into the query and output (``absorb``). The reference
  has no kernel for MLA; neither has the port.

The attention math stays plain tensor math as in the reference (einsum +
softmax); the decode and duet reads may go through the CUDA kernels in
``repro_torch.kernels``.

Tensor parallelism: every GQA function runs on the heads its weights
hold (H and G come from the weights' shapes), so under TP a rank computes
its head shard against its KV-head shard of the cache or pool, and the
out-projection's partial sums are added over the ranks (``ctx``, a
``DeviceContext``; None on one device) when the ``heads`` axis is sharded.
Softmax is per head, so no other step crosses ranks (but for
context-parallel decode, below). The MLA functions
run the same way on the rank's heads of ``w_q``, ``w_uk`` and ``w_uv`` and
its rows of the flat ``w_o``: the latent down-projection, its norm and the
rope key stay whole, so every rank writes the same latents into its own
whole latent pool (the reference replicates MLA's pools).

Context-parallel decode (``ctx.seq`` > 1, the slab decode only): a
rank's slab holds its contiguous span of the cache's sequence (or of the
sliding ring), keys ``base .. base + S_local - 1`` of the whole
(``ctx.seq_span``), as the reference's ``cache_pspecs`` places it. Only
the rank whose span holds the new token's slot writes its K/V (or
latents); positions stay rank-global. Each rank attends over its span
(masked by the global key index), giving a normalised output and its
log-sum-exp, and the sequence group's partials are combined before the
out-projection (``ctx.combine_partials``), so every rank of the group
gets the same bits. MLA's latents are cut over ``model`` while its heads
are too, so an MLA layer first gathers every head's absorbed query over
the model group (``ctx.gather_heads``), attends with all of them over its
span in the latent space and, after the combine, keeps its own heads
(:func:`mla_decode`). The paged pools keep their whole sequence.

Caches and page pools are updated IN PLACE (the reference is functional):
each function writes the new K/V into the tensors it is given and returns
the same tensors. Scores and probabilities are fp32.

Shapes: x (B, S, D); q (B, S, H, Dh); kv (B, S, G, Dh); positions (B, S);
MLA latents (B, S, r) and rope keys (B, S, rope).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ops import DENOM_EPS, MASKED_M_THRESHOLD, NEG_INF
from repro_torch.models.layers import apply_rope, rms_norm

ATTN_BLOCK_Q = 1024  # query-block size for memory-efficient attention


class AttnCache(NamedTuple):
    k: torch.Tensor  # (B, S_max|W, G, Dh)
    v: torch.Tensor


class MLACache(NamedTuple):
    ckv: torch.Tensor    # (B, S_max, r)
    krope: torch.Tensor  # (B, S_max, rope_dim)


def slot_views(cache, slot: int):
    """Slot ``slot``'s rows of every layer's cache (AttnCache, MLACache or
    recurrent state; None stays None) as views of batch 1: a prefill into
    them writes the slab or the per-slot state in place."""
    return [None if c is None else type(c)(*(t[slot:slot + 1] for t in c))
            for c in cache]


def slot_gather(cache, slot: torch.Tensor):
    """The rows of slot ``slot`` (a 0-d device index: no host read, so a
    captured CUDA graph reads it at replay) of every layer's entry (None
    stays None), as copies of batch 1. A prefill into them changes the
    copies; :func:`slot_scatter` writes them back."""
    idx = slot.reshape(1).long()
    return [None if c is None else type(c)(*(t.index_select(0, idx)
                                              for t in c))
            for c in cache]


def slot_scatter(cache, rows, slot: torch.Tensor):
    """Write :func:`slot_gather`'s ``rows`` back into slot ``slot`` of
    ``cache``, in place."""
    idx = slot.reshape(1).long()
    for c, r in zip(cache, rows):
        if c is not None:
            for t, u in zip(c, r):
                t.index_copy_(0, idx, u)


def prefix_views(c, n: int):
    """The first ``n`` positions of one layer's slab cache as views."""
    return type(c)(*(t[:, :n] for t in c))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _reduce_heads(out, ctx):
    """Sum a head-sharded out-projection over the tensor-parallel ranks."""
    if ctx is not None and ctx.sharded("heads"):
        return ctx.reduce_from_model(out)
    return out


def _qk_norm(q, k, params, eps):
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"], eps)
        k = rms_norm(k, params["k_norm"], eps)
    return q, k


def _enter_heads(params, x, ctx, whole):
    """(params, x) as a head-sharded block reads them: ``x`` and the
    ``whole`` leaves (every rank holds them whole) through
    ``ctx.copy_to_model``, so their gradients sum over the ranks; as they
    are where the heads stay whole (or without a context)."""
    if ctx is None or not ctx.sharded("heads"):
        return params, x
    return ctx.copy_leaves(params, whole), ctx.copy_to_model(x)


def _gqa_scores(q, k):
    """q (B,Sq,H,Dh), k (B,Sk,G,Dh) -> fp32 scores (B,G,H/G,Sq,Sk)."""
    B, Sq, H, Dh = q.shape
    G = k.shape[2]
    q = q.reshape(B, Sq, G, H // G, Dh)
    return torch.einsum("bsgrd,btgd->bgrst", q.float(), k.float())


def _gqa_combine(probs, v):
    """probs (B,G,R,Sq,Sk), v (B,Sk,G,Dh) -> (B,Sq,H,Dh) fp32."""
    B, G, R, Sq, _ = probs.shape
    out = torch.einsum("bgrst,btgd->bsgrd", probs, v.float())
    return out.reshape(B, Sq, G * R, v.shape[-1])


def _softmax(scores, mask):
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    return torch.softmax(scores.float(), dim=-1)


def _span_softmax(scores, mask):
    """One span's softmax: fp32 scores (..., Sk) masked by ``mask`` ->
    (the probabilities normalised over the span, their natural-log
    log-sum-exp (...)); a row with no valid key in the span gives zeros
    and -inf."""
    s = torch.where(mask, scores.float(), torch.full_like(scores, NEG_INF))
    m = s.amax(dim=-1)
    live = m > MASKED_M_THRESHOLD
    p = torch.where(live[..., None], torch.exp(s - m[..., None]),
                    torch.zeros_like(s))
    l = p.sum(dim=-1)
    lse = torch.where(live, m + torch.log(l),
                      torch.full_like(m, float("-inf")))
    return p / l.clamp(min=DENOM_EPS)[..., None], lse


def _partial_attend(scores, mask, v):
    """One span's share of a context-parallel decode: fp32 scores
    (B,G,R,Sq,Sk) masked by ``mask`` over v (B,Sk,G,Dh) -> (its normalised
    output (B,Sq,H,Dh) fp32, its natural-log log-sum-exp (B,Sq,H)); a row
    with no valid key in the span gives zeros and -inf."""
    probs, lse = _span_softmax(scores, mask)
    B, G, R, Sq = lse.shape
    return (_gqa_combine(probs, v),
            lse.permute(0, 3, 1, 2).reshape(B, Sq, G * R))


def _seq_layout(cache, ctx):
    """(sequence group size, the span's first key, the whole sequence's
    keys) of a slab or ring ``cache`` (AttnCache or MLACache) as this rank
    holds it."""
    seq = 1 if ctx is None else ctx.seq
    whole = cache[0].shape[1] * seq
    return seq, (0 if seq == 1 else ctx.seq_span(whole)[0]), whole


def _own_slot(slot, base: int, span: int, active_mask):
    """(the span-local write slot, the write mask): a row writes only
    where its slot lies in this rank's span ``base .. base + span - 1``
    (and it is active); others write their old entry back in place."""
    own = (slot >= base) & (slot < base + span)
    mask = own if active_mask is None else active_mask & own
    return (slot - base).clamp(0, span - 1), mask


def _blockwise_gqa(q, k, v, positions, mask_fn):
    """Memory-efficient attention: loop over query blocks so only one
    (B, H, block_q, Sk) score tile is ever live.

    q (B,Sq,H,Dh) pre-RoPE'd; positions (B,Sq); mask_fn(qpos_blk) -> bool
    (B, bq, Sk).
    """
    B, Sq, H, Dh = q.shape
    outs = []
    for s0 in range(0, Sq, ATTN_BLOCK_Q):
        qx = q[:, s0:s0 + ATTN_BLOCK_Q]
        px = positions[:, s0:s0 + ATTN_BLOCK_Q]
        scores = _gqa_scores(qx, k) / (Dh ** 0.5)
        probs = _softmax(scores, mask_fn(px)[:, None, None, :, :])
        outs.append(_gqa_combine(probs, v).to(q.dtype))
    return torch.cat(outs, dim=1)


def _project_qkv(params, cfg: ArchConfig, x, positions, ctx=None):
    params, x = _enter_heads(params, x, ctx, ("q_norm", "k_norm"))
    q = torch.einsum("bsd,dhe->bshe", x, params["w_q"])
    k = torch.einsum("bsd,dge->bsge", x, params["w_k"])
    v = torch.einsum("bsd,dge->bsge", x, params["w_v"])
    q, k = _qk_norm(q, k, params, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def make_prefill_mask(Sq: int, Sk: int, *, prefix_len: int = 0,
                      window: Optional[int] = None, q_offset: int = 0,
                      device=None) -> torch.Tensor:
    """(Sq, Sk) boolean mask. Causal, optionally prefix-bidirectional
    and/or sliding-window. ``q_offset`` shifts query positions (chunked
    prefill: queries are the tail of the key range)."""
    qpos = torch.arange(Sq, device=device) + q_offset
    kpos = torch.arange(Sk, device=device)
    mask = kpos[None, :] <= qpos[:, None]
    if prefix_len > 0:
        mask = mask | (kpos[None, :] < prefix_len)
    if window is not None:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    return mask


def _attend(q, k, v, positions, mask_fn, out_dtype):
    """Masked attention of q (B,Sq,H,Dh) over k/v (B,Sk,G,Dh), in query
    blocks of ATTN_BLOCK_Q when Sq is larger. mask_fn(px) -> (B, bq, Sk)."""
    if q.shape[1] > ATTN_BLOCK_Q:
        return _blockwise_gqa(q, k, v, positions, mask_fn)
    scores = _gqa_scores(q, k) / (q.shape[-1] ** 0.5)
    probs = _softmax(scores, mask_fn(positions)[:, None, None, :, :])
    return _gqa_combine(probs, v).to(out_dtype)


# ---------------------------------------------------------------------------
# Slab cache (one contiguous row per slot)
# ---------------------------------------------------------------------------
def gqa_prefill(params, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor, *, prefix_len: int = 0,
                window: Optional[int] = None, ctx=None):
    """Full-sequence attention. Returns (out, AttnCache of the new K/V)."""
    q, k, v = _project_qkv(params, cfg, x, positions, ctx=ctx)
    Sq, Sk = q.shape[1], k.shape[1]
    if Sq > ATTN_BLOCK_Q:
        kpos = torch.arange(Sk, device=x.device)

        def mask_fn(px):
            m = kpos[None, None, :] <= px[:, :, None]
            if prefix_len > 0:
                m = m | (kpos[None, None, :] < prefix_len)
            if window is not None:
                m = m & (kpos[None, None, :] > px[:, :, None] - window)
            return m & (px[:, :, None] >= 0)
    else:
        mask = make_prefill_mask(Sq, Sk, prefix_len=prefix_len,
                                 window=window, device=x.device)

        def mask_fn(px):
            return mask[None]

    out = _attend(q, k, v, positions, mask_fn, x.dtype)
    out = torch.einsum("bshe,hed->bsd", out, params["w_o"])
    return _reduce_heads(out, ctx), AttnCache(k=k, v=v)


def _slab_write(cache: AttnCache, slot: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, active_mask: Optional[torch.Tensor]):
    """Write one token's K/V (B, G, Dh) per slab row at ``slot`` (B,), in
    place. Rows off ``active_mask`` keep the entry they had: a retired
    slot's stale position may point into a row now owned by a mid-prefill
    request, so its write must not stick. (The reference writes every row
    and then takes a ``where`` over the whole slab; masking the one entry
    gives the same cache.)"""
    bidx = torch.arange(slot.shape[0], device=slot.device)
    k, v = k.to(cache.k.dtype), v.to(cache.v.dtype)
    if active_mask is not None:
        keep = active_mask[:, None, None]
        k = torch.where(keep, k, cache.k[bidx, slot])
        v = torch.where(keep, v, cache.v[bidx, slot])
    cache.k[bidx, slot] = k
    cache.v[bidx, slot] = v


def gqa_decode(params, cfg: ArchConfig, x: torch.Tensor, cache: AttnCache,
               pos: torch.Tensor, *, sliding: bool = False,
               active_mask: Optional[torch.Tensor] = None, ctx=None):
    """One-token decode. x (B,1,D); pos (B,) = index of the new token.

    Full cache: write at ``pos``, attend over 0..pos.
    Sliding (ring buffer of width W): write at ``pos % W``; a slot s holds
    absolute position pos - ((pos - s) mod W), valid iff that is >= 0.
    The new K/V is written into the cache in place, except for rows off
    ``active_mask`` (the port's argument; see :func:`_slab_write`).
    Under a sequence group the cache is this rank's span of the sequence
    or ring (slots are global key indices; see the module docstring).
    """
    seq, base, W = _seq_layout(cache, ctx)
    span = cache.k.shape[1]
    q, k, v = _project_qkv(params, cfg, x, pos[:, None], ctx=ctx)
    pos = pos.long()
    slot = (pos % W) if sliding else pos
    if seq > 1:
        slot, active_mask = _own_slot(slot, base, span, active_mask)
    _slab_write(cache, slot, k[:, 0], v[:, 0], active_mask)

    # read path: cast (no-op when the cache holds the compute dtype)
    k_read = cache.k.to(q.dtype)
    v_read = cache.v.to(q.dtype)
    scores = _gqa_scores(q, k_read) / (cfg.head_dim ** 0.5)
    slots = base + torch.arange(span, device=x.device)
    if sliding:
        valid = ((pos[:, None] - slots[None, :]) % W) <= pos[:, None]
    else:
        valid = slots[None, :] <= pos[:, None]
    if seq == 1:
        probs = _softmax(scores, valid[:, None, None, None, :])
        out = _gqa_combine(probs, v_read).to(x.dtype)
    else:
        out, lse = _partial_attend(scores, valid[:, None, None, None, :],
                                   v_read)
        out = ctx.combine_partials(out, lse).to(x.dtype)
    out = torch.einsum("bshe,hed->bsd", out, params["w_o"])
    return _reduce_heads(out, ctx), cache


def gqa_prefill_cached(params, cfg: ArchConfig, x: torch.Tensor,
                       positions: torch.Tensor, cache: AttnCache, *,
                       window: Optional[int] = None, prefix_len: int = 0,
                       ctx=None):
    """Chunked prefill: write this chunk's K/V into the cache slab, then
    attend chunk queries against the slab (previous chunks + chunk).

    positions (B, L) are absolute. Slab slots beyond the chunk are masked
    out causally. Sliding mode uses the ring-buffer mapping: slot s holds absolute
    position Pmax - ((Pmax - s) mod W) where Pmax is the last written
    position. The slab is written in place.
    """
    B, L, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, positions, ctx=ctx)
    W = cache.k.shape[1]
    bidx = torch.arange(B, device=x.device)[:, None]
    kslot = torch.arange(W, device=x.device)
    positions = positions.long()
    if window:
        # Two-phase sliding attention: chunk queries attend the PRE-update
        # ring (positions <= start-1) plus the in-chunk K/V — writing first
        # would overwrite in-window keys of early chunk queries. Exact for
        # any chunk length; the ring is updated afterwards.
        start = positions[:, :1]                           # (B,1)
        pmax_old = start - 1
        abs_old = pmax_old - ((pmax_old - kslot[None, :]) % W)   # (B, W)
        k_cat = torch.cat([cache.k.to(k.dtype), k], dim=1)
        v_cat = torch.cat([cache.v.to(v.dtype), v], dim=1)

        def mask_fn(px):
            old = (abs_old[:, None, :] <= px[:, :, None]) \
                & (abs_old[:, None, :] > px[:, :, None] - window) \
                & (abs_old[:, None, :] >= 0)
            new = (positions[:, None, :] <= px[:, :, None]) \
                & (positions[:, None, :] > px[:, :, None] - window)
            return torch.cat([old, new], dim=-1) & (px[:, :, None] >= 0)

        out = _attend(q, k_cat, v_cat, positions, mask_fn, x.dtype)
        # only the chunk's last W positions survive in the ring: writing
        # just those keeps the in-place scatter free of duplicate slots
        tail = slice(max(0, L - W), L)
        slots = positions[:, tail] % W
        cache.k[bidx, slots] = k[:, tail].to(cache.k.dtype)
        cache.v[bidx, slots] = v[:, tail].to(cache.v.dtype)
    else:
        cache.k[bidx, positions] = k.to(cache.k.dtype)
        cache.v[bidx, positions] = v.to(cache.v.dtype)

        def mask_fn(px):
            m = kslot[None, None, :] <= px[:, :, None]
            if prefix_len > 0:
                m = m | (kslot[None, None, :] < prefix_len)
            return m & (px[:, :, None] >= 0)

        out = _attend(q, cache.k.to(q.dtype), cache.v.to(q.dtype),
                      positions, mask_fn, x.dtype)
    out = torch.einsum("bshe,hed->bsd", out, params["w_o"])
    return _reduce_heads(out, ctx), cache


def gqa_decode_kernel(params, cfg: ArchConfig, x: torch.Tensor,
                      cache: AttnCache, pos: torch.Tensor, *,
                      block_k: int = 128,
                      active_mask: Optional[torch.Tensor] = None,
                      ctx=None):
    """Decode attention routed through the fused duet-attention kernel
    (``kernels.duet_attention``, the CUDA kernel on the card and its plain
    version on the CPU): each active request is one decode row over its
    slab slot — the engine's kernel path. Semantically identical to
    :func:`gqa_decode` (full cache, no sliding). Under a sequence group
    the kernel runs over this rank's span, each row's position shifted by
    the span's first key, and returns its log-sum-exp; the group's
    partials are combined before the out-projection."""
    B = x.shape[0]
    seq, base, _ = _seq_layout(cache, ctx)
    span = cache.k.shape[1]
    q, k, v = _project_qkv(params, cfg, x, pos[:, None], ctx=ctx)
    bidx = torch.arange(B, device=x.device)
    slot = pos.long()
    if seq > 1:
        slot, active_mask = _own_slot(slot, base, span, active_mask)
    _slab_write(cache, slot, k[:, 0], v[:, 0], active_mask)
    # one tile per decode row (block_q=1): tile_slot = batch index
    row_pos = (pos.long() - base)[:, None].to(torch.int32).contiguous()
    rows = kernel_ops.duet_attention(
        q[:, 0].contiguous(), row_pos, bidx.to(torch.int32),
        cache.k.to(q.dtype), cache.v.to(q.dtype), block_q=1,
        block_k=min(block_k, span), return_lse=seq > 1)
    if seq > 1:
        rows = ctx.combine_partials(*rows).to(x.dtype)
    out = torch.einsum("bhe,hed->bd", rows, params["w_o"])[:, None, :]
    return _reduce_heads(out, ctx), cache


# ---------------------------------------------------------------------------
# Paged KV (PagedAttention layout). Device pools come from
# repro_torch.serving.kvcache (init_page_pools); the helpers here derive
# (page, slot) addresses from per-request block tables.
# ---------------------------------------------------------------------------
def _paged_write(pages: torch.Tensor, new: torch.Tensor,
                 table: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Scatter per-token values (B, T, ...) into ``pages`` in place at the
    addresses implied by absolute ``positions`` (B, T) and block ``table``
    (B, P). Rows whose table is all zeros (inactive slots) land in the
    reserved null page 0 and are never read back unmasked — so duplicate
    addresses there (a nondeterministic ``index_put_``) are harmless."""
    P = table.shape[1]
    ps = pages.shape[1]
    positions = positions.long()
    pidx = (positions // ps).clamp(0, P - 1)
    page_ids = torch.gather(table.long(), 1, pidx)
    offs = positions % ps
    flat = new.reshape((-1,) + tuple(new.shape[2:]))
    pages.index_put_((page_ids.reshape(-1), offs.reshape(-1)),
                     flat.to(pages.dtype))
    return pages


def _paged_gather(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(pages (N,ps,...), table (B,P)) -> (B, P*ps, ...). A request's pages
    are table-ordered and filled densely, so flat index t == absolute
    position t."""
    B, P = table.shape
    ps = pages.shape[1]
    return pages[table.long()].reshape((B, P * ps) + tuple(pages.shape[2:]))


def gqa_decode_paged(params, cfg: ArchConfig, x: torch.Tensor,
                     k_pages: torch.Tensor, v_pages: torch.Tensor,
                     table: torch.Tensor, pos: torch.Tensor, *,
                     use_kernel: bool = False, split_kv_threshold: int = 0,
                     ctx=None):
    """One-token decode against the paged KV pool.

    x (B,1,D); table (B,P) int32 page ids; pos (B,) absolute write position.
    The page covering ``pos`` must already be allocated — the engine's
    look-ahead reservation (§4.3) guarantees it for all k fused steps, so
    ``table`` is constant inside the fused decode program. ``use_kernel``
    routes the read through the kernel dispatcher (``ops.paged_decode_auto``
    — the CUDA kernels on the card, their plain versions on the CPU);
    ``split_kv_threshold`` (tokens of table capacity) selects the split-KV
    kernel above it; where TP cuts the KV heads the dispatcher runs the
    sharded route on this rank's heads.
    """
    q, k, v = _project_qkv(params, cfg, x, pos[:, None], ctx=ctx)
    _paged_write(k_pages, k, table, pos[:, None])
    _paged_write(v_pages, v, table, pos[:, None])
    lengths = (pos + 1).to(torch.int32)
    if use_kernel:
        rows = kernel_ops.paged_decode_auto(
            q[:, 0].contiguous(), k_pages.to(q.dtype), v_pages.to(q.dtype),
            table.to(torch.int32).contiguous(), lengths, ctx=ctx,
            split_threshold=split_kv_threshold)
    else:
        kg = _paged_gather(k_pages, table).to(q.dtype)
        vg = _paged_gather(v_pages, table).to(q.dtype)
        scores = _gqa_scores(q, kg) / (cfg.head_dim ** 0.5)
        kpos = torch.arange(kg.shape[1], device=x.device)
        valid = kpos[None, :] < lengths[:, None]
        probs = _softmax(scores, valid[:, None, None, None, :])
        rows = _gqa_combine(probs, vg).to(x.dtype)[:, 0]
    out = torch.einsum("bhe,hed->bd", rows, params["w_o"])[:, None, :]
    return _reduce_heads(out, ctx), (k_pages, v_pages)


def gqa_prefill_paged(params, cfg: ArchConfig, x: torch.Tensor,
                      positions: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, table: torch.Tensor, *,
                      ctx=None):
    """Chunked prefill against the paged pool: write the chunk's K/V into
    the request's pages, attend chunk queries over the gathered table
    (previous chunks + this chunk). x (B,L,D); positions (B,L) absolute."""
    q, k, v = _project_qkv(params, cfg, x, positions, ctx=ctx)
    _paged_write(k_pages, k, table, positions)
    _paged_write(v_pages, v, table, positions)
    kg = _paged_gather(k_pages, table).to(q.dtype)
    vg = _paged_gather(v_pages, table).to(q.dtype)
    kpos = torch.arange(kg.shape[1], device=x.device)

    def mask_fn(px):
        return (kpos[None, None, :] <= px[:, :, None]) \
            & (px[:, :, None] >= 0)

    out = _attend(q, kg, vg, positions, mask_fn, x.dtype)
    out = torch.einsum("bshe,hed->bsd", out, params["w_o"])
    return _reduce_heads(out, ctx), (k_pages, v_pages)


def duet_packing(order: torch.Tensor, pos: torch.Tensor, block_q: int):
    """The tile layout of a duet schedule, as device index tensors (no host
    sync): ``order`` (T*block_q,) the schedule's ``row_src`` (-1 = pad),
    ``pos`` (R,) the rows' positions. Returns (src: the source row of each
    tile row, pads reading row 0; row_pos (T*block_q, 1) int32, -1 at pads;
    tile_slot (T,) int32, each tile's first row, whose table row is the
    tile's chain; dst: where each tile row goes back, pads to a spare row
    R)."""
    order = order.long()
    live = order >= 0
    src = order.clamp(min=0)
    row_pos = torch.where(live, pos.index_select(0, src).long(),
                          torch.full_like(src, -1))
    tile_slot = order.view(-1, block_q)[:, 0]
    dst = torch.where(live, order, torch.full_like(order, pos.shape[0]))
    return (src, row_pos[:, None].to(torch.int32).contiguous(),
            tile_slot.to(torch.int32).contiguous(), dst)


def gqa_duet_paged(params, cfg: ArchConfig, x: torch.Tensor,
                   k_pages: torch.Tensor, v_pages: torch.Tensor,
                   table: torch.Tensor, pos: torch.Tensor, packing, *,
                   ctx=None):
    """Mixed-phase duet step over the paged pool (Algorithm 1 on-device).

    ``x`` (R,1,D) holds R combined rows — decode rows (one token each, own
    table row) followed by the prefill chunk's rows (successive positions,
    shared table row). All rows' K/V scatter into their pages first, then
    every row attends causally over its chain (``k_pos <= pos``), so chunk
    row i sees rows 0..i — chunked prefill and the decode steps execute as
    ONE ``duet_attention_paged`` launch. ``packing`` is
    :func:`duet_packing` of the Algorithm-1 schedule (T tiles of block_q
    rows); the tile size is its rows over its tiles. The numerics do not
    depend on the layout. Packing and unpacking are index ops on the device
    (no host sync); a pad row's query is never read.
    """
    q, k, v = _project_qkv(params, cfg, x, pos[:, None], ctx=ctx)
    _paged_write(k_pages, k, table, pos[:, None])
    _paged_write(v_pages, v, table, pos[:, None])
    src, row_pos, tile_slot, dst = packing
    rows = kernel_ops.duet_attention_paged(
        q[:, 0].index_select(0, src), row_pos, tile_slot,
        k_pages.to(q.dtype), v_pages.to(q.dtype),
        table.to(torch.int32).contiguous(),
        block_q=src.shape[0] // tile_slot.shape[0])
    # undo the packing: live rows to their source rows, pads to the spare
    # row R, dropped
    R = q.shape[0]
    rows = rows.new_empty((R + 1,) + rows.shape[1:]).index_copy_(
        0, dst, rows)[:R]
    out = torch.einsum("bhe,hed->bd", rows, params["w_o"])[:, None, :]
    return _reduce_heads(out, ctx), (k_pages, v_pages)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------
def _mla_scale(cfg: ArchConfig) -> float:
    return 1.0 / (cfg.qk_nope_dim + cfg.qk_rope_dim) ** 0.5


def _mla_qkv_prefill(params, cfg: ArchConfig, x, positions, ctx=None):
    """x (B,S,D) -> q_nope (B,S,H,nope), q_rope (B,S,H,rope) with RoPE, the
    normalised latent ckv (B,S,r) and the one-head rope key krope
    (B,S,rope) with RoPE. Under TP the latent's projection, its norm and
    the rope key's projection are whole leaves read by the rank's heads
    (:func:`_enter_heads`)."""
    params, x = _enter_heads(params, x, ctx,
                             ("w_dkv", "kv_norm", "w_krope"))
    nope = cfg.qk_nope_dim
    q = torch.einsum("bsd,dhe->bshe", x, params["w_q"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv = rms_norm(x @ params["w_dkv"], params["kv_norm"], cfg.norm_eps)
    krope = apply_rope((x @ params["w_krope"])[:, :, None, :], positions,
                       cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, ckv, krope


def _mla_attend(cfg: ArchConfig, q_nope, q_rope, k_nope, v, krope,
                positions):
    """MLA attention of q (B,Sq,H,·) over the expanded k_nope / v
    (B,Sk,H,·) and the shared krope (B,Sk,rope), causal on ``positions``
    (B,Sq) (a row at position -1 sees nothing), in query blocks of
    ATTN_BLOCK_Q when Sq is larger. fp32 scores; out in q's dtype."""
    Sq, Sk = q_nope.shape[1], k_nope.shape[1]
    scale = _mla_scale(cfg)
    kpos = torch.arange(Sk, device=q_nope.device)
    kn, kr, vf = k_nope.float(), krope.float(), v.float()

    def core(qn, qr, px):
        scores = (torch.einsum("bshe,bthe->bhst", qn.float(), kn)
                  + torch.einsum("bshe,bte->bhst", qr.float(), kr)) * scale
        mask = (kpos[None, None, :] <= px[:, :, None]) \
            & (px[:, :, None] >= 0)
        probs = _softmax(scores, mask[:, None, :, :])
        return torch.einsum("bhst,bthe->bshe", probs, vf).to(q_nope.dtype)

    return torch.cat([core(q_nope[:, s0:s0 + ATTN_BLOCK_Q],
                           q_rope[:, s0:s0 + ATTN_BLOCK_Q],
                           positions[:, s0:s0 + ATTN_BLOCK_Q])
                      for s0 in range(0, Sq, ATTN_BLOCK_Q)], dim=1)


def _mla_expand_attend(params, cfg: ArchConfig, x, q_nope, q_rope, ckv,
                       krope, positions):
    """Expand the latents (B,Sk,r) to per-head K/V and attend: the prefill
    paths' shared tail, through the output projection."""
    B, L = x.shape[:2]
    k_nope = torch.einsum("btr,rhe->bthe", ckv, params["w_uk"])
    v = torch.einsum("btr,rhe->bthe", ckv, params["w_uv"])
    out = _mla_attend(cfg, q_nope, q_rope, k_nope, v, krope, positions)
    return out.reshape(B, L, -1) @ params["w_o"]


def mla_prefill(params, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor, *, ctx=None):
    """Full-sequence MLA. Returns (out, MLACache of the new latents)."""
    q_nope, q_rope, ckv, krope = _mla_qkv_prefill(params, cfg, x, positions,
                                                  ctx=ctx)
    out = _mla_expand_attend(params, cfg, x, q_nope, q_rope, ckv, krope,
                             positions)
    return _reduce_heads(out, ctx), MLACache(ckv=ckv, krope=krope)


def mla_prefill_cached(params, cfg: ArchConfig, x: torch.Tensor,
                       positions: torch.Tensor, cache: MLACache, *,
                       ctx=None):
    """Chunked MLA prefill: write the chunk's latents into the slab (in
    place), then attend the chunk's queries over the slab."""
    B = x.shape[0]
    q_nope, q_rope, ckv_new, krope_new = _mla_qkv_prefill(params, cfg, x,
                                                          positions)
    bidx = torch.arange(B, device=x.device)[:, None]
    positions = positions.long()
    cache.ckv[bidx, positions] = ckv_new.to(cache.ckv.dtype)
    cache.krope[bidx, positions] = krope_new.to(cache.krope.dtype)
    out = _mla_expand_attend(params, cfg, x, q_nope, q_rope,
                             cache.ckv.to(x.dtype), cache.krope.to(x.dtype),
                             positions)
    return _reduce_heads(out, ctx), cache


def _mla_decode_core(params, cfg: ArchConfig, x, q_nope, q_rope, ckv,
                     krope, valid, absorb: bool):
    """One-token MLA attention over (gathered) latents ckv (B,S,r) and
    krope (B,S,rope); ``valid`` (B,1,1,S). ``absorb`` folds W_uk into the
    query and W_uv into the output, so the scores and the context stay in
    the r-dim latent space; otherwise every cached latent is expanded to
    per-head K/V."""
    B = x.shape[0]
    scale = _mla_scale(cfg)
    rope_scores = torch.einsum("bshe,bte->bhst", q_rope.float(),
                               krope.float())
    if absorb:
        q_lat = torch.einsum("bshe,rhe->bshr", q_nope, params["w_uk"])
        scores = (torch.einsum("bshr,btr->bhst", q_lat.float(), ckv.float())
                  + rope_scores) * scale
        probs = _softmax(scores, valid)
        lat = torch.einsum("bhst,btr->bshr", probs, ckv.float())
        out = torch.einsum("bshr,rhe->bshe", lat.to(x.dtype),
                           params["w_uv"])
    else:
        k_nope = torch.einsum("btr,rhe->bthe", ckv, params["w_uk"])
        v = torch.einsum("btr,rhe->bthe", ckv, params["w_uv"])
        scores = (torch.einsum("bshe,bthe->bhst", q_nope.float(),
                               k_nope.float()) + rope_scores) * scale
        probs = _softmax(scores, valid)
        out = torch.einsum("bhst,bthe->bshe", probs,
                           v.float()).to(x.dtype)
    return out.reshape(B, 1, -1) @ params["w_o"]


def _mla_decode_span(params, cfg: ArchConfig, x, q_nope, q_rope, ckv,
                     krope, valid, ctx):
    """One-token MLA attention over this rank's span of the latents
    (B,S_local,r | rope), ``valid`` (B,1,1,S_local) by the global key
    index, in the latent space: the rank's heads' absorbed queries
    (q_nope . w_uk, q_rope) gathered over the model group, so every rank
    holds every head's (``ctx.gather_heads``); every head's partial over
    the span (fp32 scores, a normalised latent output (B,1,H,r) and its
    log-sum-exp); the sequence group's partials combined
    (``ctx.combine_partials``); then the rank's own heads through
    ``w_uv`` and its rows of ``w_o``."""
    B = x.shape[0]
    scale = _mla_scale(cfg)
    q_lat = torch.einsum("bshe,rhe->bshr", q_nope, params["w_uk"])
    r = q_lat.shape[-1]
    q = ctx.gather_heads(torch.cat([q_lat, q_rope], dim=-1), dim=2)
    q_lat, q_rope = q[..., :r], q[..., r:]
    rope_scores = torch.einsum("bshe,bte->bhst", q_rope.float(),
                               krope.float())
    scores = (torch.einsum("bshr,btr->bhst", q_lat.float(), ckv.float())
              + rope_scores) * scale
    probs, lse = _span_softmax(scores, valid)
    lat = torch.einsum("bhst,btr->bshr", probs, ckv.float())
    lat = ctx.combine_partials(lat, lse.transpose(1, 2))
    h = params["w_uv"].shape[1]
    h0 = ctx.rank * h if ctx.sharded("heads") else 0
    out = torch.einsum("bshr,rhe->bshe", lat[:, :, h0:h0 + h].to(x.dtype),
                       params["w_uv"])
    return out.reshape(B, 1, -1) @ params["w_o"]


def mla_decode(params, cfg: ArchConfig, x: torch.Tensor, cache: MLACache,
               pos: torch.Tensor, *, absorb: bool = False,
               active_mask: Optional[torch.Tensor] = None, ctx=None):
    """One-token MLA decode against the slab latents. x (B,1,D); pos (B,).
    The new latent is written at ``pos`` in place, except for rows off
    ``active_mask`` (see :func:`_slab_write`).

    Under a sequence group (``ctx.seq`` > 1) the slab is this rank's span
    of the latent sequence (the module docstring): only the rank whose
    span holds ``pos`` writes, and the step runs in the latent space
    (:func:`_mla_decode_span`) whatever ``absorb`` says, since the
    expanded path needs every head's ``w_uk`` / ``w_uv`` against every
    span and a TP rank holds only its heads'. The two paths are equal up
    to rounding."""
    B = x.shape[0]
    q_nope, q_rope, ckv_new, krope_new = _mla_qkv_prefill(
        params, cfg, x, pos[:, None])
    seq, base, _ = _seq_layout(cache, ctx)
    span = cache.ckv.shape[1]
    pos = pos.long()
    slot = pos
    if seq > 1:
        slot, active_mask = _own_slot(pos, base, span, active_mask)
    bidx = torch.arange(B, device=x.device)
    ckv_new = ckv_new[:, 0].to(cache.ckv.dtype)
    krope_new = krope_new[:, 0].to(cache.krope.dtype)
    if active_mask is not None:
        keep = active_mask[:, None]
        ckv_new = torch.where(keep, ckv_new, cache.ckv[bidx, slot])
        krope_new = torch.where(keep, krope_new, cache.krope[bidx, slot])
    cache.ckv[bidx, slot] = ckv_new
    cache.krope[bidx, slot] = krope_new
    keys = base + torch.arange(span, device=x.device)
    valid = (keys[None, :] <= pos[:, None])[:, None, None, :]
    ckv, krope = cache.ckv.to(x.dtype), cache.krope.to(x.dtype)
    if seq == 1:
        out = _mla_decode_core(params, cfg, x, q_nope, q_rope, ckv, krope,
                               valid, absorb)
    else:
        out = _mla_decode_span(params, cfg, x, q_nope, q_rope, ckv, krope,
                               valid, ctx)
    return _reduce_heads(out, ctx), cache


def mla_decode_paged(params, cfg: ArchConfig, x: torch.Tensor,
                     ckv_pages: torch.Tensor, krope_pages: torch.Tensor,
                     table: torch.Tensor, pos: torch.Tensor, *,
                     absorb: bool = False, ctx=None):
    """One-token MLA decode against the paged latent pools
    (ckv_pages (N,ps,r), krope_pages (N,ps,rope)), written in place."""
    q_nope, q_rope, ckv_new, krope_new = _mla_qkv_prefill(
        params, cfg, x, pos[:, None])
    _paged_write(ckv_pages, ckv_new, table, pos[:, None])
    _paged_write(krope_pages, krope_new, table, pos[:, None])
    ckv = _paged_gather(ckv_pages, table).to(x.dtype)
    krope = _paged_gather(krope_pages, table).to(x.dtype)
    S = ckv.shape[1]
    valid = (torch.arange(S, device=x.device)[None, :]
             <= pos.long()[:, None])[:, None, None, :]
    out = _mla_decode_core(params, cfg, x, q_nope, q_rope, ckv, krope,
                           valid, absorb)
    return _reduce_heads(out, ctx), (ckv_pages, krope_pages)


def mla_prefill_paged(params, cfg: ArchConfig, x: torch.Tensor,
                      positions: torch.Tensor, ckv_pages: torch.Tensor,
                      krope_pages: torch.Tensor, table: torch.Tensor, *,
                      ctx=None):
    """Chunked MLA prefill against the paged latent pools: write the
    chunk's latents into the request's pages, attend over the gathered
    table. x (B,L,D); positions (B,L) absolute."""
    q_nope, q_rope, ckv_new, krope_new = _mla_qkv_prefill(params, cfg, x,
                                                          positions)
    _paged_write(ckv_pages, ckv_new, table, positions)
    _paged_write(krope_pages, krope_new, table, positions)
    ckv = _paged_gather(ckv_pages, table).to(x.dtype)
    krope = _paged_gather(krope_pages, table).to(x.dtype)
    out = _mla_expand_attend(params, cfg, x, q_nope, q_rope, ckv, krope,
                             positions.long())
    return _reduce_heads(out, ctx), (ckv_pages, krope_pages)
