"""GQA attention over the paged KV pool — the serving engine's paths.

Ports the paged GQA subset of the reference's ``repro.models.attention``:
chunked prefill (:func:`gqa_prefill_paged`), one-token decode with the
kernel hook (:func:`gqa_decode_paged`) and the fused mixed-phase duet step
(:func:`gqa_duet_paged`). The attention math stays plain tensor math as in
the reference (einsum + softmax); the decode and duet reads may go through
the CUDA kernels in ``repro_torch.kernels``.

The page pools are updated IN PLACE (the reference is functional): each
function writes the new K/V into the tensors it is given and returns the
same tensors. Scores and probabilities are fp32.

Shapes: x (B, S, D); q (B, S, H, Dh); kv (B, S, G, Dh); positions (B, S).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ops import NEG_INF
from repro_torch.models.layers import apply_rope, rms_norm

ATTN_BLOCK_Q = 1024  # query-block size for memory-efficient attention


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _qk_norm(q, k, params, eps):
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"], eps)
        k = rms_norm(k, params["k_norm"], eps)
    return q, k


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


def _project_qkv(params, cfg: ArchConfig, x, positions):
    q = torch.einsum("bsd,dhe->bshe", x, params["w_q"])
    k = torch.einsum("bsd,dge->bsge", x, params["w_k"])
    v = torch.einsum("bsd,dge->bsge", x, params["w_v"])
    q, k = _qk_norm(q, k, params, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


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
                     use_kernel: bool = False, split_kv_threshold: int = 0):
    """One-token decode against the paged KV pool.

    x (B,1,D); table (B,P) int32 page ids; pos (B,) absolute write position.
    The page covering ``pos`` must already be allocated — the engine's
    look-ahead reservation (§4.3) guarantees it for all k fused steps, so
    ``table`` is constant inside the fused decode program. ``use_kernel``
    routes the read through the kernel dispatcher (``ops.paged_decode_auto``
    — the CUDA kernels on the card, their plain versions on the CPU);
    ``split_kv_threshold`` (tokens of table capacity) selects the split-KV
    kernel above it.
    """
    q, k, v = _project_qkv(params, cfg, x, pos[:, None])
    _paged_write(k_pages, k, table, pos[:, None])
    _paged_write(v_pages, v, table, pos[:, None])
    lengths = (pos + 1).to(torch.int32)
    if use_kernel:
        rows = kernel_ops.paged_decode_auto(
            q[:, 0].contiguous(), k_pages.to(q.dtype), v_pages.to(q.dtype),
            table.to(torch.int32).contiguous(), lengths,
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
    return out, (k_pages, v_pages)


def gqa_prefill_paged(params, cfg: ArchConfig, x: torch.Tensor,
                      positions: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, table: torch.Tensor):
    """Chunked prefill against the paged pool: write the chunk's K/V into
    the request's pages, attend chunk queries over the gathered table
    (previous chunks + this chunk). x (B,L,D); positions (B,L) absolute."""
    q, k, v = _project_qkv(params, cfg, x, positions)
    _paged_write(k_pages, k, table, positions)
    _paged_write(v_pages, v, table, positions)
    kg = _paged_gather(k_pages, table).to(q.dtype)
    vg = _paged_gather(v_pages, table).to(q.dtype)
    kpos = torch.arange(kg.shape[1], device=x.device)

    def mask_fn(px):
        return (kpos[None, None, :] <= px[:, :, None]) \
            & (px[:, :, None] >= 0)

    if x.shape[1] > ATTN_BLOCK_Q:
        out = _blockwise_gqa(q, kg, vg, positions, mask_fn)
    else:
        scores = _gqa_scores(q, kg) / (cfg.head_dim ** 0.5)
        probs = _softmax(scores, mask_fn(positions)[:, None, None, :, :])
        out = _gqa_combine(probs, vg).to(x.dtype)
    out = torch.einsum("bshe,hed->bsd", out, params["w_o"])
    return out, (k_pages, v_pages)


def gqa_duet_paged(params, cfg: ArchConfig, x: torch.Tensor,
                   k_pages: torch.Tensor, v_pages: torch.Tensor,
                   table: torch.Tensor, pos: torch.Tensor,
                   order: torch.Tensor):
    """Mixed-phase duet step over the paged pool (Algorithm 1 on-device).

    ``x`` (R,1,D) holds R combined rows — decode rows (one token each, own
    table row) followed by the prefill chunk's rows (successive positions,
    shared table row). All rows' K/V scatter into their pages first, then
    every row attends causally over its chain (``k_pos <= pos``), so chunk
    row i sees rows 0..i — chunked prefill and the decode steps execute as
    ONE ``duet_attention_paged`` launch. ``order`` (R,) is the Algorithm-1
    tile permutation from ``ops.build_duet_schedule`` (block_q=1): tile t
    processes row ``order[t]``; numerics are order-invariant. Both the
    permutation and its undo are index ops on the device (no host sync).
    """
    q, k, v = _project_qkv(params, cfg, x, pos[:, None])
    _paged_write(k_pages, k, table, pos[:, None])
    _paged_write(v_pages, v, table, pos[:, None])
    order = order.long()
    rows = kernel_ops.duet_attention_paged(
        q[:, 0].index_select(0, order),
        pos.index_select(0, order)[:, None].to(torch.int32).contiguous(),
        order.to(torch.int32), k_pages.to(q.dtype), v_pages.to(q.dtype),
        table.to(torch.int32).contiguous(), block_q=1)
    rows = torch.empty_like(rows).index_copy_(0, order, rows)  # undo permute
    out = torch.einsum("bhe,hed->bd", rows, params["w_o"])[:, None, :]
    return out, (k_pages, v_pages)
