"""Plain PyTorch oracles for the ported kernels (the allclose targets).

Shapes follow the kernel contracts:
  flash_prefill : q (B,S,H,Dh), k/v (B,S,G,Dh), causal (+offset for chunks)
  paged_decode  : q (B,H,Dh), pages (N,ps,G,Dh), tables (B,P), lengths (B,)
  duet_attention: q rows (R,H,Dh) over a slot slab (Ns,S,G,Dh) with per-row
                  slot ids and positions (mixed prefill rows + decode rows);
                  ``duet_attention_lse_ref`` also gives each row's and
                  head's log-sum-exp (R,H), the context-parallel partial

Scores, softmax and the probability-weighted sum are fp32 whatever the
input dtype (the reference's ``preferred_element_type=float32``); the
result is cast back to q's dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ops import NEG_INF, default_sm_scale, gqa_repeat_kv


def _gqa_probs(scores, mask):
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    return torch.softmax(scores.float(), dim=-1)


def flash_prefill_ref(q, k, v, *, q_offset: int = 0):
    """Causal attention. q (B,Sq,H,Dh); k,v (B,Sk,G,Dh); queries start at
    absolute position q_offset (chunked prefill)."""
    B, Sq, H, Dh = q.shape
    G = k.shape[2]
    rep = H // G
    kr = gqa_repeat_kv(k, rep).float()
    vr = gqa_repeat_kv(v, rep).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr)
    scores = scores * default_sm_scale(Dh)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = kpos[None, :] <= qpos[:, None]
    probs = _gqa_probs(scores, mask[None, None])
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vr)
    return out.to(q.dtype)


def paged_decode_ref(q, k_pages, v_pages, tables, lengths):
    """Decode attention over paged KV.
    q (B,H,Dh); pages (N,ps,G,Dh); tables (B,P) int32; lengths (B,) int32."""
    B, H, Dh = q.shape
    N, ps, G, _ = k_pages.shape
    P = tables.shape[1]
    rep = H // G
    tbl = tables.long()
    k = k_pages[tbl].reshape(B, P * ps, G, Dh)        # (B, L, G, Dh)
    v = v_pages[tbl].reshape(B, P * ps, G, Dh)
    kr = gqa_repeat_kv(k, rep).float()
    vr = gqa_repeat_kv(v, rep).float()
    scores = torch.einsum("bhd,bkhd->bhk", q.float(), kr)
    scores = scores * default_sm_scale(Dh)
    pos = torch.arange(P * ps, device=q.device)
    mask = pos[None, :] < lengths[:, None]
    probs = _gqa_probs(scores, mask[:, None, :])
    out = torch.einsum("bhk,bkhd->bhd", probs, vr)
    return out.to(q.dtype)


def duet_attention_ref(q, row_slot, row_pos, k_slab, v_slab):
    """Fused mixed-phase attention over a slot slab.

    q (R,H,Dh): query rows — decode rows (one per active decode request) and
    prefill-chunk rows, in any interleaved order. row_slot (R,): slab slot of
    each row. row_pos (R,): absolute position (attends to slab[slot, :pos+1]).
    k_slab/v_slab (Ns,S,G,Dh): the engine's slab KV cache (chunk K/V already
    written). Rows with row_slot < 0 are padding and produce zeros.
    """
    R, H, Dh = q.shape
    Ns, S, G, _ = k_slab.shape
    rep = H // G
    slot = row_slot.long().clamp(min=0)
    k = gqa_repeat_kv(k_slab[slot], rep).float()        # (R,S,H,Dh)
    v = gqa_repeat_kv(v_slab[slot], rep).float()
    scores = torch.einsum("rhd,rkhd->rhk", q.float(), k)
    scores = scores * default_sm_scale(Dh)
    live = row_slot >= 0
    pos = torch.arange(S, device=q.device)
    mask = (pos[None, :] <= row_pos[:, None]) & live[:, None]
    probs = _gqa_probs(scores, mask[:, None, :])
    probs = torch.where(live[:, None, None], probs, torch.zeros_like(probs))
    out = torch.einsum("rhk,rkhd->rhd", probs, v)
    return out.to(q.dtype)


def duet_attention_paged_ref(q, row_slot, row_pos, k_pages, v_pages, tables):
    """Paged-pool variant of :func:`duet_attention_ref`: gather each row's
    page chain into a dense slab (flat index == absolute position, the
    engines' dense-fill invariant), then reuse the slab oracle."""
    N, ps, G, Dh = k_pages.shape
    B, P = tables.shape
    tbl = tables.long()
    k_slab = k_pages[tbl].reshape(B, P * ps, G, Dh)
    v_slab = v_pages[tbl].reshape(B, P * ps, G, Dh)
    return duet_attention_ref(q, row_slot, row_pos, k_slab, v_slab)


def duet_attention_lse_ref(q, row_slot, row_pos, k_slab, v_slab):
    """:func:`duet_attention_ref` and each row's and head's fp32 natural-log
    log-sum-exp of its scaled scores over its valid keys, (R, H): -inf for
    a padding row (``row_slot`` < 0) or one with no valid key (``row_pos``
    < 0). Returns (out, lse)."""
    Dh = q.shape[-1]
    rep = q.shape[1] // k_slab.shape[2]
    slot = row_slot.long().clamp(min=0)
    k = gqa_repeat_kv(k_slab[slot], rep).float()        # (R,S,H,Dh)
    scores = torch.einsum("rhd,rkhd->rhk", q.float(), k)
    scores = scores * default_sm_scale(Dh)
    pos = torch.arange(k_slab.shape[1], device=q.device)
    mask = (pos[None, :] <= row_pos[:, None]) & (row_slot >= 0)[:, None]
    lse = torch.logsumexp(torch.where(mask[:, None, :], scores,
                                      torch.full_like(scores,
                                                      float("-inf"))),
                          dim=-1)
    return duet_attention_ref(q, row_slot, row_pos, k_slab, v_slab), lse
