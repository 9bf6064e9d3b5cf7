"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel prefill) and
sLSTM (scalar memory, strictly sequential scan) [arXiv:2405.04517], as the
reference's ``repro.models.xlstm``.

mLSTM prefill uses the stabilised chunkwise-parallel form: within a chunk
the recurrence is evaluated as masked linear attention with log-space gate
decays; a loop over chunks carries the stabilised matrix state (C, n, m)
across them (the reference's ``lax.scan``). Decode is the O(1) recurrent
step. sLSTM has a true recurrent h -> gates dependency, so its prefill is a
loop over time (inherent to the cell, as the reference's ``lax.scan``).

Cache layouts:
  MLSTMCache: conv (B, W-1, di) model dtype, C (B, H, Dh, Dh),
              n (B, H, Dh), m (B, H) fp32
  SLSTMCache: c, n, m, h (B, D) fp32
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (causal_conv1d, gated_mlp, group_norm,
                                       rms_norm)

MLSTM_CHUNK = 256
NEG = -1e30         # the reference's "minus infinity" for log weights


class MLSTMCache(NamedTuple):
    conv: torch.Tensor
    C: torch.Tensor
    n: torch.Tensor
    m: torch.Tensor


class SLSTMCache(NamedTuple):
    c: torch.Tensor
    n: torch.Tensor
    m: torch.Tensor
    h: torch.Tensor


def _mlstm_dims(cfg: ArchConfig):
    di = int(cfg.mlstm_proj_factor * cfg.d_model)
    h = cfg.num_heads
    return di, h, di // h


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def _mlstm_qkv_gates(params, cfg: ArchConfig, x, conv_prev):
    """Common pre-cell computation. x (B,S,D)."""
    di, h, dh = _mlstm_dims(cfg)
    up = x @ params["w_up"]                      # (B,S,2di)
    x_m, z = up[..., :di], up[..., di:]
    conv_out, conv_state = causal_conv1d(x_m, params["conv_w"],
                                         params["conv_b"], conv_prev)
    conv_act = F.silu(conv_out)
    B, S = x.shape[:2]
    q = (conv_act @ params["w_q"]).reshape(B, S, h, dh)
    k = (conv_act @ params["w_k"]).reshape(B, S, h, dh)
    v = (x_m @ params["w_v"]).reshape(B, S, h, dh)
    gates = x_m @ params["w_gates"] + params["b_gates"]       # (B,S,2h)
    logi = gates[..., :h].float()
    logf = F.logsigmoid(gates[..., h:].float())
    return x_m, z, conv_act, conv_state, q, k, v, logi, logf


def _mlstm_out(params, cfg: ArchConfig, h_cell, conv_act, z):
    di, h, dh = _mlstm_dims(cfg)
    B, S = h_cell.shape[:2]
    y = group_norm(h_cell.reshape(B, S, di), params["norm"], num_groups=h,
                   eps=cfg.norm_eps)
    y = y + params["skip"] * conv_act
    y = y * F.silu(z)
    return y @ params["w_down"]


def mlstm_prefill(params, cfg: ArchConfig, x: torch.Tensor,
                  cache: MLSTMCache | None = None):
    """x (B,S,D) -> (y (B,S,D), MLSTMCache). S is padded internally to a
    multiple of the chunk length (padded steps get an input gate of
    ``NEG``, so they add nothing to the state)."""
    B, S, D = x.shape
    di, h, dh = _mlstm_dims(cfg)
    conv_prev = cache.conv if cache is not None else None
    x_m, z, conv_act, conv_state, q, k, v, logi, logf = _mlstm_qkv_gates(
        params, cfg, x, conv_prev)

    L = min(MLSTM_CHUNK, S)
    pad = (-S) % L
    if pad:
        def pad2(a, value=0.0):
            return F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad), value=value)
        q, k, v = pad2(q), pad2(k), pad2(v)
        logi = pad2(logi, NEG)                   # padded steps contribute 0
        logf = pad2(logf)
    Sp = S + pad
    nc = Sp // L
    qc, kc, vc = (a.reshape(B, nc, L, h, dh) for a in (q, k, v))
    lic, lfc = (a.reshape(B, nc, L, h) for a in (logi, logf))

    if cache is not None:
        C, n, m = cache.C.float(), cache.n.float(), cache.m.float()
    else:
        C = x.new_zeros((B, h, dh, dh), dtype=torch.float32)
        n = x.new_zeros((B, h, dh), dtype=torch.float32)
        m = x.new_full((B, h), NEG, dtype=torch.float32)

    causal = torch.ones((L, L), dtype=torch.bool,
                        device=x.device).tril()[None, :, :, None]
    scale = 1.0 / math.sqrt(dh)

    hs = []
    for c in range(nc):
        li, lf = lic[:, c], lfc[:, c]            # (B,L,h)
        Fc = torch.cumsum(lf, dim=1)             # inclusive (B,L,h)
        # log weight of source s for query t: F_t - F_s + li_s   (s <= t)
        Dlog = Fc[:, :, None, :] - Fc[:, None, :, :] + li[:, None, :, :]
        Dlog = torch.where(causal, Dlog, NEG)
        b = Fc + m[:, None, :]                   # carry branch (B,L,h)
        m_t = torch.maximum(Dlog.amax(dim=2), b)             # (B,L,h)
        W = torch.exp(Dlog - m_t[:, :, None, :])             # (B,t,s,h)
        carry_w = torch.exp(b - m_t)                         # (B,L,h)

        qf = qc[:, c].float() * scale
        kf = kc[:, c].float()
        vf = vc[:, c].float()
        scores = torch.einsum("bthd,bshd->btsh", qf, kf) * W
        num = torch.einsum("btsh,bshd->bthd", scores, vf) \
            + carry_w[..., None] * torch.einsum("bthd,bhde->bthe", qf, C)
        nvec = torch.einsum("btsh,bshd->bthd", W, kf) \
            + carry_w[..., None] * n[:, None, :, :]
        den = torch.maximum(
            torch.einsum("bthd,bthd->bth", qf, nvec).abs(), torch.exp(-m_t))
        hs.append(num / den[..., None])

        # chunk-end state update
        g = Fc[:, -1, :]                                     # (B,h)
        src = g[:, None, :] - Fc + li                        # (B,L,h)
        m_next = torch.maximum(g + m, src.amax(dim=1))
        w_src = torch.exp(src - m_next[:, None, :])
        decay = torch.exp(g + m - m_next)
        C = decay[:, :, None, None] * C \
            + torch.einsum("blh,blhd,blhe->bhde", w_src, kf, vf)
        n = decay[:, :, None] * n + torch.einsum("blh,blhd->bhd", w_src, kf)
        m = m_next
    h_cell = torch.stack(hs, dim=1).reshape(B, Sp, h, dh)[:, :S]
    out = _mlstm_out(params, cfg, h_cell.to(x.dtype), conv_act, z)
    return out, MLSTMCache(conv=conv_state, C=C, n=n, m=m)


def mlstm_decode(params, cfg: ArchConfig, x: torch.Tensor,
                 cache: MLSTMCache):
    """x (B,1,D) -> (y (B,1,D), MLSTMCache)."""
    B = x.shape[0]
    di, h, dh = _mlstm_dims(cfg)
    x_m, z, conv_act, conv_state, q, k, v, logi, logf = _mlstm_qkv_gates(
        params, cfg, x, cache.conv)
    qf = q[:, 0].float() / math.sqrt(dh)              # (B,h,dh)
    kf = k[:, 0].float()
    vf = v[:, 0].float()
    li, lf = logi[:, 0], logf[:, 0]                   # (B,h)

    m_old = cache.m.float()
    m_new = torch.maximum(lf + m_old, li)
    fw = torch.exp(lf + m_old - m_new)
    iw = torch.exp(li - m_new)
    C_new = fw[:, :, None, None] * cache.C.float() \
        + iw[:, :, None, None] * kf[:, :, :, None] * vf[:, :, None, :]
    n_new = fw[:, :, None] * cache.n.float() + iw[:, :, None] * kf
    num = torch.einsum("bhd,bhde->bhe", qf, C_new)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", qf, n_new).abs(),
                        torch.exp(-m_new))
    h_cell = (num / den[..., None]).reshape(B, 1, di).to(x.dtype)
    out = _mlstm_out(params, cfg, h_cell, conv_act, z)
    return out, MLSTMCache(conv=conv_state, C=C_new, n=n_new, m=m_new)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def _slstm_step(params, cfg: ArchConfig, carry, x_t):
    """One recurrent step. x_t (B, 4*D) pre-computed input projection;
    carry (c, n, m, h) fp32."""
    c, n, m, h_prev = carry
    di = cfg.d_model
    heads, dh = cfg.num_heads, cfg.d_model // cfg.num_heads
    # recurrent contribution: block-diagonal per head, for all 4 gates
    hr = h_prev.reshape(-1, heads, dh)
    rec = torch.einsum("bhd,ghde->bghe", hr,
                       params["R"].float()).reshape(-1, 4 * di)
    raw = (x_t + rec).float()
    zi, ii, fi, oi = raw.chunk(4, dim=-1)
    zt = torch.tanh(zi)
    logf = F.logsigmoid(fi)
    m_new = torch.maximum(logf + m, ii)
    i_w = torch.exp(ii - m_new)
    f_w = torch.exp(logf + m - m_new)
    c_new = f_w * c + i_w * zt
    n_new = f_w * n + i_w
    h_new = torch.sigmoid(oi) * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, m_new, h_new), h_new


def slstm_forward(params, cfg: ArchConfig, x: torch.Tensor,
                  cache: SLSTMCache | None = None):
    """x (B,S,D) -> (y, SLSTMCache). Sequential over S (inherent)."""
    B, S, D = x.shape
    if cache is None:
        zero = x.new_zeros((B, D), dtype=torch.float32)
        cache = SLSTMCache(c=zero, n=zero,
                           m=x.new_full((B, D), NEG, dtype=torch.float32),
                           h=zero)
    xw = x @ params["w_in"] + params["b_in"]          # (B,S,4D)
    carry = tuple(t.float() for t in cache)
    hs = []
    for t in range(S):
        carry, h_t = _slstm_step(params, cfg, carry, xw[:, t])
        hs.append(h_t)
    y = torch.stack(hs, dim=1).to(x.dtype)            # (B,S,D)
    y = group_norm(y, params["norm"], num_groups=cfg.num_heads,
                   eps=cfg.norm_eps)
    y = y + gated_mlp(params["ffn"], rms_norm(y, params["ffn_norm"],
                                              cfg.norm_eps), "gelu")
    c, n, m, hl = carry
    return y, SLSTMCache(c=c, n=n, m=m, h=hl)
