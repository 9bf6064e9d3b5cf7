"""Mamba2 (State Space Duality) block — chunked parallel prefill + O(1)
decode, as the reference's ``repro.models.ssm``.

Prefill uses the SSD chunkwise algorithm: the sequence is split into chunks
of ``CHUNK`` steps; within a chunk the recurrence is evaluated in its
quadratic (attention-like) dual form, and a loop over chunks carries the
(heads, head_dim, state) SSM state across them (the reference's
``lax.scan``). The materialised working set stays one (B, L, L, H) block
per chunk.

Decode is the plain recurrence: h ← a·h + dt·x⊗B, y = C·h + D·x, with the
causal-conv tail carried as a (B, W-1, C) state.

State layout (MambaCache):
  conv: (B, conv_width-1, d_inner + 2*state)   model dtype
  ssm:  (B, heads, head_dim, state)            fp32
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import causal_conv1d, group_norm

CHUNK = 256


class MambaCache(NamedTuple):
    conv: torch.Tensor
    ssm: torch.Tensor


def _split_proj(params, cfg: ArchConfig, x: torch.Tensor):
    """Input projections -> (z, xBC, dt). x (B,S,D). Separate weights per
    component, as the reference."""
    z = x @ params["w_z"]
    xbc = torch.cat([x @ params["w_x"], x @ params["w_B"],
                     x @ params["w_C"]], dim=-1)
    dt = x @ params["w_dt"]
    dt = F.softplus(dt.float() + params["dt_bias"])
    return z, xbc, dt  # dt (B,S,h) f32


def _gate_out(params, cfg: ArchConfig, y: torch.Tensor, z: torch.Tensor):
    y = y * F.silu(z.float()).to(y.dtype)
    y = group_norm(y, params["norm"], num_groups=cfg.ssm_heads,
                   eps=cfg.norm_eps)
    return y @ params["w_out"]


def mamba2_prefill(params, cfg: ArchConfig, x: torch.Tensor,
                   cache: MambaCache | None = None):
    """x (B,S,D) -> (y (B,S,D), MambaCache). S is padded internally to a
    multiple of the chunk length (padded steps have dt = 0, so they leave
    the state unchanged)."""
    B, S, D = x.shape
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    z, xbc, dt = _split_proj(params, cfg, x)
    prev_conv = cache.conv if cache is not None else None
    xbc_c, conv_state = causal_conv1d(xbc, params["conv_w"],
                                      params["conv_b"], prev_conv)
    xbc_c = F.silu(xbc_c)
    xs = xbc_c[..., :cfg.d_inner].reshape(B, S, h, p)
    Bm = xbc_c[..., cfg.d_inner:cfg.d_inner + n]
    Cm = xbc_c[..., cfg.d_inner + n:]

    L = min(CHUNK, S)
    pad = (-S) % L
    if pad:
        def zeros(a):
            return F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))
        xs, Bm, Cm, dt = zeros(xs), zeros(Bm), zeros(Cm), zeros(dt)
    Sp = S + pad
    nc = Sp // L
    xs = xs.reshape(B, nc, L, h, p)
    Bm = Bm.reshape(B, nc, L, n)
    Cm = Cm.reshape(B, nc, L, n)
    dt = dt.reshape(B, nc, L, h)

    neg_A = -torch.exp(params["A_log"].float())              # (h,)
    la = dt * neg_A                                          # log a
    cum = torch.cumsum(la, dim=2)                            # inclusive

    hstate = (cache.ssm.float() if cache is not None
              else x.new_zeros((B, h, p, n), dtype=torch.float32))
    causal = torch.ones((L, L), dtype=torch.bool,
                        device=x.device).tril()[None, :, :, None]

    ys = []
    for c in range(nc):
        xc, Bc, Cc = xs[:, c].float(), Bm[:, c].float(), Cm[:, c].float()
        dtc, cumc = dt[:, c], cum[:, c]                      # (B,L,h)
        # intra-chunk quadratic dual
        cb = torch.einsum("btn,bsn->bts", Cc, Bc)            # (B,L,L)
        decay = torch.exp(cumc[:, :, None, :] - cumc[:, None, :, :])
        G = cb[..., None] * decay * dtc[:, None, :, :]       # (B,t,s,h)
        G = torch.where(causal, G, 0.0)
        y_intra = torch.einsum("btsh,bshp->bthp", G, xc)
        # inter-chunk: contribution of the carried state
        y_inter = torch.einsum("btn,bhpn->bthp", Cc, hstate) \
            * torch.exp(cumc)[:, :, :, None]
        # state update
        tail = torch.exp(cumc[:, -1:, :] - cumc)             # (B,L,h)
        dx = (dtc * tail)[..., None] * xc                    # (B,L,h,p)
        hstate = torch.exp(cumc[:, -1, :])[:, :, None, None] * hstate \
            + torch.einsum("blhp,bln->bhpn", dx, Bc)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(B, Sp, h, p)[:, :S]
    y = y + params["D"].float()[None, None, :, None] \
        * xs.reshape(B, Sp, h, p)[:, :S].float()
    y = y.reshape(B, S, cfg.d_inner).to(x.dtype)
    out = _gate_out(params, cfg, y, z)
    return out, MambaCache(conv=conv_state, ssm=hstate)


def mamba2_decode(params, cfg: ArchConfig, x: torch.Tensor,
                  cache: MambaCache):
    """x (B,1,D) -> (y (B,1,D), MambaCache)."""
    B = x.shape[0]
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    z, xbc, dt = _split_proj(params, cfg, x)         # dt (B,1,h)
    xbc_c, conv_state = causal_conv1d(xbc, params["conv_w"],
                                      params["conv_b"], cache.conv)
    xbc_c = F.silu(xbc_c)[:, 0]                      # (B, C)
    xs = xbc_c[:, :cfg.d_inner].reshape(B, h, p).float()
    Bm = xbc_c[:, cfg.d_inner:cfg.d_inner + n].float()
    Cm = xbc_c[:, cfg.d_inner + n:].float()
    dt0 = dt[:, 0]                                   # (B,h)

    neg_A = -torch.exp(params["A_log"].float())
    a = torch.exp(dt0 * neg_A)                       # (B,h)
    h_new = a[:, :, None, None] * cache.ssm.float() \
        + (dt0[:, :, None] * xs)[..., None] * Bm[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h_new, Cm) \
        + params["D"].float()[None, :, None] * xs
    y = y.reshape(B, 1, cfg.d_inner).to(x.dtype)
    out = _gate_out(params, cfg, y, z)
    return out, MambaCache(conv=conv_state, ssm=h_new)
