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

Tensor parallelism: a rank holds its heads' share of ``w_z``, ``w_x``,
``w_dt``, ``dt_bias``, ``A_log``, ``D``, ``norm`` and ``w_out``, and the
whole ``w_B`` / ``w_C``; d_inner and the heads above are then the rank's
(read from the weights' shapes), and so is its state. The causal conv
runs over the rank's x channels and the whole B/C channels, ``conv``
(:func:`rank_conv`, cut once by the model); the gate norm's groups are
the heads, so it stays rank-local, and the out-projection's partial sums
are added over the ranks (``ctx``) in the block's one all-reduce.
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


def rank_conv(params, d_inner: int, rank: int):
    """(conv_w, conv_b) over rank ``rank``'s channels of the whole conv
    weights, whose channels are ``[x | B | C]``: its ``d_inner`` x
    channels, then every B and C channel."""
    w, b = params["conv_w"], params["conv_b"]
    full = w.shape[1] - 2 * params["w_B"].shape[1]
    idx = torch.cat([torch.arange(rank * d_inner, (rank + 1) * d_inner),
                     torch.arange(full, w.shape[1])]).to(w.device)
    return w[:, idx].contiguous(), b[idx].contiguous()


def _dims(params):
    """(d_inner, heads) this rank runs, from its weights."""
    return params["w_x"].shape[1], params["A_log"].shape[0]


def _split_proj(params, cfg: ArchConfig, x: torch.Tensor):
    """Input projections -> (z, xBC, dt). x (B,S,D). Separate weights per
    component, as the reference."""
    z = x @ params["w_z"]
    xbc = torch.cat([x @ params["w_x"], x @ params["w_B"],
                     x @ params["w_C"]], dim=-1)
    dt = x @ params["w_dt"]
    dt = F.softplus(dt.float() + params["dt_bias"])
    return z, xbc, dt  # dt (B,S,h) f32


def _gate_out(params, cfg: ArchConfig, y: torch.Tensor, z: torch.Tensor,
              ctx):
    y = y * F.silu(z.float()).to(y.dtype)
    y = group_norm(y, params["norm"], num_groups=params["A_log"].shape[0],
                   eps=cfg.norm_eps)
    out = y @ params["w_out"]
    if params["w_out"].shape[0] < cfg.d_inner:   # the rank's partial sum
        out = ctx.all_reduce(out)
    return out


def mamba2_prefill(params, cfg: ArchConfig, x: torch.Tensor,
                   cache: MambaCache | None = None, *, conv=None,
                   ctx=None):
    """x (B,S,D) -> (y (B,S,D), MambaCache). S is padded internally to a
    multiple of the chunk length (padded steps have dt = 0, so they leave
    the state unchanged). ``conv``: the rank's (conv_w, conv_b) under TP
    (:func:`rank_conv`), else the whole ones."""
    B, S, D = x.shape
    di, h = _dims(params)
    p, n = cfg.ssm_head_dim, cfg.ssm_state
    z, xbc, dt = _split_proj(params, cfg, x)
    prev_conv = cache.conv if cache is not None else None
    conv_w, conv_b = conv or (params["conv_w"], params["conv_b"])
    xbc_c, conv_state = causal_conv1d(xbc, conv_w, conv_b, prev_conv)
    xbc_c = F.silu(xbc_c)
    xs = xbc_c[..., :di].reshape(B, S, h, p)
    Bm = xbc_c[..., di:di + n]
    Cm = xbc_c[..., di + n:]

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
    y = y.reshape(B, S, di).to(x.dtype)
    out = _gate_out(params, cfg, y, z, ctx)
    return out, MambaCache(conv=conv_state, ssm=hstate)


def mamba2_decode(params, cfg: ArchConfig, x: torch.Tensor,
                  cache: MambaCache, *, conv=None, ctx=None):
    """x (B,1,D) -> (y (B,1,D), MambaCache)."""
    B = x.shape[0]
    di, h = _dims(params)
    p, n = cfg.ssm_head_dim, cfg.ssm_state
    z, xbc, dt = _split_proj(params, cfg, x)         # dt (B,1,h)
    conv_w, conv_b = conv or (params["conv_w"], params["conv_b"])
    xbc_c, conv_state = causal_conv1d(xbc, conv_w, conv_b, cache.conv)
    xbc_c = F.silu(xbc_c)[:, 0]                      # (B, C)
    xs = xbc_c[:, :di].reshape(B, h, p).float()
    Bm = xbc_c[:, di:di + n].float()
    Cm = xbc_c[:, di + n:].float()
    dt0 = dt[:, 0]                                   # (B,h)

    neg_A = -torch.exp(params["A_log"].float())
    a = torch.exp(dt0 * neg_A)                       # (B,h)
    h_new = a[:, :, None, None] * cache.ssm.float() \
        + (dt0[:, :, None] * xs)[..., None] * Bm[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h_new, Cm) \
        + params["D"].float()[None, :, None] * xs
    y = y.reshape(B, 1, di).to(x.dtype)
    out = _gate_out(params, cfg, y, z, ctx)
    return out, MambaCache(conv=conv_state, ssm=h_new)
