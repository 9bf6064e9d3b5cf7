"""Shared neural-net building blocks (plain functions on tensors).

Conventions (as the reference's ``repro.models.layers``):
  * activations are (B, S, D) unless stated otherwise
  * weights come as mappings of tensors (a ``ParamTree`` or a dict); every
    function takes its own sub-mapping
  * compute dtype follows the input; norms and RoPE compute in fp32
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Normalisation
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding (half-split / llama convention)
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh) with Dh even; positions: (B, S) int."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, x.device)               # (Dh/2,)
    angles = positions[..., None].float() * freqs                # (B,S,Dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations / MLP
# ---------------------------------------------------------------------------
def activation_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def gated_mlp(params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """SwiGLU / GeGLU when a gate matrix is present, else plain 2-matrix FFN
    (act(x W_up) W_down)."""
    u = x @ params["w_up"]
    if "w_gate" in params:
        u = activation_fn(act)(x @ params["w_gate"]) * u
    else:
        u = activation_fn(act)(u)
    return u @ params["w_down"]


# ---------------------------------------------------------------------------
# Embedding / unembedding with vocab padding
# ---------------------------------------------------------------------------
def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embedding"][tokens.long()]


def unembed(params, x: torch.Tensor, true_vocab: int) -> torch.Tensor:
    """Project to (padded) vocab logits; pad columns are masked to the
    dtype's minimum."""
    w = params["w_out"] if "w_out" in params else params["embedding"]
    logits = x @ w.T
    padded = logits.shape[-1]
    if padded > true_vocab:
        mask = torch.arange(padded, device=logits.device) < true_vocab
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    return logits
