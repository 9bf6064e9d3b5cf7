"""Shared neural-net building blocks (plain functions on tensors).

Conventions (as the reference's ``repro.models.layers``):
  * activations are (B, S, D) unless stated otherwise
  * weights come as mappings of tensors (a ``ParamTree`` or a dict); every
    function takes its own sub-mapping
  * compute dtype follows the input; norms and RoPE compute in fp32
  * ``ctx`` (a ``DeviceContext``; None on one device) makes the embedding
    and the logits vocab-parallel and sums a sharded FFN's
    down-projection over the tensor-parallel ranks; the weights are then
    the rank's slices. A sharded region's input enters through
    ``ctx.copy_to_model``, so autograd sums its gradient over the ranks
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


def group_norm(x: torch.Tensor, scale: torch.Tensor, num_groups: int,
               eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over the last dim, in fp32 (the SSM / xLSTM cell
    outputs)."""
    dtype = x.dtype
    *lead, d = x.shape
    x32 = x.float().reshape(*lead, num_groups, d // num_groups)
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y.reshape(*lead, d) * scale.float()).to(dtype)


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


def gated_mlp(params, x: torch.Tensor, act: str = "silu",
              ctx=None) -> torch.Tensor:
    """SwiGLU / GeGLU when a gate matrix is present, else plain 2-matrix FFN
    (act(x W_up) W_down). With the ``ffn`` dim sharded each rank holds its
    columns of W_up / W_gate and rows of W_down, and the partial outputs
    are summed over the ranks."""
    sharded = ctx is not None and ctx.sharded("ffn")
    if sharded:
        x = ctx.copy_to_model(x)
    u = x @ params["w_up"]
    if "w_gate" in params:
        u = activation_fn(act)(x @ params["w_gate"]) * u
    else:
        u = activation_fn(act)(u)
    out = u @ params["w_down"]
    if sharded:
        out = ctx.reduce_from_model(out)
    return out


# ---------------------------------------------------------------------------
# Embedding / unembedding with vocab padding
# ---------------------------------------------------------------------------
def _vocab_shard(ctx, rows: int) -> int:
    """First vocab row of this rank's shard of ``rows`` rows."""
    if rows * ctx.tp != ctx.cfg.padded_vocab:
        raise ValueError(f"padded vocab {ctx.cfg.padded_vocab} does not "
                         f"divide over tp={ctx.tp}")
    return ctx.rank * rows


def _vocab_rows(table: torch.Tensor, tokens: torch.Tensor,
                ctx=None) -> torch.Tensor:
    """Rows of ``table`` (V or the rank's V/tp rows, D) at ``tokens``; with
    a sharded vocab the rows of other ranks' shards are zeros."""
    if ctx is None or not ctx.sharded("vocab"):
        return table[tokens.long()]
    Vl = table.shape[0]
    local = tokens.long() - _vocab_shard(ctx, Vl)
    hit = (local >= 0) & (local < Vl)
    rows = table[local.clamp(0, Vl - 1)]
    return torch.where(hit[..., None], rows, torch.zeros_like(rows))


def _reduce_vocab(ctx) -> bool:
    return ctx is not None and ctx.sharded("vocab")


def embed(params, tokens: torch.Tensor, ctx=None) -> torch.Tensor:
    """Embedding rows of ``tokens``. Vocab-parallel with a sharded vocab:
    each rank gathers the rows of its shard (zeros for the others) and
    the ranks' rows are summed, which is exact (a row plus zeros)."""
    rows = _vocab_rows(params["embedding"], tokens, ctx)
    return ctx.reduce_from_model(rows) if _reduce_vocab(ctx) else rows


def embed_codebooks(table: torch.Tensor, tokens: torch.Tensor,
                    ctx=None) -> torch.Tensor:
    """The audio frontend's embedding: ``tokens`` (B, K, S), the K
    codebooks' rows of ``table`` (K, V, D) summed. Vocab-parallel, each
    rank sums its K partial rows and one all-reduce sums the ranks'."""
    tokens = tokens.long()
    x = sum(_vocab_rows(table[k], tokens[:, k], ctx)
            for k in range(table.shape[0]))
    return ctx.reduce_from_model(x) if _reduce_vocab(ctx) else x


def _vocab_logits(logits: torch.Tensor, true_vocab: int,
                  ctx=None) -> torch.Tensor:
    """The full-width logits from this rank's columns (the last dim): pad
    columns masked to the dtype's minimum by their global index; with a
    sharded vocab the columns are placed in a zeroed full-width buffer
    and summed over the ranks, so every rank holds the same bits."""
    sharded = _reduce_vocab(ctx)
    Vl = logits.shape[-1]
    lo = _vocab_shard(ctx, Vl) if sharded else 0
    cols = lo + torch.arange(Vl, device=logits.device)
    if lo + Vl > true_vocab:
        logits = logits.masked_fill(cols >= true_vocab,
                                    torch.finfo(logits.dtype).min)
    if not sharded:
        return logits
    full = logits.new_zeros(logits.shape[:-1] + (Vl * ctx.tp,))
    full[..., lo:lo + Vl] = logits
    return ctx.reduce_from_model(full)


def unembed(params, x: torch.Tensor, true_vocab: int,
            ctx=None) -> torch.Tensor:
    """Project to (padded) vocab logits; pad columns are masked to the
    dtype's minimum. With a sharded vocab each rank computes its logit
    columns (tied embeddings: from its embedding rows) and one all-reduce
    gives every rank the full width (:func:`_vocab_logits`)."""
    w = params["w_out"] if "w_out" in params else params["embedding"]
    if _reduce_vocab(ctx):
        x = ctx.copy_to_model(x)
    return _vocab_logits(x @ w.T, true_vocab, ctx)


def unembed_codebooks(w_heads: torch.Tensor, x: torch.Tensor,
                      true_vocab: int, ctx=None) -> torch.Tensor:
    """The audio frontend's K heads ``w_heads`` (K, V, D): x (B, S, D) ->
    (B, S, K, V) logits, the K heads' columns filling one buffer, so a
    sharded vocab takes one all-reduce."""
    if _reduce_vocab(ctx):
        x = ctx.copy_to_model(x)
    return _vocab_logits(torch.einsum("bsd,kvd->bskv", x, w_heads),
                         true_vocab, ctx)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  true_vocab: int) -> torch.Tensor:
    """Mean token-level CE in fp32: logsumexp minus the gold logit.
    logits (..., V_pad), labels (...,) int. The pad columns hold the
    dtype's minimum (``unembed``), so they add nothing to the logsumexp;
    ``true_vocab`` is kept for the reference's signature."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()


# ---------------------------------------------------------------------------
# Causal conv1d (SSM / mLSTM front conv); channels-last (B, S, C)
# ---------------------------------------------------------------------------
def causal_conv1d(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor | None,
                  prev: torch.Tensor | None = None):
    """Depthwise causal conv. weight: (W, C). prev: (B, W-1, C) carried
    state (zeros when None).

    Returns (y, new_prev) where new_prev is the last W-1 inputs (for
    decode).
    """
    w = weight.shape[0]
    if prev is None:
        prev = x.new_zeros((x.shape[0], w - 1, x.shape[-1]))
    xp = torch.cat([prev, x], dim=1)                  # (B, S+W-1, C)
    y = sum(xp[:, i:i + x.shape[1], :] * weight[i] for i in range(w))
    if bias is not None:
        y = y + bias
    new_prev = xp[:, -(w - 1):, :] if w > 1 else prev
    return y, new_prev
