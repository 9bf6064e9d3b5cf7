"""Parameter layout, initialisation and the weight bridge from the JAX
reference — attention blocks (GQA and MLA) with a dense or MoE FFN, the
recurrent blocks (Mamba2, mLSTM, sLSTM) with Zamba2's one shared
attention block at the top-level ``shared_attn`` slot, and the audio
frontend's codebook tables and heads.

``layout(cfg)`` builds a tree of :class:`ParamDef` leaves (shape + init
kind) with the reference's layouts, e.g. GQA's ``w_q (D,H,Dh)`` and
``w_o (H,Dh,D)``, MLA's flat ``w_o (H*vd, D)`` and the experts'
``w_gate (E,D,F)``, so both packages compute the same einsums term for
term.
``init_params`` materialises it from a ``torch.Generator``, and
``abstract_params`` gives it as ``meta`` tensors (shapes only, for the
dry run);
``params_from_jax`` turns the reference's parameter tree (nested dict of
numpy arrays, as ``jax.tree.map(np.asarray, params)`` gives it) into the
port's tensors. The ``uniform_log`` leaves (Mamba2's ``dt_bias`` and
``A_log``) stay fp32 in a bf16 model, as the reference keeps them.
``trainable`` makes a tree's leaves require grad, for training.

Tensor parallelism: :func:`axis_rules` maps each logical axis name of the
layout onto the ``model`` axis (the reference's per-arch divisibility
rules), :func:`param_specs` gives each leaf's spec as a tuple of
``"model"`` / None, and :func:`shard_params` cuts one rank's slice of a
full tree along those axes (``init_params`` draws the full leaf and keeps
the slice, leaf by leaf). :func:`unshard_params` is its inverse over the
ranks' trees, and :func:`gather_params` its inverse on the ranks
themselves (a collective over the model group); :func:`cut_dims` names the
one dim each leaf is cut on.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str                    # normal | zeros | ones | uniform_log
    # logical axis names, one a dim, mapped onto the ``model`` axis by
    # :func:`axis_rules` (the reference's names)
    axes: Tuple[Optional[str], ...] = ()
    fan_in: Optional[int] = None

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _slstm_ffn_dim(d_model: int) -> int:
    return int(round(d_model * 4 / 3 / 64)) * 64


def _mlstm_inner(cfg: ArchConfig) -> int:
    return int(cfg.mlstm_proj_factor * cfg.d_model)


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------
def _attn_layout(cfg: ArchConfig) -> dict:
    D, H, G, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "w_q": ParamDef((D, H, dh), "normal",
                        ("embed", "heads", "head_dim"), D),
        "w_k": ParamDef((D, G, dh), "normal",
                        ("embed", "kv_heads", "head_dim"), D),
        "w_v": ParamDef((D, G, dh), "normal",
                        ("embed", "kv_heads", "head_dim"), D),
        "w_o": ParamDef((H, dh, D), "normal",
                        ("heads", "head_dim", "embed"), H * dh),
    }
    if cfg.qk_norm:
        p["q_norm"] = ParamDef((dh,), "ones", (None,))
        p["k_norm"] = ParamDef((dh,), "ones", (None,))
    return p


def _mla_layout(cfg: ArchConfig) -> dict:
    D, H = cfg.d_model, cfg.num_heads
    r, nope, rope, vd = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                         cfg.v_head_dim)
    return {
        "w_q": ParamDef((D, H, nope + rope), "normal",
                        ("embed", "heads", "head_dim"), D),
        "w_dkv": ParamDef((D, r), "normal", ("embed", "kv_lora"), D),
        "kv_norm": ParamDef((r,), "ones", (None,)),
        "w_krope": ParamDef((D, rope), "normal", ("embed", None), D),
        "w_uk": ParamDef((r, H, nope), "normal",
                         ("kv_lora", "heads", "head_dim"), r),
        "w_uv": ParamDef((r, H, vd), "normal",
                         ("kv_lora", "heads", "head_dim"), r),
        "w_o": ParamDef((H * vd, D), "normal", ("heads_flat", "embed"),
                        H * vd),
    }


def _mlp_layout(cfg: ArchConfig, d_ff: int) -> dict:
    D = cfg.d_model
    p = {
        "w_up": ParamDef((D, d_ff), "normal", ("embed", "ffn"), D),
        "w_down": ParamDef((d_ff, D), "normal", ("ffn", "embed"), d_ff),
    }
    if cfg.mlp_gated:
        p["w_gate"] = ParamDef((D, d_ff), "normal", ("embed", "ffn"), D)
    return p


def _moe_layout(cfg: ArchConfig) -> dict:
    D, E, F = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {
        "router": ParamDef((D, E), "normal", ("embed", None), D),
        "w_gate": ParamDef((E, D, F), "normal",
                           ("experts", "embed", "moe_ffn"), D),
        "w_up": ParamDef((E, D, F), "normal",
                         ("experts", "embed", "moe_ffn"), D),
        "w_down": ParamDef((E, F, D), "normal",
                           ("experts", "moe_ffn", "embed"), F),
    }
    if cfg.num_shared_experts:
        p["shared"] = _mlp_layout(cfg, cfg.num_shared_experts * cfg.moe_d_ff)
    return p


def _mamba_layout(cfg: ArchConfig) -> dict:
    D, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    W = cfg.ssm_conv
    conv_ch = di + 2 * n
    return {
        "w_z": ParamDef((D, di), "normal", ("embed", "ssm_inner"), D),
        "w_x": ParamDef((D, di), "normal", ("embed", "ssm_inner"), D),
        "w_B": ParamDef((D, n), "normal", ("embed", None), D),
        "w_C": ParamDef((D, n), "normal", ("embed", None), D),
        "w_dt": ParamDef((D, h), "normal", ("embed", "ssm_heads"), D),
        "conv_w": ParamDef((W, conv_ch), "normal", (None, None), W),
        "conv_b": ParamDef((conv_ch,), "zeros", (None,)),
        "dt_bias": ParamDef((h,), "uniform_log", ("ssm_heads",)),
        "A_log": ParamDef((h,), "uniform_log", ("ssm_heads",)),
        "D": ParamDef((h,), "ones", ("ssm_heads",)),
        "norm": ParamDef((di,), "ones", ("ssm_inner",)),
        "w_out": ParamDef((di, D), "normal", ("ssm_inner", "embed"), di),
    }


def _mlstm_layout(cfg: ArchConfig) -> dict:
    D = cfg.d_model
    di = _mlstm_inner(cfg)
    h = cfg.num_heads
    W = cfg.ssm_conv
    return {
        "w_up": ParamDef((D, 2 * di), "normal", ("embed", "mlstm_inner"),
                         D),
        "conv_w": ParamDef((W, di), "normal", (None, None), W),
        "conv_b": ParamDef((di,), "zeros", ("mlstm_inner",)),
        "w_q": ParamDef((di, di), "normal", ("mlstm_inner", "mlstm_inner"),
                        di),
        "w_k": ParamDef((di, di), "normal", ("mlstm_inner", "mlstm_inner"),
                        di),
        "w_v": ParamDef((di, di), "normal", ("mlstm_inner", "mlstm_inner"),
                        di),
        "w_gates": ParamDef((di, 2 * h), "normal", ("mlstm_inner", None),
                            di),
        "b_gates": ParamDef((2 * h,), "zeros", (None,)),
        "norm": ParamDef((di,), "ones", ("mlstm_inner",)),
        "skip": ParamDef((di,), "zeros", ("mlstm_inner",)),
        "w_down": ParamDef((di, D), "normal", ("mlstm_inner", "embed"), di),
    }


def _slstm_layout(cfg: ArchConfig) -> dict:
    D = cfg.d_model
    h, dh = cfg.num_heads, cfg.d_model // cfg.num_heads
    f = _slstm_ffn_dim(D)
    return {
        "w_in": ParamDef((D, 4 * D), "normal", ("embed", None), D),
        "b_in": ParamDef((4 * D,), "zeros", (None,)),
        "R": ParamDef((4, h, dh, dh), "normal", (None,) * 4, dh),
        "norm": ParamDef((D,), "ones", (None,)),
        "ffn_norm": ParamDef((D,), "ones", (None,)),
        "ffn": {
            "w_gate": ParamDef((D, f), "normal", ("embed", "ffn"), D),
            "w_up": ParamDef((D, f), "normal", ("embed", "ffn"), D),
            "w_down": ParamDef((f, D), "normal", ("ffn", "embed"), f),
        },
    }


_RECURRENT_LAYOUTS = {"mamba2": ("mamba", _mamba_layout),
                      "mlstm": ("mlstm", _mlstm_layout),
                      "slstm": ("slstm", _slstm_layout)}


def _block_layout(cfg: ArchConfig, kind: str) -> dict:
    D = cfg.d_model
    if kind == "shared_attn":
        return {}  # weights live at the top-level "shared_attn" slot
    if kind in _RECURRENT_LAYOUTS:
        key, make = _RECURRENT_LAYOUTS[kind]
        return {"norm": ParamDef((D,), "ones", (None,)), key: make(cfg)}
    attn = {"attn": _attn_layout, "attn_moe": _attn_layout,
            "mla": _mla_layout, "mla_moe": _mla_layout}.get(kind)
    if attn is None:
        raise ValueError(f"unknown block kind {kind!r}")
    ffn = ({"moe": _moe_layout(cfg)} if kind.endswith("_moe")
           else {"mlp": _mlp_layout(cfg, cfg.d_ff)})
    return {"attn_norm": ParamDef((D,), "ones", (None,)), "attn": attn(cfg),
            "mlp_norm": ParamDef((D,), "ones", (None,)), **ffn}


def layout(cfg: ArchConfig) -> dict:
    """The parameter tree of ``cfg``. The audio frontend replaces the
    embedding with one table a codebook, ``codebook_embeddings (K, Vp, D)``,
    and the output projection with one head a codebook, ``w_heads (K, Vp,
    D)``; the vision frontend's patch embeddings come precomputed, so it
    adds no weight."""
    Vp, D = cfg.padded_vocab, cfg.d_model
    tree: dict = {
        "embedding": ParamDef((Vp, D), "normal", ("vocab", "embed"), D),
        "final_norm": ParamDef((D,), "ones", (None,)),
        "layers": [_block_layout(cfg, kind) for kind in cfg.block_pattern],
    }
    if cfg.frontend == "audio":
        K = cfg.num_codebooks
        tree["codebook_embeddings"] = ParamDef((K, Vp, D), "normal",
                                               (None, "vocab", "embed"), D)
        tree["w_heads"] = ParamDef((K, Vp, D), "normal",
                                   (None, "vocab", "embed"), D)
        del tree["embedding"]
    elif not cfg.tie_embeddings:
        tree["w_out"] = ParamDef((Vp, D), "normal", ("vocab", "embed"), D)
    if "shared_attn" in cfg.block_pattern:
        tree["shared_attn"] = _block_layout(cfg, "attn")
    return tree


def _leaves(tree, prefix=()):
    """(path, leaf) pairs in a fixed order: dict keys sorted, lists by
    index (the order ``jax.tree`` flattens the reference's tree in)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _map(fn, tree, prefix=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, prefix + (i,)) for i, v in enumerate(tree)]
    return fn(prefix, tree)


# ---------------------------------------------------------------------------
# sharding (host copies of the reference's rules)
# ---------------------------------------------------------------------------
def tp_adjusted_config(cfg: ArchConfig, tp: int,
                       pad_experts: bool = False) -> ArchConfig:
    """Expand KV heads by repetition when smaller than the TP degree (only
    when q heads shard) — numerically identical attention. With
    ``pad_experts`` an MoE whose expert count does not divide the axis gets
    zero-weight padding experts (masked in the router through
    ``num_experts_routed``) so the expert dim shards."""
    if tp <= 1:
        return cfg
    if pad_experts and cfg.is_moe and cfg.num_experts % tp != 0:
        padded = -(-cfg.num_experts // tp) * tp
        cfg = dataclasses.replace(cfg, num_experts=padded,
                                  num_experts_routed=cfg.num_experts)
    if cfg.num_heads % tp != 0 or cfg.kv_lora_rank > 0:
        return cfg
    if cfg.num_kv_heads % tp != 0 and tp % cfg.num_kv_heads == 0:
        return dataclasses.replace(cfg, num_kv_heads=tp)
    return cfg


def axis_rules(cfg: ArchConfig, model_axis_size: int) -> dict:
    """Logical axis name -> ``"model"`` (sharded over the TP ranks) or None
    (whole on every rank), per the divisibility of this config's dims."""
    m = model_axis_size
    heads_ok = (cfg.num_heads % m == 0
                and (cfg.kv_lora_rank > 0 or cfg.num_kv_heads % m == 0))
    experts_ok = cfg.num_experts % m == 0 if cfg.is_moe else False
    return {
        "vocab": "model",
        "embed": None,
        "head_dim": None,
        "heads": "model" if heads_ok else None,
        "kv_heads": "model" if heads_ok else None,
        "heads_flat": "model" if heads_ok else None,
        "ffn": "model" if (cfg.d_ff and cfg.d_ff % m == 0) else None,
        "kv_lora": None,
        "experts": "model" if experts_ok else None,
        "moe_ffn": ("model" if (not experts_ok and cfg.is_moe
                                and cfg.moe_d_ff % m == 0) else None),
        "ssm_inner": ("model" if (cfg.ssm_state and cfg.d_inner % m == 0)
                      else None),
        "ssm_heads": ("model" if (cfg.ssm_state and cfg.ssm_heads % m == 0)
                      else None),
        "mlstm_inner": None,   # xlstm-350m: 4 heads, replicated
        None: None,
    }


def param_specs(cfg: ArchConfig, tp: int) -> dict:
    """Each leaf's spec at TP degree ``tp``: a tuple with ``"model"`` on
    the dims that shard and None on the rest (the reference's
    ``PartitionSpec`` entries)."""
    rules = axis_rules(cfg, tp)
    return _map(lambda _, d: tuple(rules.get(a) for a in d.axes),
                layout(cfg))


def _shard_leaf(t: torch.Tensor, spec: tuple, tp: int,
                rank: int) -> torch.Tensor:
    """Rank ``rank``'s slice of one full leaf: each dim marked ``"model"``
    cut into ``tp`` equal parts; a dim that does not divide stays whole,
    as the reference leaves it replicated."""
    for dim, axis in enumerate(spec):
        if axis == "model" and tp > 1 and t.shape[dim] % tp == 0:
            n = t.shape[dim] // tp
            t = t.narrow(dim, rank * n, n)
    return t


def cut_dims(cfg: ArchConfig, tp: int) -> dict:
    """path -> the dim of the full leaf that :func:`shard_params` cuts at
    TP degree ``tp``, or None for a leaf every rank holds whole (its spec
    names no ``"model"`` dim, or that dim does not divide)."""
    specs = dict(_leaves(param_specs(cfg, tp)))
    out = {}
    for path, d in _leaves(layout(cfg)):
        dims = [i for i, a in enumerate(specs[path])
                if a == "model" and tp > 1 and d.shape[i] % tp == 0]
        if len(dims) > 1:
            raise ValueError(f"{path}: cut on {len(dims)} dims")
        out[path] = dims[0] if dims else None
    return out


def unshard_params(trees, cfg: ArchConfig, tp: int) -> dict:
    """The full tree from the ``tp`` ranks' trees (rank order), each leaf
    its ranks' slices concatenated along its cut dim (padded experts and
    vocab rows included), rank 0's where it is whole: the inverse of
    :func:`shard_params`."""
    if tp <= 1:
        return trees[0]
    if len(trees) != tp:
        raise ValueError(f"unshard_params: {len(trees)} trees for tp={tp}")
    dims = cut_dims(cfg, tp)
    flat = [dict(_leaves(t)) for t in trees]
    return _map(lambda path, _: flat[0][path] if dims[path] is None
                else torch.cat([f[path] for f in flat], dim=dims[path]),
                layout(cfg))


@torch.no_grad()
def gather_params(tree: dict, ctx) -> dict:
    """The full tree on every rank of ``ctx``'s model group, from each
    rank's slices (``tree``: weights, gradients or moments, in the
    layout): a collective every rank must make. Each cut leaf is placed in
    a zeroed full-size buffer at the rank's offset and summed over the
    ranks (exact: a value plus zeros), whole leaves are detached as they
    are. The identity at tp 1."""
    if ctx.tp <= 1:
        return tree
    dims = cut_dims(ctx.cfg, ctx.tp)

    def gather(path, t):
        t = t.detach()
        dim = dims[path]
        if dim is None:
            return t
        n = t.shape[dim]
        shape = list(t.shape)
        shape[dim] = n * ctx.tp
        full = t.new_zeros(shape)
        full.narrow(dim, ctx.rank * n, n).copy_(t)
        torch.distributed.all_reduce(full, group=ctx.group)
        return full
    return _map(gather, tree)


def shard_params(tree: dict, cfg: ArchConfig, tp: int, rank: int) -> dict:
    """Rank ``rank``'s slices of a full parameter tree at TP degree ``tp``
    (copies, so the full leaves can be freed); the identity at tp 1."""
    if tp <= 1:
        return tree
    specs = dict(_leaves(param_specs(cfg, tp)))
    got = dict(_leaves(tree))
    return _map(lambda path, _: _shard_leaf(got[path], specs[path], tp,
                                            rank).clone(), layout(cfg))


# ---------------------------------------------------------------------------
# init / counting / bridge
# ---------------------------------------------------------------------------
def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.float32, device="cpu", *, tp: int = 1,
                rank: int = 0) -> dict:
    """Random weights drawn from ``generator`` (which must live on
    ``device``): normal(0, 1/sqrt(fan_in)) matrices, zeros for biases,
    ones for norms, and log(uniform(1e-3, 0.1)) for the ``uniform_log``
    gate leaves, kept fp32 whatever ``dtype`` is, as the reference.
    Leaves are drawn in :func:`_leaves` order, so a seed fixes the model.
    At ``tp`` > 1 every leaf is drawn whole (the same draws at any TP
    degree) and only rank ``rank``'s slice of it is kept
    (:func:`shard_params`) before the next is drawn."""
    defs = layout(cfg)
    specs = dict(_leaves(param_specs(cfg, tp)))
    made = {}
    for path, d in _leaves(defs):
        if d.init == "normal":
            w = torch.randn(d.shape, generator=generator, device=device,
                            dtype=torch.float32)
            leaf = (w * (1.0 / math.sqrt(d.fan_in))).to(dtype)
        elif d.init == "zeros":
            leaf = torch.zeros(d.shape, dtype=dtype, device=device)
        elif d.init == "ones":
            leaf = torch.ones(d.shape, dtype=dtype, device=device)
        elif d.init == "uniform_log":
            u = torch.rand(d.shape, generator=generator, device=device,
                           dtype=torch.float32)
            leaf = torch.log(1e-3 + u * (0.1 - 1e-3))
        else:
            raise ValueError(d.init)
        if tp > 1:
            leaf = _shard_leaf(leaf, specs[path], tp, rank).clone()
        made[path] = leaf
    return _map(lambda path, _: made[path], defs)


def abstract_params(cfg: ArchConfig, dtype=torch.bfloat16, *,
                    tp: int = 1) -> dict:
    """The layout's tree as ``meta`` tensors (shapes and dtypes, no
    storage), the ``uniform_log`` leaves fp32 as :func:`init_params` keeps
    them; at ``tp`` > 1 each leaf is a rank's slice (:func:`shard_params`'
    cut; every rank's has the same shape)."""
    specs = dict(_leaves(param_specs(cfg, tp)))

    def make(path, d: ParamDef):
        dt = torch.float32 if d.init == "uniform_log" else dtype
        return _shard_leaf(torch.empty(d.shape, dtype=dt, device="meta"),
                           specs[path], tp, 0)
    return _map(make, layout(cfg))


def count_params_analytical(cfg: ArchConfig,
                            active_only: bool = False) -> int:
    """Parameter count from the layout; ``active_only`` counts a routed
    expert tensor at top_k / num_experts of its size, as the reference."""
    total = 0
    for _, d in _leaves(layout(cfg)):
        n = math.prod(d.shape)
        if active_only and d.axes[0] == "experts":
            n = n * (cfg.moe_top_k / cfg.num_experts)
        total += int(n)
    return total


def trainable(tree: dict) -> dict:
    """``tree`` with every leaf a new autograd leaf that requires grad (the
    same storage, detached from any graph): the weights of a training run,
    which ``Model`` holds as they are, so a loss's gradients land on them."""
    return _map(lambda _, t: t.detach().requires_grad_(True), tree)


def params_from_jax(cfg: ArchConfig, tree: dict, *, dtype=torch.float32,
                    device="cpu") -> dict:
    """The reference's parameter tree (nested dict/list of numpy arrays)
    as the port's tensors, checked leaf by leaf against :func:`layout`."""
    defs = layout(cfg)
    want = dict(_leaves(defs))
    got = dict(_leaves(tree))
    if set(want) != set(got):
        raise ValueError(
            f"params_from_jax: tree mismatch; missing "
            f"{sorted(map(str, set(want) - set(got)))}, extra "
            f"{sorted(map(str, set(got) - set(want)))}")

    def convert(path, d):
        arr = np.asarray(got[path], dtype=np.float32)
        if arr.shape != d.shape:
            raise ValueError(f"params_from_jax: {path} has shape "
                             f"{arr.shape}, layout says {d.shape}")
        # the uniform_log gate leaves stay fp32, as the reference's
        leaf = torch.float32 if d.init == "uniform_log" else dtype
        return torch.from_numpy(arr.copy()).to(device=device, dtype=leaf)

    return _map(convert, defs)
