"""Parameter layout, initialisation and the weight bridge from the JAX
reference — attention blocks (GQA and MLA) with a dense or MoE FFN, and
the recurrent blocks (Mamba2, mLSTM, sLSTM) with Zamba2's one shared
attention block at the top-level ``shared_attn`` slot.

``layout(cfg)`` builds a tree of :class:`ParamDef` leaves (shape + init
kind) with the reference's layouts, e.g. GQA's ``w_q (D,H,Dh)`` and
``w_o (H,Dh,D)``, MLA's flat ``w_o (H*vd, D)`` and the experts'
``w_gate (E,D,F)``, so both packages compute the same einsums term for
term.
``init_params`` materialises it from a ``torch.Generator``;
``params_from_jax`` turns the reference's parameter tree (nested dict of
numpy arrays, as ``jax.tree.map(np.asarray, params)`` gives it) into the
port's tensors. The ``uniform_log`` leaves (Mamba2's ``dt_bias`` and
``A_log``) stay fp32 in a bf16 model, as the reference keeps them.
Sharding rules are not yet ported (single device).
"""
from __future__ import annotations

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
    fan_in: Optional[int] = None
    expert: bool = False         # leading axis is the routed-expert axis


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
        "w_q": ParamDef((D, H, dh), "normal", D),
        "w_k": ParamDef((D, G, dh), "normal", D),
        "w_v": ParamDef((D, G, dh), "normal", D),
        "w_o": ParamDef((H, dh, D), "normal", H * dh),
    }
    if cfg.qk_norm:
        p["q_norm"] = ParamDef((dh,), "ones")
        p["k_norm"] = ParamDef((dh,), "ones")
    return p


def _mla_layout(cfg: ArchConfig) -> dict:
    D, H = cfg.d_model, cfg.num_heads
    r, nope, rope, vd = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                         cfg.v_head_dim)
    return {
        "w_q": ParamDef((D, H, nope + rope), "normal", D),
        "w_dkv": ParamDef((D, r), "normal", D),
        "kv_norm": ParamDef((r,), "ones"),
        "w_krope": ParamDef((D, rope), "normal", D),
        "w_uk": ParamDef((r, H, nope), "normal", r),
        "w_uv": ParamDef((r, H, vd), "normal", r),
        "w_o": ParamDef((H * vd, D), "normal", H * vd),
    }


def _mlp_layout(cfg: ArchConfig, d_ff: int) -> dict:
    D = cfg.d_model
    p = {
        "w_up": ParamDef((D, d_ff), "normal", D),
        "w_down": ParamDef((d_ff, D), "normal", d_ff),
    }
    if cfg.mlp_gated:
        p["w_gate"] = ParamDef((D, d_ff), "normal", D)
    return p


def _moe_layout(cfg: ArchConfig) -> dict:
    D, E, F = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {
        "router": ParamDef((D, E), "normal", D),
        "w_gate": ParamDef((E, D, F), "normal", D, expert=True),
        "w_up": ParamDef((E, D, F), "normal", D, expert=True),
        "w_down": ParamDef((E, F, D), "normal", F, expert=True),
    }
    if cfg.num_shared_experts:
        p["shared"] = _mlp_layout(cfg, cfg.num_shared_experts * cfg.moe_d_ff)
    return p


def _mamba_layout(cfg: ArchConfig) -> dict:
    D, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    W = cfg.ssm_conv
    conv_ch = di + 2 * n
    return {
        "w_z": ParamDef((D, di), "normal", D),
        "w_x": ParamDef((D, di), "normal", D),
        "w_B": ParamDef((D, n), "normal", D),
        "w_C": ParamDef((D, n), "normal", D),
        "w_dt": ParamDef((D, h), "normal", D),
        "conv_w": ParamDef((W, conv_ch), "normal", W),
        "conv_b": ParamDef((conv_ch,), "zeros"),
        "dt_bias": ParamDef((h,), "uniform_log"),
        "A_log": ParamDef((h,), "uniform_log"),
        "D": ParamDef((h,), "ones"),
        "norm": ParamDef((di,), "ones"),
        "w_out": ParamDef((di, D), "normal", di),
    }


def _mlstm_layout(cfg: ArchConfig) -> dict:
    D = cfg.d_model
    di = _mlstm_inner(cfg)
    h = cfg.num_heads
    W = cfg.ssm_conv
    return {
        "w_up": ParamDef((D, 2 * di), "normal", D),
        "conv_w": ParamDef((W, di), "normal", W),
        "conv_b": ParamDef((di,), "zeros"),
        "w_q": ParamDef((di, di), "normal", di),
        "w_k": ParamDef((di, di), "normal", di),
        "w_v": ParamDef((di, di), "normal", di),
        "w_gates": ParamDef((di, 2 * h), "normal", di),
        "b_gates": ParamDef((2 * h,), "zeros"),
        "norm": ParamDef((di,), "ones"),
        "skip": ParamDef((di,), "zeros"),
        "w_down": ParamDef((di, D), "normal", di),
    }


def _slstm_layout(cfg: ArchConfig) -> dict:
    D = cfg.d_model
    h, dh = cfg.num_heads, cfg.d_model // cfg.num_heads
    f = _slstm_ffn_dim(D)
    return {
        "w_in": ParamDef((D, 4 * D), "normal", D),
        "b_in": ParamDef((4 * D,), "zeros"),
        "R": ParamDef((4, h, dh, dh), "normal", dh),
        "norm": ParamDef((D,), "ones"),
        "ffn_norm": ParamDef((D,), "ones"),
        "ffn": {
            "w_gate": ParamDef((D, f), "normal", D),
            "w_up": ParamDef((D, f), "normal", D),
            "w_down": ParamDef((f, D), "normal", f),
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
        return {"norm": ParamDef((D,), "ones"), key: make(cfg)}
    attn = {"attn": _attn_layout, "attn_moe": _attn_layout,
            "mla": _mla_layout, "mla_moe": _mla_layout}.get(kind)
    if attn is None:
        raise ValueError(f"unknown block kind {kind!r}")
    ffn = ({"moe": _moe_layout(cfg)} if kind.endswith("_moe")
           else {"mlp": _mlp_layout(cfg, cfg.d_ff)})
    return {"attn_norm": ParamDef((D,), "ones"), "attn": attn(cfg),
            "mlp_norm": ParamDef((D,), "ones"), **ffn}


def layout(cfg: ArchConfig) -> dict:
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.frontend} frontends are not yet ported")
    Vp, D = cfg.padded_vocab, cfg.d_model
    tree: dict = {
        "embedding": ParamDef((Vp, D), "normal", D),
        "final_norm": ParamDef((D,), "ones"),
        "layers": [_block_layout(cfg, kind) for kind in cfg.block_pattern],
    }
    if not cfg.tie_embeddings:
        tree["w_out"] = ParamDef((Vp, D), "normal", D)
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
# init / counting / bridge
# ---------------------------------------------------------------------------
def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.float32, device="cpu") -> dict:
    """Random weights drawn from ``generator`` (which must live on
    ``device``): normal(0, 1/sqrt(fan_in)) matrices, zeros for biases,
    ones for norms, and log(uniform(1e-3, 0.1)) for the ``uniform_log``
    gate leaves, kept fp32 whatever ``dtype`` is, as the reference.
    Leaves are drawn in :func:`_leaves` order, so a seed fixes the model."""
    defs = layout(cfg)
    made = {}
    for path, d in _leaves(defs):
        if d.init == "normal":
            w = torch.randn(d.shape, generator=generator, device=device,
                            dtype=torch.float32)
            made[path] = (w * (1.0 / math.sqrt(d.fan_in))).to(dtype)
        elif d.init == "zeros":
            made[path] = torch.zeros(d.shape, dtype=dtype, device=device)
        elif d.init == "ones":
            made[path] = torch.ones(d.shape, dtype=dtype, device=device)
        elif d.init == "uniform_log":
            u = torch.rand(d.shape, generator=generator, device=device,
                           dtype=torch.float32)
            made[path] = torch.log(1e-3 + u * (0.1 - 1e-3))
        else:
            raise ValueError(d.init)
    return _map(lambda path, _: made[path], defs)


def count_params_analytical(cfg: ArchConfig,
                            active_only: bool = False) -> int:
    """Parameter count from the layout; ``active_only`` counts a routed
    expert tensor at top_k / num_experts of its size, as the reference."""
    total = 0
    for _, d in _leaves(layout(cfg)):
        n = math.prod(d.shape)
        if active_only and d.expert:
            n = n * (cfg.moe_top_k / cfg.num_experts)
        total += int(n)
    return total


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
