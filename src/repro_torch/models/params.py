"""Parameter layout, initialisation and the weight bridge from the JAX
reference — dense GQA blocks only.

``layout(cfg)`` builds a tree of :class:`ParamDef` leaves (shape + init
kind) with the reference's layouts, e.g. ``w_q (D,H,Dh)`` and
``w_o (H,Dh,D)``, so both packages compute the same einsums term for term.
``init_params`` materialises it from a ``torch.Generator``;
``params_from_jax`` turns the reference's parameter tree (nested dict of
numpy arrays, as ``jax.tree.map(np.asarray, params)`` gives it) into the
port's tensors. Sharding rules are not yet ported (single device).
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
    init: str                    # normal | ones
    fan_in: Optional[int] = None


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


def _mlp_layout(cfg: ArchConfig, d_ff: int) -> dict:
    D = cfg.d_model
    p = {
        "w_up": ParamDef((D, d_ff), "normal", D),
        "w_down": ParamDef((d_ff, D), "normal", d_ff),
    }
    if cfg.mlp_gated:
        p["w_gate"] = ParamDef((D, d_ff), "normal", D)
    return p


def _block_layout(cfg: ArchConfig, kind: str) -> dict:
    if kind != "attn":
        raise NotImplementedError(
            f"block kind {kind!r} is not yet ported (dense GQA only)")
    D = cfg.d_model
    return {"attn_norm": ParamDef((D,), "ones"), "attn": _attn_layout(cfg),
            "mlp_norm": ParamDef((D,), "ones"),
            "mlp": _mlp_layout(cfg, cfg.d_ff)}


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
    ``device``): normal(0, 1/sqrt(fan_in)) matrices, ones for norms.
    Leaves are drawn in :func:`_leaves` order, so a seed fixes the model."""
    defs = layout(cfg)
    made = {}
    for path, d in _leaves(defs):
        if d.init == "normal":
            w = torch.randn(d.shape, generator=generator, device=device,
                            dtype=torch.float32)
            made[path] = (w * (1.0 / math.sqrt(d.fan_in))).to(dtype)
        elif d.init == "ones":
            made[path] = torch.ones(d.shape, dtype=dtype, device=device)
        else:
            raise ValueError(d.init)
    return _map(lambda path, _: made[path], defs)


def count_params_analytical(cfg: ArchConfig,
                            active_only: bool = False) -> int:
    """Parameter count from the layout. Dense layouts have no expert axis,
    so ``active_only`` counts the same."""
    return sum(int(math.prod(d.shape)) for _, d in _leaves(layout(cfg)))


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
        return torch.from_numpy(arr.copy()).to(device=device, dtype=dtype)

    return _map(convert, defs)
