"""Checkpointing: flat-key ``.npz`` of (params, opt_state, step), in the
reference's format (``repro.training.checkpoint``), so a file written by
either package loads into the other.

Keys: ``params/<path>`` for each weight (``layers/0/attn/w_q``),
``opt/.step``, ``opt/.mu/<path>`` and ``opt/.nu/<path>`` for the AdamW
state (the names ``jax.tree_util`` gives a NamedTuple's fields), and
``meta/step``. numpy has no bf16, so the port writes bf16 leaves as fp32;
a load casts each array to its template leaf's dtype and device. The
reference's loader does not cast: it returns such a leaf as fp32 even in
a bf16 template. The reference writes bf16 leaves as ml_dtypes bf16
arrays, which ``np.load`` returns as numpy void ``|V2``; the port reads
those as bf16 bit patterns, so they load bit-exact.

On the ``(data, model)`` grid (``ctx``, a ``DeviceContext`` with tp > 1)
the file still holds the whole tree: :func:`save_checkpoint` gathers the
weights and moments over the model group (every rank takes part) and
global rank 0 writes; :func:`load_checkpoint` reads the whole arrays on
every rank and keeps the rank's slices (``models.params.shard_params``).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.models.params import (_leaves, _map, _shard_leaf,
                                       gather_params, param_specs)
from repro_torch.training.optimizer import AdamWState


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _flatten(tree) -> dict:
    return {_key(path): _to_numpy(leaf) for path, leaf in _leaves(tree)}


def _flatten_opt(state: AdamWState) -> dict:
    out = {".step": _to_numpy(state.step)}
    for field in ("mu", "nu"):
        out.update({f".{field}/{k}": v
                    for k, v in _flatten(getattr(state, field)).items()})
    return out


def save_checkpoint(path: str, params, opt_state: AdamWState = None,
                    step: int = 0, ctx=None) -> str:
    """Write (params, opt_state, step) to ``path``. In a process group
    every rank calls it (the gather under TP is a collective) and global
    rank 0 writes; the ranks meet at a barrier after the write, so any
    rank may load the file next."""
    if ctx is not None and ctx.tp > 1:
        params = gather_params(params, ctx)
        if opt_state is not None:
            opt_state = opt_state._replace(
                mu=gather_params(opt_state.mu, ctx),
                nu=gather_params(opt_state.nu, ctx))
    dist = torch.distributed
    grid = dist.is_available() and dist.is_initialized()
    if not grid or dist.get_rank() == 0:
        _write(path, params, opt_state, step)
    if grid:
        dist.barrier()
    return path


def _write(path: str, params, opt_state, step: int):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {f"params/{k}": v for k, v in _flatten(params).items()}
    if opt_state is not None:
        payload.update({f"opt/{k}": v
                        for k, v in _flatten_opt(opt_state).items()})
    payload["meta/step"] = np.asarray(step)
    tmp = path + ".tmp"
    np.savez(tmp, **payload)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def _restore(data, prefix: str, template, ctx=None):
    specs = (dict(_leaves(param_specs(ctx.cfg, ctx.tp)))
             if ctx is not None and ctx.tp > 1 else None)

    def load(path, t):
        arr = np.array(data[f"{prefix}{_key(path)}"])
        if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
            # the reference's bf16 leaf: its bit patterns
            out = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            out = torch.from_numpy(arr)
        if specs is not None:
            out = _shard_leaf(out, specs[path], ctx.tp, ctx.rank)
        if tuple(out.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint {prefix}{_key(path)} has shape "
                             f"{arr.shape}, the template "
                             f"{tuple(t.shape)}")
        out = out.to(device=t.device, dtype=t.dtype, copy=True)
        return out.requires_grad_(t.requires_grad)
    return _map(load, template)


def load_checkpoint(path: str, params_template, opt_template=None,
                    ctx=None):
    """Restore into the structure of the provided templates: new tensors
    with each template leaf's shape, dtype, device and ``requires_grad``;
    under a TP ``ctx`` the templates hold the rank's slices, which are cut
    from the file's whole arrays. Returns (params, opt_state or None,
    step)."""
    data = np.load(path)
    params = _restore(data, "params/", params_template, ctx)
    step = int(data["meta/step"])
    if opt_template is None:
        return params, None, step
    opt = AdamWState(
        step=torch.from_numpy(np.array(data["opt/.step"])).to(
            opt_template.step.dtype),
        mu=_restore(data, "opt/.mu/", opt_template.mu, ctx),
        nu=_restore(data, "opt/.nu/", opt_template.nu, ctx))
    return params, opt, step
