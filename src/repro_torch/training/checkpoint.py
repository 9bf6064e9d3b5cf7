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
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.models.params import _leaves, _map
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
                    step: int = 0) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {f"params/{k}": v for k, v in _flatten(params).items()}
    if opt_state is not None:
        payload.update({f"opt/{k}": v
                        for k, v in _flatten_opt(opt_state).items()})
    payload["meta/step"] = np.asarray(step)
    tmp = path + ".tmp"
    np.savez(tmp, **payload)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)
    return path


def _restore(data, prefix: str, template):
    def load(path, t):
        arr = data[f"{prefix}{_key(path)}"]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint {prefix}{_key(path)} has shape "
                             f"{arr.shape}, the template {tuple(t.shape)}")
        arr = np.array(arr)
        if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
            # the reference's bf16 leaf: its bit patterns
            out = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            out = torch.from_numpy(arr)
        out = out.to(device=t.device, dtype=t.dtype)
        return out.requires_grad_(t.requires_grad)
    return _map(load, template)


def load_checkpoint(path: str, params_template, opt_template=None):
    """Restore into the structure of the provided templates: new tensors
    with each template leaf's shape, dtype, device and ``requires_grad``.
    Returns (params, opt_state or None, step)."""
    data = np.load(path)
    params = _restore(data, "params/", params_template)
    step = int(data["meta/step"])
    if opt_template is None:
        return params, None, step
    opt = AdamWState(
        step=torch.from_numpy(np.array(data["opt/.step"])).to(
            opt_template.step.dtype),
        mu=_restore(data, "opt/.mu/", opt_template.mu),
        nu=_restore(data, "opt/.nu/", opt_template.nu))
    return params, opt, step
