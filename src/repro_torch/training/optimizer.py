"""Optimizer and LR schedules: AdamW with decoupled weight decay over a
parameter tree (nested dicts and lists of tensors), updated in place.

Schedules: linear-warmup cosine, constant, and WSD (warmup–stable–decay,
the MiniCPM schedule [arXiv:2404.06395] of ``minicpm-2b``: a constant LR
plateau, then a short ``0.5 ** (10 t)`` decay tail).

The numbers are the reference's (``repro.training.optimizer``): the
gradients are clipped by their global norm, the moments are fp32 and
bias-corrected, the weight decay is decoupled and applies to every leaf,
and the learning rate is taken at ``step + 1`` (the schedule of the step
being made). The schedule is computed on the host in fp32 from the host's
step counter, so an update makes no host sync; the clip scale stays on
the device.

Tensor parallelism (``ctx``, a ``DeviceContext`` with tp > 1): each rank
updates its slices in place. The global norm sums the squares of the cut
leaves over the model group and adds the whole leaves' once (their
gradients are equal on every rank); the clip, the moments and the weight
decay are elementwise, so they stay per slice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from repro_torch.models.params import _leaves, _map, cut_dims


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32, on the host
    mu: dict             # first moments, fp32, shaped as the parameters
    nu: dict             # second moments


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"        # cosine | wsd | constant
    warmup_steps: int = 100
    total_steps: int = 10_000
    stable_fraction: float = 0.9    # WSD: fraction of steps at constant LR


def schedule_fn(cfg: AdamWConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (an int or a host tensor) -> the learning rate, a 0-dim fp32
    host tensor, computed in fp32 as the reference does."""
    if cfg.schedule not in ("constant", "cosine", "wsd"):
        raise ValueError(cfg.schedule)

    def fn(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
        if cfg.schedule == "constant":
            return cfg.lr * warm
        if cfg.schedule == "cosine":
            t = torch.clamp((step - cfg.warmup_steps)
                            / max(1, cfg.total_steps - cfg.warmup_steps),
                            0, 1)
            return cfg.lr * warm * 0.5 * (1 + torch.cos(math.pi * t))
        stable_end = cfg.total_steps * cfg.stable_fraction
        decay_len = max(1.0, cfg.total_steps - stable_end)
        t = torch.clamp((step - stable_end) / decay_len, 0.0, 1.0)
        # MiniCPM: a rapid decay tail after the stable phase
        tail = torch.where(step < stable_end, torch.ones_like(t),
                           torch.pow(0.5, 10.0 * t))
        return cfg.lr * warm * tail
    return fn


def init_adamw(params) -> AdamWState:
    """Step 0 and zero fp32 moments beside each parameter, on its device."""
    def zeros():
        return _map(lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
    return AdamWState(step=torch.zeros((), dtype=torch.int32), mu=zeros(),
                      nu=zeros())


def global_norm(tree, ctx=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32, the leaves summed
    in the reference's order. Under a TP ``ctx``, ``tree`` holds the
    rank's slices: the cut leaves' squares are summed over the model
    group, then the whole leaves' are added once."""
    if ctx is None or ctx.tp <= 1:
        return torch.sqrt(sum(x.float().square().sum()
                              for _, x in _leaves(tree)))
    dims = cut_dims(ctx.cfg, ctx.tp)
    zero = next(iter(_leaves(tree)))[1].new_zeros((), dtype=torch.float32)
    cut = sum((x.float().square().sum() for path, x in _leaves(tree)
               if dims[path] is not None), zero)
    torch.distributed.all_reduce(cut, group=ctx.group)
    return torch.sqrt(cut + sum(x.float().square().sum()
                                for path, x in _leaves(tree)
                                if dims[path] is None))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: AdamWState, params,
                 ctx=None):
    """One AdamW step: ``params`` and the moments are updated in place.
    Returns (params, new state, metrics {"grad_norm", "lr"}). Under a TP
    ``ctx`` the trees are the rank's slices (:func:`global_norm`)."""
    gnorm = global_norm(grads, ctx)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip else 1.0)
    step = state.step + 1
    lr = schedule_fn(cfg)(step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(cfg.b1, stepf)
    b2c = 1 - torch.pow(cfg.b2, stepf)
    grad = dict(_leaves(grads))
    mu, nu = dict(_leaves(state.mu)), dict(_leaves(state.nu))
    for path, p in _leaves(params):
        g = grad[path].float() * scale
        m, v = mu[path], nu[path]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), \
        {"grad_norm": gnorm, "lr": lr}
