"""Training step factory and loop.

``make_train_step(model, opt_cfg)`` returns a function ``(params,
opt_state, batch) -> (params, opt_state, metrics)``, as the reference's
(``repro.training.train_loop``): the loss of the batch, its gradients by
autograd, then one AdamW update. ``params`` is the model's own tree of
weights (``Model.param_tree()`` of a model built from
``models.params.trainable`` leaves); the update writes it in place, so the
model trains through it. A batch is the data pipeline's numpy dict; it is
copied to the model's device here.

The ``(data, model)`` grid (``launch.mesh.run_ranks``): under a TP model
(``model.ctx``) the weights are the rank's slices and autograd's
collectives (``DeviceContext.copy_to_model`` / ``reduce_from_model``)
leave every rank the gradients of its slices and the whole leaves' whole
gradients; ``adamw_update`` takes the context for the global norm. With a
``data_group`` every step is given the global batch and data rank ``d``
of ``dp`` trains on its rows (``data.shard_batch``); the gradients are
mean-all-reduced over the data group in one flat fp32 bucket before the
update, so the clip sees the whole batch's gradient, and the reported
loss is the data group's mean, which is the whole batch's loss (the
cross-entropy is an unmasked mean over equal shards). An MoE config
matches one device under DP only where each rank's tokens are whole
routing groups (``models.moe``).
"""
from __future__ import annotations

import time
from typing import Callable, Iterator, Optional

import torch

from repro_torch.core.device import to_device
from repro_torch.data.pipeline import shard_batch
from repro_torch.models.params import _leaves, _map
from repro_torch.models.transformer import Model
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_update, init_adamw)


def batch_to(batch: dict, device: torch.device) -> dict:
    """A data-pipeline batch (numpy arrays) as tensors on ``device``."""
    return {k: to_device(v, device) for k, v in batch.items()}


def _mean_over(grads: list, group) -> list:
    """Each gradient's mean over ``group``, in one flat fp32 all-reduce."""
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    torch.distributed.all_reduce(flat, group=group)
    flat /= torch.distributed.get_world_size(group)
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view(g.shape).to(g.dtype))
        at += g.numel()
    return out


def make_train_step(model: Model, opt_cfg: AdamWConfig, *,
                    data_group=None) -> Callable:
    """The train step of ``model``; ``data_group``: this rank's
    data-parallel peers (module docstring), whose steps must be given the
    same global batches."""
    dp = 1 if data_group is None else \
        torch.distributed.get_world_size(data_group)
    d = 0 if data_group is None else torch.distributed.get_rank(data_group)

    def train_step(params, opt_state: AdamWState, batch: dict):
        if params["final_norm"] is not model.params["final_norm"]:
            raise ValueError("train_step: params must be the model's own "
                             "weights (model.param_tree())")
        leaves = list(_leaves(params))
        if not all(t.requires_grad for _, t in leaves):
            raise ValueError("train_step: the model's weights must require "
                             "grad (build it from models.params.trainable)")
        if dp > 1:
            batch = shard_batch(batch, d, dp)
        if not all(isinstance(v, torch.Tensor) for v in batch.values()):
            batch = batch_to(batch, model.device)
        loss = model.loss(batch)
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
        loss = loss.detach()
        if dp > 1:
            grads = _mean_over(grads, data_group)
            torch.distributed.all_reduce(loss, group=data_group)
            loss /= dp
        grads = dict(zip((p for p, _ in leaves), grads))
        params, opt_state, metrics = adamw_update(
            opt_cfg, _map(lambda path, _: grads[path], params), opt_state,
            params, ctx=model.ctx)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def train(model: Model, params, data: Iterator[dict], opt_cfg: AdamWConfig,
          num_steps: int, *, log_every: int = 10,
          checkpoint_path: Optional[str] = None,
          checkpoint_every: int = 0,
          log_fn=print):
    """Simple loop, the reference's log line every ``log_every`` steps and
    at the last (each one a host read of the loss). A TP model's
    checkpoints hold the whole tree (written by global rank 0)."""
    from repro_torch.training.checkpoint import save_checkpoint

    opt_state = init_adamw(params)
    step_fn = make_train_step(model, opt_cfg)
    history = []
    t0 = time.time()
    for step in range(num_steps):
        batch = next(data)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % log_every == 0 or step == num_steps - 1:
            loss = float(metrics["loss"])
            history.append((step, loss))
            log_fn(f"step {step:5d} loss {loss:.4f} "
                   f"lr {float(metrics['lr']):.2e} "
                   f"gnorm {float(metrics['grad_norm']):.3f} "
                   f"({time.time() - t0:.1f}s)")
        if checkpoint_path and checkpoint_every \
                and (step + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint_path, params, opt_state, step + 1,
                            ctx=model.ctx)
    return params, opt_state, history
