"""Training step factory and loop.

``make_train_step(model, opt_cfg)`` returns a function ``(params,
opt_state, batch) -> (params, opt_state, metrics)``, as the reference's
(``repro.training.train_loop``): the loss of the batch, its gradients by
autograd, then one AdamW update. ``params`` is the model's own tree of
weights (``Model.param_tree()`` of a model built from
``models.params.trainable`` leaves); the update writes it in place, so the
model trains through it. A batch is the data pipeline's numpy dict; it is
copied to the model's device here.
"""
from __future__ import annotations

import time
from typing import Callable, Iterator, Optional

import torch

from repro_torch.core.device import to_device
from repro_torch.models.params import _leaves, _map
from repro_torch.models.transformer import Model
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_update, init_adamw)


def batch_to(batch: dict, device: torch.device) -> dict:
    """A data-pipeline batch (numpy arrays) as tensors on ``device``."""
    return {k: to_device(v, device) for k, v in batch.items()}


def make_train_step(model: Model, opt_cfg: AdamWConfig) -> Callable:
    def train_step(params, opt_state: AdamWState, batch: dict):
        if params["final_norm"] is not model.params["final_norm"]:
            raise ValueError("train_step: params must be the model's own "
                             "weights (model.param_tree())")
        leaves = list(_leaves(params))
        if not all(t.requires_grad for _, t in leaves):
            raise ValueError("train_step: the model's weights must require "
                             "grad (build it from models.params.trainable)")
        if not all(isinstance(v, torch.Tensor) for v in batch.values()):
            batch = batch_to(batch, model.device)
        loss = model.loss(batch)
        grads = dict(zip((p for p, _ in leaves), torch.autograd.grad(
            loss, [t for _, t in leaves])))
        params, opt_state, metrics = adamw_update(
            opt_cfg, _map(lambda path, _: grads[path], params), opt_state,
            params)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step


def train(model: Model, params, data: Iterator[dict], opt_cfg: AdamWConfig,
          num_steps: int, *, log_every: int = 10,
          checkpoint_path: Optional[str] = None,
          checkpoint_every: int = 0,
          log_fn=print):
    """Simple single-device loop, the reference's log line every
    ``log_every`` steps and at the last (each one a host read of the
    loss)."""
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
            save_checkpoint(checkpoint_path, params, opt_state, step + 1)
    return params, opt_state, history
