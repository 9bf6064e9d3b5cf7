"""Training launcher: train a config on one device (CLI).

The port's counterpart of ``repro.launch.train``: random fp32 weights from
``--seed`` (each block checkpointed, as the reference's ``remat=True``),
AdamW on the config's schedule (``cfg.lr_schedule``: cosine, or WSD for
minicpm-2b) with a warmup of ``max(2, steps // 10)``, batches from the
port's data pipeline. It runs on the CUDA card unless ``--device cpu`` is
given, and raises without one. Data- and tensor-parallel training
(``--data`` or ``--model`` above 1) are not yet ported.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --reduced --device cpu --steps 20 --batch 4 --seq 64
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.core.device import resolve_device
from repro_torch.data import data_iterator
from repro_torch.models.transformer import Model
from repro_torch.training.optimizer import AdamWConfig, init_adamw
from repro_torch.training.train_loop import make_train_step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Train a config with the "
                                             "port's AdamW loop.")
    ap.add_argument("--arch", choices=list_configs(), default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel degree (only 1 is ported)")
    ap.add_argument("--model", type=int, default=1,
                    help="model-parallel degree (only 1 is ported)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv=None):
    """Train and print the reference's line every 5 steps and at the last.
    Returns the loss of every step."""
    args = build_parser().parse_args(argv)
    if args.data > 1 or args.model > 1:
        raise NotImplementedError(
            "data- and tensor-parallel training (--data, --model above 1) "
            "are not yet ported (ROADMAP.md Queue 1 item 2); train on one "
            "device")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = Model.init(cfg, seed=args.seed, dtype=torch.float32,
                       device=device, requires_grad=True, remat=True)
    params = model.param_tree()
    opt_state = init_adamw(params)
    opt_cfg = AdamWConfig(lr=args.lr, schedule=cfg.lr_schedule,
                          warmup_steps=max(2, args.steps // 10),
                          total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg)
    data = data_iterator(cfg, seq_len=args.seq, batch_size=args.batch,
                         seed=args.seed)
    losses = []
    for step in range(args.steps):
        params, opt_state, metrics = step_fn(params, opt_state, next(data))
        losses.append(metrics["loss"])
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {float(metrics['loss']):.4f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
    return [float(x) for x in losses]


if __name__ == "__main__":
    main()
