"""Training launcher: train a config on one device or on a ``(data,
model)`` grid of ranks (CLI).

The port's counterpart of ``repro.launch.train``: random fp32 weights from
``--seed`` (each block checkpointed, as the reference's ``remat=True``),
AdamW on the config's schedule (``cfg.lr_schedule``: cosine, or WSD for
minicpm-2b) with a warmup of ``max(2, steps // 10)``, batches from the
port's data pipeline. It runs on the CUDA card unless ``--device cpu`` is
given, and raises without one.

``--data N --model M`` trains on ``N * M`` ranks, one process each
(``launch/mesh.py:run_ranks``), as the reference's ``("data", "model")``
mesh: each model group of M ranks holds one tensor-parallel replica's
slices of the weights and moments, each data rank trains on its
``batch / N`` rows of every global batch, and the gradients are averaged
over the data ranks (``training/train_loop.py``). ``--data 0`` (the
default, as the reference's) is the visible cards over ``--model`` (1 on
the CPU). The ranks talk over gloo on the CPU, over nccl with a card a
rank, and over gloo with ``--share-card``, which puts every rank on card
0. Global rank 0 prints the reference's log line.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --reduced --device cpu --steps 20 --batch 4 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
      --device cpu --data 2 --model 2 --steps 5 --batch 4 --seq 64
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.core.device import DeviceContext, resolve_device
from repro_torch.data import data_iterator
from repro_torch.launch.mesh import run_ranks
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
    ap.add_argument("--data", type=int, default=0,
                    help="data-parallel degree (0 = the visible cards over "
                         "--model; 1 on the CPU)")
    ap.add_argument("--model", type=int, default=1,
                    help="model-parallel (tensor-parallel) degree")
    ap.add_argument("--share-card", action="store_true",
                    help="a grid on CUDA: every rank on card 0, over gloo "
                         "(its collectives copy through host memory)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv=None):
    """Train and print the reference's line every 5 steps and at the last
    (global rank 0). Returns the loss of every step (rank 0's: the data
    group's mean)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.model < 1 or args.data < 0:
        raise SystemExit("--model must be >= 1 and --data >= 0")
    visible = torch.cuda.device_count() if device.type == "cuda" else 1
    dp = args.data or max(1, visible // args.model)
    if args.batch % dp:
        raise SystemExit(f"--batch {args.batch} does not split over --data "
                         f"{dp} ranks")
    if dp * args.model == 1:
        return _train(None, args, device)
    return run_ranks(_train, args.model, dp=dp, device=device.type,
                     share_card=args.share_card, args=(args, None))[0]


def _train(rank, args, device):
    """The loop on one device (``rank`` None) or as one rank of the grid
    (``launch.mesh.Rank``)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    ctx = (DeviceContext(cfg, device) if rank is None
           else rank.context(cfg))
    model = Model.init(cfg, seed=args.seed, dtype=torch.float32, ctx=ctx,
                       requires_grad=True, remat=True)
    params = model.param_tree()
    opt_state = init_adamw(params)
    opt_cfg = AdamWConfig(lr=args.lr, schedule=cfg.lr_schedule,
                          warmup_steps=max(2, args.steps // 10),
                          total_steps=args.steps)
    step_fn = make_train_step(
        model, opt_cfg, data_group=None if rank is None else rank.data_group)
    data = data_iterator(cfg, seq_len=args.seq, batch_size=args.batch,
                         seed=args.seed)
    out_rank = rank is None or rank.rank == 0
    losses = []
    for step in range(args.steps):
        params, opt_state, metrics = step_fn(params, opt_state, next(data))
        losses.append(metrics["loss"])
        if out_rank and (step % 5 == 0 or step == args.steps - 1):
            print(f"step {step:4d} loss {float(metrics['loss']):.4f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
    return [float(x) for x in losses]


if __name__ == "__main__":
    main()
