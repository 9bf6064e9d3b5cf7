"""Production-grid dry run: what one rank holds, computes and sends.

For every (architecture x input shape x grid) combination this runs the
real entry point — ``train_step`` for train_4k, ``prefill`` for
prefill_32k, ``decode_step`` for decode_32k / long_500k — as global rank 0
of the production grid (``launch.mesh.make_production_mesh``: 16 x 16, or
2 x 16 x 16 with ``--multi-pod``, each rank one H100), and records:

  * ``memory``       — the reference's per-device keys:
                       ``argument_size_in_bytes`` counts the rank's shards
                       of the arguments by the reference's specs
                       (``params.param_specs`` for the weights and, for
                       train, the AdamW moments, which the reference makes
                       ``zeros_like`` the weights, and its int32 step;
                       ``cache_pspecs`` for the cache; the batch over the
                       data axes where it is cut), ``output_size_in_bytes``
                       the outputs' bytes; ``temp_size_in_bytes``, the
                       code-size and alias keys are None (the reference's
                       temp is XLA's buffer plan over the spec layout,
                       which the port has no counterpart of)
  * ``rank_memory``  — what rank 0 of the port really holds: the peak of
                       its live tensors, the bytes live at entry, the
                       temp between them (peak less entry) and its
                       weights' share of the entry bytes. A decode rank
                       holds its span of every GQA cache's sequence as
                       ``cache_pspecs`` places it (context-parallel decode:
                       the sequence cut over the data axes at batch 1 and
                       over ``model`` where the KV heads do not divide
                       it), so its entry bytes are the spec's but for two
                       layouts the port keeps: MLA latents stay whole
                       (``whole_sequence`` names those layer kinds; their
                       sequence cut is not yet ported) and a Mamba2 conv
                       tail holds only the rank's channels
  * ``flops``        — ``torch.utils.flop_counter.FlopCounterMode`` over the
                       step: matmul-class ops only, for one rank (the
                       reference's HLO count adds the elementwise ops)
  * ``bytes_accessed`` — every aten op's tensor inputs and outputs, summed
                       (view ops excluded): unfused traffic, an upper bound
                       on what fused kernels move
  * ``collectives``  — the count and bytes of each collective the rank's
                       step makes, by the reference's names, with ``count``
                       and ``total``

How, without allocating: ``torch.distributed`` is initialised with the
fake backend (``torch.testing._internal.distributed.fake_pg``) as rank 0
of all the grid's ranks, with the model and data groups of
``launch.mesh.run_ranks`` (pod x data folded into the data index), and
the step runs under ``FakeTensorMode`` on the CPU device: tensors carry
shapes and dtypes but no storage, no kernel runs and no collective sends
anything. The model, the train step's gradient mean over the data group
and the optimizer's global norm run unchanged; the counts come from
dispatch modes around the step. The entry point runs on no device and
takes no ``--device``: it is not a CPU fallback of the program. Its card
counterpart is ``chip_smoke.py``'s ``dryrun`` phase, which builds one rank
on the H100 and holds its bytes, peak and FLOPs to the record.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod --out results/dryrun_mp.jsonl
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from typing import Optional, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import get_config, input_specs, list_configs
from repro_torch.configs.base import ASSIGNED_ARCHS
from repro_torch.configs.shapes import SHAPES, InputShape
from repro_torch.configs.base import MLA_KINDS
from repro_torch.launch.mesh import (Grid, _grid_groups, batch_split,
                                     make_production_mesh, seq_group)
from repro_torch.models.params import abstract_params, tp_adjusted_config
from repro_torch.models.transformer import (Model, _axes_of, cache_pspecs,
                                            cache_seq_axes)

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# c10d's ops (what a process group receives) by the reference's names; the
# first argument of each is its output
_C10D = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
         "allgather_": "all-gather", "_allgather_base_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "reduce_scatter_tensor_coalesced_": "reduce-scatter",
         "alltoall_": "all-to-all", "alltoall_base_": "all-to-all"}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _grid_name(grid: Grid) -> str:
    return "x".join(str(n) for n in grid.sizes)


class _Census(TorchDispatchMode):
    """Counts what passes through dispatch: each non-view aten op's tensor
    bytes in and out, and each c10d collective's output bytes."""

    def __init__(self):
        super().__init__()
        self.bytes_accessed = 0
        self.collectives = dict.fromkeys(COLLECTIVES, 0)
        self.collectives["count"] = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._overloadpacket.__name__
        if func.namespace == "c10d":
            kind = _C10D.get(name)
            if kind is not None:
                self.collectives[kind] += _nbytes(args[0])
                self.collectives["count"] += 1
        elif func.namespace == "aten" and not func.is_view:
            self.bytes_accessed += _nbytes((args, kwargs, out))
        return out

    def collective_record(self) -> dict:
        rec = dict(self.collectives)
        rec["total"] = sum(rec[c] for c in COLLECTIVES)
        return rec


def _shard_bytes(t: torch.Tensor, spec, shape: dict) -> int:
    """Bytes of one device's shard of ``t`` under a partition spec: each dim
    over the product of its axes' sizes (rounded up, as XLA pads)."""
    n = 1
    for size, entry in zip(t.shape, tuple(spec) + (None,) * t.dim()):
        axes = () if entry is None else \
            (entry,) if isinstance(entry, str) else entry
        n *= math.ceil(size / math.prod(shape[a] for a in axes))
    return n * t.element_size()


def batch_shardings(cfg, shape: InputShape, grid: Grid, specs: dict) -> dict:
    """Each input's partition spec, as the reference's: the cache's from
    :func:`cache_pspecs`, every other input's batch dim over the data axes
    it is cut on (``launch.mesh.batch_split``), the rest whole."""
    on_batch, _ = batch_split(grid, shape.global_batch)
    sh = {}
    for name in specs:
        if name == "cache":
            sh[name] = cache_pspecs(cfg, grid, shape.global_batch,
                                    sliding=shape.sliding)
        else:
            nd = specs[name].dim()
            sh[name] = (on_batch or None, *([None] * (nd - 1)))
    return sh


def argument_bytes(cfg, shape: InputShape, grid: Grid,
                   dtype=torch.bfloat16, kv_dtype=None) -> int:
    """One device's argument bytes under the reference's specs: the rank's
    weight shards (and, for train, the AdamW moments shaped and typed as
    the weights, and the int32 step), the cache's and the inputs' shards."""
    tp = grid.shape.get("model", 1)
    params = _nbytes(abstract_params(cfg, dtype, tp=tp))
    total = params * (3 if shape.kind == "train" else 1)
    if shape.kind == "train":
        total += 4
    specs = input_specs(cfg, shape, kv_dtype=kv_dtype)
    for name, spec in batch_shardings(cfg, shape, grid, specs).items():
        if name == "cache":      # one spec a cache tensor, in tree order
            leaf_specs = [s for entry in spec for s in entry]
            for t, s in zip(tree_leaves(specs[name]), leaf_specs):
                total += _shard_bytes(t, s, grid.shape)
        else:
            total += _shard_bytes(specs[name], spec, grid.shape)
    return total


def _run_rank(cfg, shape: InputShape, grid: Grid, *, mla_absorb, remat,
              kv_dtype, dtype) -> dict:
    """Rank 0's step under FakeTensorMode, with the fake process group
    initialised by the caller: its counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core.device import DeviceContext
    from repro_torch.training.optimizer import AdamWConfig, init_adamw
    from repro_torch.training.train_loop import make_train_step

    tp = grid.shape.get("model", 1)
    dp = grid.size // tp
    model_group, data_group = _grid_groups(dp, tp, 0)
    # a decode rank holds its span of the GQA caches' sequence (its
    # sequence group's partials combine in one all-gather a layer)
    seq, seq_rank, group = seq_group(
        cache_seq_axes(cfg, grid, shape.global_batch)
        if shape.kind == "decode" else (), dp, tp, 0, model_group,
        data_group)
    ctx = DeviceContext(cfg, torch.device("cpu"), tp=tp, rank=0,
                        group=model_group, seq=seq, seq_rank=seq_rank,
                        seq_group=group)
    # the train step takes the global batch and cuts the data rank's rows;
    # prefill and decode run the rank's rows
    B = shape.global_batch if shape.kind == "train" else \
        batch_split(grid, shape.global_batch)[1]
    specs = input_specs(cfg, dataclasses.replace(shape, global_batch=B))
    with FakeTensorMode():
        model = Model.init(cfg, dtype=dtype, ctx=ctx, mla_absorb=mla_absorb,
                           requires_grad=shape.kind == "train",
                           remat=remat)
        params = model.param_tree()
        batch = {k: torch.zeros(t.shape, dtype=t.dtype)
                 for k, t in specs.items() if k != "cache"}
        if shape.kind == "train":
            opt = init_adamw(params)
            step_fn = make_train_step(model, AdamWConfig(),
                                      data_group=data_group)
            args = (params, opt, batch)

            def step():
                return step_fn(params, opt, batch)
        elif shape.kind == "prefill":
            args = (params, batch)

            def step():
                return model.prefill(batch["tokens"],
                                     patch_embeds=batch.get("patch_embeds"))
        else:
            # the rank's layout: its rows, KV heads and span of the GQA
            # caches' sequence (cache_pspecs'), MLA latents whole
            cache = model.init_cache(B, shape.seq_len, kv_dtype,
                                     sliding=shape.sliding)
            args = (params, cache, batch)
            sliding = shape.sliding and not cfg.is_recurrent

            def step():
                return model.decode_step(cache, batch["token"], batch["pos"],
                                         sliding=sliding)
        tracker = MemTracker()
        tracker.track_external(*tree_leaves(args))
        entry = _tracked_total(tracker, "current")
        census = _Census()
        t0 = time.time()
        with FlopCounterMode(display=False) as flops, census, tracker:
            out = step()
        seconds = time.time() - t0
        peak = _tracked_total(tracker, "peak")
    return {"flops": flops.get_total_flops(),
            "weights": _nbytes(params),
            "bytes_accessed": census.bytes_accessed,
            "collectives": census.collective_record(),
            "entry": entry, "peak": peak, "output": _nbytes(out),
            "seconds": seconds}


def _tracked_total(tracker, which: str) -> int:
    return sum(snap["Total"] for snap in
               tracker.get_tracker_snapshot(which).values())


def _whole_sequence(cfg, shape: InputShape, grid: Grid) -> list:
    """The layer kinds whose decode cache the port's rank keeps whole
    along a sequence that ``cache_pspecs`` cuts: MLA's latents (their
    sequence cut is not yet ported); [] elsewhere."""
    if shape.kind != "decode":
        return []
    specs = cache_pspecs(cfg, grid, shape.global_batch,
                         sliding=shape.sliding)
    return sorted({kind for kind, spec in zip(cfg.block_pattern, specs)
                   if kind in MLA_KINDS and math.prod(
                       grid.shape[a] for a in _axes_of(spec[0][1])) > 1})


def lower_one(arch: str, shape_name: Union[str, InputShape], *,
              multi_pod: bool = False, mla_absorb: bool = False,
              remat: bool = True, kv_f8: bool = False,
              pad_experts: bool = False, verbose: bool = True,
              grid: Optional[Grid] = None, cfg=None,
              dtype=torch.bfloat16) -> dict:
    """One combination's record. ``grid`` (default: the production grid,
    ``multi_pod`` choosing which) and ``cfg`` (default: ``get_config(arch)``)
    and ``dtype`` (the weights'; bf16 as the reference's) are the port's
    arguments, for smaller grids and configs; ``shape_name`` may be an
    :class:`InputShape`."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    grid = grid or make_production_mesh(multi_pod=multi_pod)
    tp = grid.shape.get("model", 1)
    cfg = tp_adjusted_config(cfg or get_config(arch), tp,
                             pad_experts=pad_experts)
    kv_dtype = torch.float8_e4m3fn if kv_f8 else torch.bfloat16
    if dist.is_initialized():
        raise RuntimeError("lower_one initialises its own (fake) process "
                           "group; call it where none is initialised")
    # the group prefixes uncaught tracebacks with its rank; not past here
    hook = sys.excepthook
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=grid.size)
    try:
        run = _run_rank(cfg, shape, grid, mla_absorb=mla_absorb, remat=remat,
                        kv_dtype=kv_dtype, dtype=dtype)
    finally:
        dist.destroy_process_group()
        sys.excepthook = hook
    args = argument_bytes(cfg, shape, grid, dtype, kv_dtype)
    record = {
        "arch": arch,
        "shape": shape.name,
        "mesh": _grid_name(grid),
        "num_devices": grid.size,
        "entry": shape.kind,
        "mla_absorb": mla_absorb,
        "kv_f8": kv_f8,
        "pad_experts": pad_experts,
        "flops": run["flops"],
        "bytes_accessed": run["bytes_accessed"],
        "memory": {"argument_size_in_bytes": args,
                   "output_size_in_bytes": run["output"],
                   "temp_size_in_bytes": None,
                   "generated_code_size_in_bytes": None,
                   "alias_size_in_bytes": None},
        "rank_memory": {"peak_bytes": run["peak"],
                        "entry_bytes": run["entry"],
                        "temp_bytes": run["peak"] - run["entry"],
                        "weight_bytes": run["weights"],
                        "whole_sequence": _whole_sequence(cfg, shape,
                                                          grid)},
        "collectives": run["collectives"],
        "lower_s": round(run["seconds"], 2),
        "compile_s": None,
    }
    if verbose:
        print(json.dumps(record))
    return record


def build_parser() -> argparse.ArgumentParser:
    """Dry-run CLI (the reference's options)."""
    ap = argparse.ArgumentParser(
        description="Run one rank of the production grid's entry points "
                    "on shape-only tensors, without allocating or "
                    "executing, and record its bytes, FLOPs and "
                    "collectives.")
    ap.add_argument("--arch", choices=list_configs())
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mla-absorb", action="store_true")
    ap.add_argument("--kv-f8", action="store_true")
    ap.add_argument("--pad-experts", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--out", default=None)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    if args.all:
        combos = [(a, s) for a in ASSIGNED_ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            raise SystemExit("pass --arch and --shape, or --all")
        combos = [(args.arch, args.shape)]

    records = []
    mesh = "2x16x16" if args.multi_pod else "16x16"
    for arch, shape in combos:
        try:
            rec = lower_one(arch, shape, multi_pod=args.multi_pod,
                            mla_absorb=args.mla_absorb, kv_f8=args.kv_f8,
                            pad_experts=args.pad_experts,
                            remat=not args.no_remat)
        except Exception as e:  # noqa: BLE001 — a failed combo is a bug; record it
            rec = {"arch": arch, "shape": shape, "mesh": mesh,
                   "error": f"{type(e).__name__}: {e}"}
            print(json.dumps(rec), file=sys.stderr)
        records.append(rec)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
    ok = sum(1 for r in records if "error" not in r)
    print(f"# dry-run: {ok}/{len(records)} combos ran", file=sys.stderr)
    return 0 if ok == len(records) else 1


if __name__ == "__main__":
    sys.exit(main())
