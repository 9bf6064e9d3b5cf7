"""Bring-up of a ``(data, model)`` grid of ranks: ``dp * tp`` processes,
one a rank.

The reference builds a jax ``Mesh`` over the devices of one process
(``repro.launch.mesh``, ``jax.make_mesh((dp, tp), ("data", "model"))``);
the port runs one process per rank (SPMD) over ``torch.distributed``.
:func:`run_ranks` spawns the ranks (the ``spawn`` start method: CUDA
cannot fork), joins them into one process group and calls ``fn(rank,
*args)`` in each, where ``rank`` is a :class:`Rank`; it returns what each
rank's ``fn`` returned, in rank order, and raises if any rank failed (the
other ranks are stopped).

* Global rank ``g = d * tp + m`` sits at data index ``d`` and model index
  ``m``: the row-major order of the reference's ``("data", "model")``
  mesh. With ``dp`` > 1 every rank makes, in the same order, one
  ``new_group`` per model group (ranks ``d*tp .. d*tp+tp-1``: a
  tensor-parallel replica) and one per data group (ranks ``m, tp+m, ...``:
  the replicas' rank ``m``), and keeps its own two. With ``dp`` == 1 the
  model group is the default group and there is no data group.
* Rendezvous goes through a ``FileStore`` in a temporary directory, so no
  TCP port is chosen and parallel test workers cannot collide; gloo binds
  to the loopback interface.
* The placement the caller asks for fixes the collective backend
  (:func:`check_geometry`): ``gloo`` on the CPU; ``nccl`` with one CUDA
  card a rank (rank ``g`` on card ``g``); ``gloo`` with every rank on one
  card, which only ``share_card=True`` asks for (NCCL refuses two ranks
  of one communicator on one card; gloo copies CUDA tensors through host
  memory for its collectives). More ranks than cards without
  ``share_card``, or CUDA where there is none, raise with a message that
  names the fix.

Serving's data-parallel replicas run in the router of each process (the
reference's single-controller router), not one a rank:
:func:`split_data_axis` gives each replica its device, behind
``DeviceContext.split_replicas``. The reference's duet sub-mesh split
(``split_duet_submeshes``) stays unported: its Hopper counterpart is SM
partitioning.

Usage::

    def body(rank, cfg):
        ctx = rank.context(cfg)
        ...
    outs = run_ranks(body, 2, device="cpu", args=(cfg,))
    outs = run_ranks(body, 2, dp=2, device="cpu", args=(cfg,))
"""
from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, List, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import DeviceContext

# a group not done in this time is stopped (the collectives' own timeout
# too): the card's longest TP run takes a few minutes
TIMEOUT_S = 900.0


@dataclass(frozen=True)
class Rank:
    """What one rank's body is given: its place in the grid. ``rank`` is
    the global rank, ``d * tp + m``."""
    tp: int
    rank: int
    backend: str
    device: torch.device
    dp: int = 1
    # the tensor-parallel peers (None: the default group) and, with dp > 1,
    # the data-parallel peers
    model_group: Any = None
    data_group: Any = None

    @property
    def model_rank(self) -> int:
        return self.rank % self.tp

    @property
    def data_rank(self) -> int:
        return self.rank // self.tp

    def context(self, cfg: ArchConfig, *, dp: int = 1,
                share_card: bool = False) -> DeviceContext:
        """This rank's :class:`DeviceContext` for ``cfg`` over its model
        group; ``dp`` > 1 adds that many serving replicas of it
        (``DeviceContext.split_replicas``)."""
        return DeviceContext(cfg, self.device, tp=self.tp,
                             rank=self.model_rank, group=self.model_group,
                             backend=self.backend, dp=dp,
                             share_card=share_card)


def check_geometry(tp: int, device: str, share_card: bool = False,
                   dp: int = 1) -> str:
    """The collective backend of ``dp * tp`` ranks placed as asked:
    ``gloo`` on the CPU or with ``share_card`` (every rank on card 0),
    ``nccl`` with a card a rank. Raises for more ranks than cards without
    ``share_card``, and for CUDA where there is none (never a quiet move
    to the CPU)."""
    if tp < 1 or dp < 1:
        raise ValueError(f"tp must be >= 1 and dp >= 1, got tp={tp} "
                         f"dp={dp}")
    if device == "cpu":
        return "gloo"
    if device != "cuda":
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "(--device cpu) to run the ranks on the CPU")
    if share_card:
        return "gloo"
    have, n = torch.cuda.device_count(), dp * tp
    if n > have:
        raise ValueError(
            f"{n} ranks (dp={dp} x tp={tp}) need {n} CUDA cards (one a "
            f"rank, over nccl) but only {have} are visible; pass "
            "share_card=True (--share-card) to run every rank on one card "
            "over gloo, or reduce the grid")
    return "nccl"


def split_data_axis(device, dp: int, share_card: bool = False, *,
                    tp: int = 1, rank: int = 0) -> Tuple[torch.device, ...]:
    """The device of each of ``dp`` data-parallel serving replicas, as
    tensor-parallel rank ``rank`` of ``tp`` holds them: the CPU for every
    replica on the CPU; on CUDA card ``i * tp + rank`` for replica *i*, or
    card 0 (``device``'s card when it names one) for every replica when
    ``share_card`` asks for it. One replica stays on ``device``. Raises
    for more replicas than cards without ``share_card`` (never a quiet
    share), and for CUDA where there is none."""
    if dp < 1:
        raise ValueError(f"dp must be >= 1, got {dp}")
    device = torch.device(device)
    if dp == 1:
        return (device,)
    if device.type == "cpu":
        return (device,) * dp
    if device.type != "cuda":
        raise ValueError(f"device must be cpu or cuda, got {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "(--device cpu) to run the replicas on the CPU")
    if share_card:
        return (torch.device("cuda", device.index or 0),) * dp
    have = torch.cuda.device_count()
    if dp * tp > have:
        raise ValueError(
            f"dp={dp} replicas of tp={tp} need {dp * tp} CUDA cards (one "
            f"a replica's rank) but only {have} are visible; pass "
            "share_card=True (--share-card) to run every replica on one "
            "card, or reduce dp")
    return tuple(torch.device("cuda", i * tp + rank) for i in range(dp))


def rank_device(device: str, rank: int, share_card: bool) -> torch.device:
    if device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", 0 if share_card else rank)


def _grid_groups(dp: int, tp: int, rank: int):
    """(model group, data group) of global rank ``rank``: every rank makes
    every group, model groups first, each in index order."""
    import torch.distributed as dist
    if dp == 1:
        return None, None
    model = [dist.new_group([d * tp + m for m in range(tp)])
             for d in range(dp)]
    data = [dist.new_group([d * tp + m for d in range(dp)])
            for m in range(tp)]
    return model[rank // tp], data[rank % tp]


def _rank_main(rank: int, fn: Callable, tp: int, dp: int, backend: str,
               device: str, share_card: bool, store_path: str, results,
               args: Sequence):
    """One rank's process: join the grid, run ``fn``, report."""
    import torch.distributed as dist
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"      # loopback, no hostname
    torch.set_num_threads(1)                     # the ranks share cores
    dev = rank_device(device, rank, share_card)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    world = dp * tp
    try:
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        model_group, data_group = _grid_groups(dp, tp, rank)
        out = fn(Rank(tp, rank, backend, dev, dp, model_group, data_group),
                 *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, tp: int, *, dp: int = 1, device: str,
              share_card: bool = False, args: Sequence = ()) -> List:
    """Spawn a ``(dp, tp)`` grid of ranks, each running ``fn(rank, *args)``
    in one process group (``fn`` and ``args`` must pickle: a module-level
    function), and return their results in global rank order. Raises,
    after stopping every rank, if a rank raised or died, or if the grid is
    not done in :data:`TIMEOUT_S`."""
    import torch.multiprocessing as mp
    backend = check_geometry(tp, device, share_card, dp)
    world = dp * tp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="tp_store_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, fn, tp, dp, backend, device,
                                   share_card, store, results, tuple(args)))
                 for r in range(world)]
        for p in procs:
            p.start()
        done, deadline = {}, time.time() + TIMEOUT_S
        try:
            while len(done) < world:
                try:
                    rank, ok, val = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)
                            and r not in done]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0][0]} exited with code "
                            f"{dead[0][1]} before reporting")
                    if time.time() > deadline:
                        raise TimeoutError(
                            f"the {world} ranks did not finish in "
                            f"{TIMEOUT_S:.0f} s")
                    continue
                if not ok:
                    raise RuntimeError(
                        f"rank {rank} of {world} failed:\n{val}")
                done[rank] = val
            for p in procs:
                p.join()
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return [done[r] for r in range(world)]
