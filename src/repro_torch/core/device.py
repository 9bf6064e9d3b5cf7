"""Device placement for the port: the device an entry point runs on, the
host <-> device copies of the engines, and the tensor-parallel context.

* :class:`DeviceContext` — the counterpart of the reference's
  ``repro.core.device.DeviceContext`` over ``torch.distributed`` instead
  of a jax ``Mesh``: the TP degree and this process's rank, the process
  group and its backend, the per-arch axis rules, the rank's slice of the
  weights and its KV heads, and the one collective the model makes
  (:meth:`DeviceContext.all_reduce`). One process runs one rank (SPMD):
  every rank runs the same engine on the same requests with its own
  slices of the weights and page pools, and the all-reduces leave the
  residual stream and the logits identical on every rank, so every rank
  samples the same tokens. Tables, lengths and positions stay
  rank-global, as the reference replicates them. Single-device serving is
  ``DeviceContext.single`` (tp 1, no group: ``all_reduce`` is the
  identity). The DP half (``dp``, :meth:`DeviceContext.split_replicas`)
  describes data-parallel replicas served from ONE process, as the
  reference's single-controller router does: ``split_replicas`` gives
  each replica a TP-1 context on its own device
  (``launch.mesh.split_data_axis``: card *i* when there are ``dp`` cards,
  card 0 for every replica only with ``share_card``, or the CPU). DP over
  TP groups is not yet ported.

  What a rank holds follows the reference's axis rules
  (``models.params.axis_rules``): the vocab always shards (embedding,
  logits, the audio codebook tables and heads); GQA and MLA heads shard
  when the query heads (and GQA's KV heads) divide the axis; dense and
  shared-expert FFNs on ``ffn``; the MoE on ``experts`` when the expert
  count divides, else on each expert's ``moe_ffn`` columns (routing stays
  global either way); Mamba2 on ``ssm_inner`` / ``ssm_heads`` (its B/C
  projections and conv weights stay whole); the mLSTM and sLSTM blocks
  stay whole. A sharded block ends in one all-reduce, a whole one in none;
  :meth:`DeviceContext.collectives_per_iteration` counts them.

* :func:`resolve_device` — ``None`` means the card. Without CUDA that is an
  error, never a quiet move to the CPU; the CPU runs only when asked for.
* :func:`to_device` — host numpy to the device without a host sync (pinned
  staging buffer + ``non_blocking``), so the async engine can upload
  dispatch inputs while the previous program still runs.
* :func:`fetch_to_host` — every tensor of one iteration copied back with a
  single blocking synchronisation (the port's ``jax.device_get``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import GQA_KINDS, MLA_KINDS, ArchConfig

DeviceLike = Union[None, str, torch.device]


class DeviceContext:
    """One rank of a tensor-parallel group (or the single device).

    ``shape`` is ``{"model": tp}``, so the roofline and the multiplexer
    take a context where the reference passes its ``Mesh``. The group's
    process group must be initialised before a context with ``tp`` > 1 is
    used (``repro_torch.launch.mesh`` does it)."""

    def __init__(self, cfg: ArchConfig, device: torch.device, *,
                 tp: int = 1, rank: int = 0, group=None,
                 backend: Optional[str] = None, dp: int = 1,
                 share_card: bool = False):
        # the models package imports this module
        from repro_torch.models.params import axis_rules
        if tp < 1 or not 0 <= rank < tp:
            raise ValueError(f"DeviceContext: rank {rank} of tp {tp}")
        if dp < 1:
            raise ValueError(f"DeviceContext: dp must be >= 1, got {dp}")
        if dp > 1 and tp > 1:
            raise NotImplementedError(
                "data parallelism over tensor-parallel replicas (--dp with "
                "--tp > 1) is not yet ported; serve tp=1 replicas")
        self.cfg = cfg
        self.tp = tp
        self.dp = dp
        self.share_card = share_card
        self.rank = rank
        self.group = group
        self.backend = backend
        # one device a replica, validated here (raises for more replicas
        # than cards without share_card); the context's own device is
        # replica 0's
        self.replica_devices = (torch.device(device),)
        if dp > 1:
            from repro_torch.launch.mesh import split_data_axis
            self.replica_devices = split_data_axis(device, dp, share_card)
        self.device = self.replica_devices[0]
        self._rules = axis_rules(cfg, tp)
        # all-reduces made since construction (the model's collectives)
        self.all_reduces = 0

    @classmethod
    def single(cls, cfg: ArchConfig,
               device: DeviceLike = None) -> "DeviceContext":
        """The default context: one device, no collectives."""
        return cls(cfg, resolve_device(device))

    @classmethod
    def for_replicas(cls, cfg: ArchConfig, dp: int, device: DeviceLike = None,
                     share_card: bool = False) -> "DeviceContext":
        """``dp`` data-parallel replicas of tp 1 on ``device``'s type (the
        card by default; raises without CUDA): one card a replica, or
        every replica on one card with ``share_card``."""
        return cls(cfg, resolve_device(device), dp=dp,
                   share_card=share_card)

    # ------------------------------------------------------------- geometry
    @property
    def shape(self) -> dict:
        if self.dp > 1:
            return {"data": self.dp, "model": self.tp}
        return {"model": self.tp}

    def rules(self) -> dict:
        return dict(self._rules)

    def sharded(self, axis: str) -> bool:
        """Whether the logical axis ``axis`` is cut across the ranks."""
        return self.tp > 1 and self._rules.get(axis) == "model"

    @property
    def local_kv_heads(self) -> int:
        """KV heads a rank holds in its pools: its shard where KV heads
        shard, all of them where attention stays whole on every rank."""
        return self.cfg.num_kv_heads // (self.tp if self.sharded("kv_heads")
                                         else 1)

    @property
    def local_ssm_heads(self) -> int:
        """Mamba2 heads a rank runs (and holds SSM state for)."""
        return self.cfg.ssm_heads // (self.tp if self.sharded("ssm_heads")
                                      else 1)

    @property
    def local_d_inner(self) -> int:
        """Mamba2 inner channels a rank holds (its x, z and gate-norm
        width; the conv adds the whole 2 * ssm_state B/C channels)."""
        return self.cfg.d_inner // (self.tp if self.sharded("ssm_inner")
                                    else 1)

    @property
    def local_experts(self) -> int:
        """MoE experts a rank holds: its contiguous share where the expert
        axis shards, all of them otherwise (routing is global either
        way)."""
        return self.cfg.num_experts // (self.tp if self.sharded("experts")
                                        else 1)

    # ------------------------------------------------------------ placement
    def place_params(self, tree: dict) -> dict:
        """This rank's slices of a full parameter tree, on this context's
        device: the same tensors at tp 1 when they are already there (DP
        replicas on one card share one weight tree)."""
        from repro_torch.models.params import _map, shard_params
        return _map(lambda _, t: t.to(self.device),
                    shard_params(tree, self.cfg, self.tp, self.rank))

    def split_replicas(self) -> List["DeviceContext"]:
        """One TP-1 context per data-parallel replica, on the devices
        ``launch.mesh.split_data_axis`` gave this context; ``dp`` == 1
        gives one context on this context's device."""
        return [DeviceContext(self.cfg, d) for d in self.replica_devices]

    # ---------------------------------------------------------- collective
    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ranks, in place, and return it; ``x``
        untouched at tp 1. Every rank gets the same bits."""
        if self.tp == 1:
            return x
        x = x.contiguous()
        torch.distributed.all_reduce(x, group=self.group)
        self.all_reduces += 1
        return x

    # ---------------------------------------------------------- diagnostics
    def describe(self) -> dict:
        """The reference's geometry keys, plus the collective backend and,
        for DP replicas, whether they share a card (``devices`` counts
        distinct devices)."""
        out = {"devices": self.tp, "axes": self.shape, "tp": self.tp,
               "dp": self.dp, "platform": self.device.type,
               "backend": self.backend}
        if self.dp > 1:
            out["devices"] = len(set(self.replica_devices))
            out["share_card"] = self.share_card
        return out

    def collectives_per_iteration(self) -> int:
        """The reference's predicted count of all-reduces in one forward
        pass: one per sharded attention out-projection and per sharded
        FFN / MoE down-projection, plus the vocab-sharded classifier; 0 at
        tp 1. (The port's vocab-parallel embedding adds one more.)"""
        if self.tp <= 1:
            return 0
        rules = self._rules
        n = 0
        for kind in self.cfg.block_pattern:
            if kind in GQA_KINDS or kind in MLA_KINDS:
                if rules["heads"]:
                    n += 1
                if kind in ("attn_moe", "mla_moe"):
                    if rules["experts"] or rules["moe_ffn"]:
                        n += 1
                elif rules["ffn"]:
                    n += 1
            elif kind == "mamba2":
                if rules["ssm_inner"] or rules["ssm_heads"]:
                    n += 1
            elif kind == "mlstm":
                if rules["mlstm_inner"]:
                    n += 1
        if rules["vocab"]:
            n += 1
        return n


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for (explicitly or by default) and
    none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (--device cpu) "
                "to run the port's plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_device(arr, device: torch.device,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Copy host data (numpy array or scalar list) to ``device``. On CUDA
    the copy stages through pinned memory and does not wait for the
    device, so it adds no host sync; the host array may be reused at once
    (the staging buffer is a copy)."""
    t = torch.from_numpy(np.array(arr, copy=True))
    if dtype is not None:
        t = t.to(dtype)
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def fetch_to_host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Bring every tensor to host numpy with ONE blocking sync: the copies
    are enqueued into pinned buffers and the stream is synchronised once.
    bf16 values come back as float32 (numpy has no bf16)."""
    tensors = [t.float() if t.dtype == torch.bfloat16 else t
               for t in tensors]
    if not tensors:
        return []
    dev = tensors[0].device
    if dev.type == "cpu":
        return [t.detach().clone().numpy() for t in tensors]
    outs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for o, t in zip(outs, tensors):
        o.copy_(t, non_blocking=True)
    torch.cuda.current_stream(dev).synchronize()
    return [o.numpy() for o in outs]
