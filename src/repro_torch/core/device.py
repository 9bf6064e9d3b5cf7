"""Device placement for the port: the device an entry point runs on, the
host <-> device copies of the engines, and the tensor-parallel context.

* :class:`DeviceContext` — the counterpart of the reference's
  ``repro.core.device.DeviceContext`` over ``torch.distributed`` instead
  of a jax ``Mesh``: the TP degree and this process's rank, the process
  group and its backend, the per-arch axis rules, the rank's slice of the
  weights and its KV heads, and the collectives the model makes
  (:meth:`DeviceContext.reduce_from_model` and its backward twin). One
  process runs one rank (SPMD): every rank runs the same engine on the
  same requests with its own slices of the weights and page pools, and
  the all-reduces leave the residual stream and the logits identical on
  every rank, so every rank samples the same tokens. Tables, lengths and positions stay
  rank-global, as the reference replicates them. Single-device serving is
  ``DeviceContext.single`` (tp 1, no group: the collectives are the
  identity). The DP half (``dp``, :meth:`DeviceContext.split_replicas`)
  describes data-parallel replicas served by the reference's
  single-controller router, which each rank runs: ``split_replicas``
  gives each replica a context on its own device
  (``launch.mesh.split_data_axis``: card ``i * tp + rank`` for replica
  *i* when there are ``dp * tp`` cards, card 0 for every replica only
  with ``share_card``, or the CPU), of tp 1, or, under TP, of the same
  rank and tp over a process group of its own.

  The collectives are Megatron's pair, visible to autograd, so the
  training forward's gradients cross the ranks too:
  :meth:`DeviceContext.reduce_from_model` (forward all-reduce, backward
  identity) ends a sharded region and :meth:`DeviceContext.copy_to_model`
  (forward identity, backward all-reduce) enters one: each sharded block
  passes its replicated input through it, and each whole leaf it reads
  (the MoE router, MLA's latent projection, its norm and the rope key,
  Mamba2's B/C projections and conv, GQA's q/k norms), whose gradient on
  a rank is then that rank's share.

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

  Context-parallel decode (``seq`` > 1): the rank holds a contiguous
  span of every GQA cache's and MLA latent cache's sequence, as the
  reference's ``cache_pspecs`` places it (a GQA sequence cut over
  ``model`` where the KV heads do not divide it, MLA's always, and over
  the data axes at batch 1), and is rank
  ``seq_rank`` of a sequence group of ``seq`` ranks (``seq_group``: the
  model group, the data group or the world, ``launch.mesh.seq_group``).
  Each rank attends over its span and :meth:`DeviceContext.combine_partials`
  gathers the ranks' ``(out, lse)`` partials in one collective and
  combines them in rank order, so every rank of the group gets the same
  bits of the softmax over the whole sequence (:meth:`seq_span` gives the
  span). An MLA layer, whose heads are cut over ``model`` too, first
  gathers its heads' queries over the model group
  (:meth:`gather_heads`), so each rank attends with every head over its
  span. Only the slab decode step runs on that layout; the paged engines
  and TP serving keep the whole sequence, as the reference's engines do.

* :func:`resolve_device` — ``None`` means the card. Without CUDA that is an
  error, never a quiet move to the CPU; the CPU runs only when asked for.
* :func:`to_device` — host numpy to the device without a host sync (pinned
  staging buffer + ``non_blocking``), so the async engine can upload
  dispatch inputs while the previous program still runs.
* :func:`fetch_to_host` — every tensor of one iteration copied back with a
  single blocking synchronisation (the port's ``jax.device_get``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

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
                 share_card: bool = False, seq: int = 1, seq_rank: int = 0,
                 seq_group=None):
        # the models package imports this module
        from repro_torch.models.params import axis_rules
        if tp < 1 or not 0 <= rank < tp:
            raise ValueError(f"DeviceContext: rank {rank} of tp {tp}")
        if dp < 1:
            raise ValueError(f"DeviceContext: dp must be >= 1, got {dp}")
        if seq < 1 or not 0 <= seq_rank < seq:
            raise ValueError(f"DeviceContext: sequence rank {seq_rank} of "
                             f"{seq}")
        self.cfg = cfg
        self.tp = tp
        self.dp = dp
        self.share_card = share_card
        self.rank = rank
        self.group = group
        self.backend = backend
        # the sequence group of context-parallel decode (size 1: none)
        self.seq = seq
        self.seq_rank = seq_rank
        self.seq_group = seq_group
        # one device a replica, validated here (raises for more replicas
        # than cards without share_card); the context's own device is
        # replica 0's
        self.replica_devices = (torch.device(device),)
        if dp > 1:
            from repro_torch.launch.mesh import split_data_axis
            self.replica_devices = split_data_axis(device, dp, share_card,
                                                   tp=tp, rank=rank)
        self.device = self.replica_devices[0]
        self._rules = axis_rules(cfg, tp)
        self._replicas = None
        # forward all-reduces made since construction (the model's
        # collectives; a block recomputed under remat counts again), and
        # the backward all-reduces of copy_to_model
        self.all_reduces = 0
        self.grad_all_reduces = 0
        # context-parallel decode's all-gathers: one a GQA layer (the
        # combine), two an MLA layer (its query gather and the combine)
        self.seq_gathers = 0

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

    def seq_span(self, length: int) -> Tuple[int, int]:
        """(first key, keys) of this rank's contiguous span of a cache
        sequence of ``length`` keys (the whole of it at ``seq`` 1). Raises
        where the span does not divide the sequence (it is not
        rounded)."""
        if length % self.seq:
            raise ValueError(f"a sequence of {length} keys does not split "
                             f"into {self.seq} equal spans")
        n = length // self.seq
        return self.seq_rank * n, n

    # ------------------------------------------------------------ placement
    def place_params(self, tree: dict) -> dict:
        """This rank's slices of a full parameter tree, on this context's
        device: the same tensors at tp 1 when they are already there (DP
        replicas on one card share one weight tree)."""
        from repro_torch.models.params import _map, shard_params
        return _map(lambda _, t: t.to(self.device),
                    shard_params(tree, self.cfg, self.tp, self.rank))

    def split_replicas(self) -> List["DeviceContext"]:
        """One context per data-parallel replica, on the devices
        ``launch.mesh.split_data_axis`` gave this context; ``dp`` == 1
        gives one context on this context's device. At tp 1 each is a
        TP-1 context. Under TP each has this rank and tp, and a process
        group of its own over this context's ranks, made by
        ``torch.distributed.new_group`` once a replica, in replica order,
        on the first call (every rank of the default group must make it,
        in the same order); later calls return the same contexts."""
        if self._replicas is not None:
            return self._replicas
        if self.tp == 1:
            self._replicas = [DeviceContext(self.cfg, d)
                              for d in self.replica_devices]
            return self._replicas
        dist = torch.distributed
        ranks = (dist.get_process_group_ranks(self.group)
                 if self.group is not None
                 else list(range(dist.get_world_size())))
        self._replicas = [
            DeviceContext(self.cfg, d, tp=self.tp, rank=self.rank,
                          group=dist.new_group(ranks), backend=self.backend)
            for d in self.replica_devices]
        return self._replicas

    # --------------------------------------------------------- collectives
    def reduce_from_model(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ranks and return it (Megatron's "g"): the
        end of a sharded region, whose output is each rank's partial sum.
        Its backward is the identity: the gradient of the sum reaches
        every rank's part whole. ``x`` untouched at tp 1. Every rank gets
        the same bits. Without autograd (serving) the sum is in place."""
        if self.tp == 1:
            return x
        self.all_reduces += 1
        if torch.is_grad_enabled() and x.requires_grad:
            return _ReduceFromModel.apply(x, self.group)
        x = x.contiguous()
        torch.distributed.all_reduce(x, group=self.group)
        return x

    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` itself (Megatron's "f"): the entry of a sharded region,
        for a tensor every rank holds whole (a block's input, a whole
        weight). Its backward sums the ranks' gradients, each rank's share
        of the whole gradient. The identity at tp 1 and without
        autograd."""
        if self.tp == 1 or not (torch.is_grad_enabled()
                                and x.requires_grad):
            return x
        return _CopyToModel.apply(x, self)

    def combine_partials(self, out: torch.Tensor,
                         lse: torch.Tensor) -> torch.Tensor:
        """The softmax attention over the union of the sequence group's
        spans from each rank's partial over its own: ``out`` (..., Dh) its
        normalised output and ``lse`` (...) its fp32 natural-log
        log-sum-exp (-inf where it saw no key). One
        ``all_gather_into_tensor`` of the packed fp32 (..., Dh + 1), then
        the log-sum-exp combine in rank order
        (``kernels.ops.lse_combine``, weights exp(lse_r - max lse)), the
        same bits on every rank. Returns fp32 (..., Dh); ``out`` as it is
        at ``seq`` 1."""
        if self.seq == 1:
            return out
        from repro_torch.kernels.ops import lse_combine
        packed = torch.cat([out.float(), lse.float()[..., None]],
                           dim=-1).contiguous()
        # the ranks' partials concatenated on dim 0 (gloo's layout)
        gathered = packed.new_empty((self.seq * packed.shape[0],)
                                    + tuple(packed.shape[1:]))
        torch.distributed.all_gather_into_tensor(gathered, packed,
                                                 group=self.seq_group)
        gathered = gathered.view((self.seq,) + tuple(packed.shape))
        self.seq_gathers += 1
        m = gathered[..., -1]
        return lse_combine(m, torch.ones_like(m), gathered[..., :-1], dim=0)

    def gather_heads(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every model rank's ``x`` (its share of the heads on ``dim``)
        concatenated on ``dim`` in model-rank order: the whole heads, the
        same on every rank of the model group. One
        ``all_gather_into_tensor`` over the model group (counted in
        ``seq_gathers``); ``x`` itself where the heads are whole on every
        rank (tp 1, or heads that do not divide it). Context-parallel MLA
        decode's query gather; no autograd."""
        if not self.sharded("heads"):
            return x
        x = x.contiguous()
        # the ranks' shares concatenated on dim 0 (gloo's layout)
        out = x.new_empty((self.tp * x.shape[0],) + tuple(x.shape[1:]))
        torch.distributed.all_gather_into_tensor(out, x, group=self.group)
        self.seq_gathers += 1
        out = out.view((self.tp,) + tuple(x.shape))
        return torch.movedim(out, 0, dim).flatten(dim, dim + 1)

    def copy_leaves(self, params, keys) -> "_Leaves":
        """``params`` (a weight mapping) with its leaves at ``keys`` (those
        present) through :meth:`copy_to_model`: the whole weights a
        sharded block reads."""
        return _Leaves(params, {k: self.copy_to_model(params[k])
                                for k in keys if k in params})

    # ---------------------------------------------------------- diagnostics
    def describe(self) -> dict:
        """The reference's geometry keys, plus the collective backend and,
        for DP replicas, whether they share a card (``devices`` is then
        the ranks a replica times the distinct replica devices)."""
        out = {"devices": self.tp, "axes": self.shape, "tp": self.tp,
               "dp": self.dp, "platform": self.device.type,
               "backend": self.backend}
        if self.dp > 1:
            out["devices"] = self.tp * len(set(self.replica_devices))
            out["share_card"] = self.share_card
        return out

    def collectives_per_iteration(self) -> int:
        """The reference's predicted count of all-reduces in one forward
        pass: one per sharded attention out-projection and per sharded
        FFN / MoE down-projection, plus the vocab-sharded classifier; 0 at
        tp 1. (The port's vocab-parallel embedding adds one more.) The
        all-gathers of context-parallel decode are not all-reduces and are
        not counted here (``seq_gathers``)."""
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


class _Leaves:
    """A weight mapping read through, with some leaves replaced."""

    def __init__(self, base, over: dict):
        self._base, self._over = base, over

    def __getitem__(self, key):
        return self._over[key] if key in self._over else self._base[key]

    def __contains__(self, key) -> bool:
        return key in self._over or key in self._base


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward, identity backward."""

    @staticmethod
    def forward(fctx, x, group):
        out = x.contiguous().clone()
        torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(fctx, grad):
        return grad, None


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce backward."""

    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return x.view_as(x)

    @staticmethod
    def backward(fctx, grad):
        ctx = fctx.ctx
        # a copy: autograd may hand the same gradient to other inputs
        grad = grad.contiguous().clone()
        torch.distributed.all_reduce(grad, group=ctx.group)
        ctx.grad_all_reduces += 1
        return grad, None


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
