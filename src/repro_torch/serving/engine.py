"""DuetServe engine on one device: continuous batching with chunked prefill,
adaptive duet multiplexing, paged-KV execution, and interruption-free
look-ahead decode (k-step programs, §4.3).

Execution vs time accounting: the engine *computes real tokens* with the
PyTorch model on its device (the CUDA card, or the CPU when asked for).
The engine clock advances by the attention-aware roofline prediction, not
wall time, and the multiplexer plans with the same roofline. What it
prices (``hw=None``, the default) is the device it runs on:

* on a CUDA card, the card (``roofline.card_spec``): its TPCs are the
  partition units, Algorithm 1 splits a replica's TPCs (``units`` cards,
  or ``tp`` ranks, of 66 TPCs on the H100) between prefill and decode,
  Pi(S) is the datasheet's bf16 peak linear in SMs and B(S) the curve the
  card measures over SM counts (``core.device.partition_curves``). So
  TTFT/TBT/throughput in ``ServingMetrics`` are the card's roofline
  predictions (held to its measured step times by ``chip_smoke.py``'s
  roofline phase), not measurements of the card;
* on the CPU, a TPU v5e (``TPU_V5E``, as in the JAX reference), so the
  virtual clock equals the reference's on the same trace.

An explicit ``hw`` is taken as given (``device_pricing`` gives the default).

KV memory (``EngineConfig.paged``):

* paged (default) — attention KV lives in per-layer device page pools
  (PagedAttention layout) addressed through per-request block tables;
  admission is page-granular against the live
  :class:`PagedKVCacheManager`, look-ahead decode preallocates pages for
  all k steps, and under pool pressure the engine first shrinks k, then
  preempts a victim (free its pages, requeue for recompute-from-prompt).
* slab (``paged=False``) — one contiguous (max_len) KV row per slot, the
  reference's equivalence oracle for the paged path. The page manager
  still does the accounting (admission, reservation, preemption) over a
  pool sized max_slots rows; the model reads and writes the slab rows in
  place. No prefix cache.

Tensor parallelism: the engine runs the model's device context
(``Model.ctx``; one device by default). Under TP every rank runs this
engine, with the same host scheduler, on the same requests: its pools hold
the rank's KV heads, the host state (tables, positions, page manager) is
rank-global, and the model's all-reduces leave every rank the same logits,
so every rank plans and samples alike. Data parallelism runs one engine
per replica behind ``serving.router.Router``, which moves requests off a
scaled-down replica with :meth:`DuetEngine.drain_requests`.
"""
from __future__ import annotations

import copy
import math
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import (DeviceContext, DeviceLike,
                                     card_unit_step, partition_curves,
                                     resolve_device, to_device)
from repro_torch.core.lookahead import (make_lookahead_fn,
                                        make_paged_lookahead_fn)
from repro_torch.core.multiplexer import (AdaptiveMultiplexer,
                                          TabulatedPartitionCurves)
from repro_torch.core.roofline import (HardwareSpec, RooflineModel, TPU_V5E,
                                       card_spec)
from repro_torch.models.attention import slot_views
from repro_torch.models.transformer import Model, reset_slot_state
from repro_torch.serving.kvcache import (DEFAULT_PAGE_SIZE, HostPoolConfig,
                                         PagedKVCacheManager, PagePoolConfig,
                                         copy_pool_pages, init_page_pools)
from repro_torch.serving.request import (Phase, Request, ServingMetrics,
                                         synth_prompt_tokens)
from repro_torch.serving.scheduler import (DuetPolicy, IterationPlan,
                                           QueueState)

K_BUCKETS = (1, 2, 4, 8, 16, 32)


def _k_bucket(k: int) -> int:
    for b in reversed(K_BUCKETS):
        if k >= b:
            return b
    return 1


@dataclass
class EngineConfig:
    max_slots: int = 8           # concurrent requests resident on the device
    max_len: int = 2048          # sizes the default pool (max_slots*max_len)
    token_budget: int = 512
    tbt_slo: float = 0.1
    units: int = 1               # devices (chips, cards) in this replica
    tp: int = 1
    page_size: int = DEFAULT_PAGE_SIZE
    temperature: float = 0.0
    sched_overhead: float = 0.0005
    dispatch_overhead: float = 0.004
    # paged-KV execution; paged=False serves from the slab cache (the
    # equivalence oracle). ``kv_pool_tokens`` sizes the device page pools;
    # None = max_slots * max_len.
    paged: bool = True
    kv_pool_tokens: Optional[int] = None
    # copy-on-write prefix caching over the paged pool (paged mode only):
    # requests sharing a prompt prefix map the cached pages read-only and
    # prefill only the uncached suffix.
    prefix_cache: bool = True
    # host-DRAM demotion tier: cold cached pages demote to a numpy page
    # store of ``host_kv_tokens`` capacity instead of being evicted, and
    # promote back on a prefix hit. ``kv_quant``: "none" = fp32, "int8" =
    # symmetric per-tensor quantization. 0 disables the tier.
    host_kv_tokens: int = 0
    kv_quant: str = "none"
    # kernel path (Model.attn_kernel engines): ``DuetEngine.kernel_path``
    # reports "cuda" when the CUDA kernels launch, "cuda_sharded" when the
    # paged decode launches them on each TP rank's KV-head shard, and
    # "torch" on the CPU (the kernels' plain versions).
    # ``split_kv_threshold`` (paged only): table capacity in tokens above
    # which decode uses the split-KV kernel — None prices the threshold
    # from the roofline, 0 disables splitting. ``strict_kernel`` makes a
    # kernel request on a Model without attn_kernel an error.
    split_kv_threshold: Optional[int] = None
    strict_kernel: bool = False

    KERNEL_PATHS = ("torch", "cuda", "cuda_sharded")


def device_pricing(device: torch.device,
                   ctx: Optional[DeviceContext] = None,
                   split: bool = False) -> HardwareSpec:
    """What an engine on ``device`` prices when it is given no ``hw``: on a
    CUDA card the card, ``card_spec``'s TPCs with Pi(S) linear in SMs and
    B(S) the card's measured curve (``partition_curves``; under TP the
    model group's first rank measures and every rank takes its curve, so
    every rank plans alike), as a ``TabulatedPartitionCurves`` that grows
    linearly past one card; on the CPU a TPU v5e, as the reference. The
    serve CLI prices its ``--rho`` load with it.

    ``split`` is for an engine that runs the SM split (one card): B(S)
    measured on the split's green contexts, and ``unit_step`` the TPCs
    between the SM groups the driver cuts (``card_unit_step``), so that
    Algorithm 1 picks only splits the card can make. Without it no green
    context is made and Algorithm 1 steps by one TPC."""
    if device.type != "cuda":
        return TPU_V5E
    spec = card_spec(torch.cuda.get_device_properties(device),
                     unit_step=card_unit_step(device) if split else 1)

    def measure():
        return partition_curves(device, spec, split).values()
    curve = measure() if ctx is None else \
        ctx.from_first_rank(measure, spec.num_units)
    bw = dict(enumerate(curve, start=1))
    return TabulatedPartitionCurves(spec, {u: spec.pi(u) for u in bw}, bw)


class DuetEngine:
    def __init__(self, model: Model, engine_cfg: EngineConfig,
                 hw: Optional[HardwareSpec] = None, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model weights live on {model.device}, the "
                             f"engine was asked for {self.device}")
        # the device context is the model's: its weights are the rank's
        # slices
        self.ctx: DeviceContext = model.ctx
        if engine_cfg.tp not in (1, self.ctx.tp) and self.ctx.tp != 1:
            raise ValueError(
                f"EngineConfig.tp={engine_cfg.tp} contradicts the device "
                f"context's model axis ({self.ctx.tp}); pass one geometry")
        # tp for planning: the executed context wins; EngineConfig.tp stays
        # the modelling-only knob of single-device what-if runs
        self._tp = self.ctx.tp if self.ctx.tp > 1 else engine_cfg.tp
        self.cfg: ArchConfig = model.cfg
        self.ec = engine_cfg
        if hw is None:
            hw = device_pricing(self.device, self.ctx)
        self.hw = hw
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.paged = engine_cfg.paged

        # capability probe: pin the executed attention path on a per-engine
        # Model copy (other engines may share the Model; the copy shares the
        # weights). ``kernel_path`` reports it.
        model = copy.copy(model)
        self.kernel_path = "torch"
        if model.attn_kernel:
            if self.device.type == "cuda":
                # under TP each rank's kernels run on its local tensors:
                # "cuda_sharded" where the paged decode reads the rank's
                # KV-head shard of the pools (tables stay rank-global),
                # "cuda" for the slab and for KV heads every rank holds
                sharded = self.ctx.tp > 1 and self.paged \
                    and self.ctx.sharded("kv_heads")
                self.kernel_path = "cuda_sharded" if sharded else "cuda"
            if self.paged:   # a paged-decode kernel
                thr = engine_cfg.split_kv_threshold
                if thr is None:  # roofline-priced default; 0 disables
                    thr = RooflineModel(
                        self.cfg, hw, tp=self._tp,
                        page_size=engine_cfg.page_size).split_kv_threshold()
                model.split_kv_threshold = int(thr)
        elif engine_cfg.strict_kernel:
            raise ValueError(
                "strict_kernel requires a Model built with attn_kernel=True")
        assert self.kernel_path in EngineConfig.KERNEL_PATHS
        self.model = model

        # prefix caching skips the matched prefix's prefill entirely, which
        # is only sound when every layer's sequence state lives in the paged
        # KV pool.
        self.prefix_cache = self.paged and engine_cfg.prefix_cache
        if self.prefix_cache and not self.cfg.attention_only:
            warnings.warn(
                f"prefix_cache disabled for {self.cfg.name}: block pattern "
                "contains recurrent layers whose per-slot state must "
                "process every prompt token")
            self.prefix_cache = False

        ps = engine_cfg.page_size
        if self.paged:
            pool_tokens = engine_cfg.kv_pool_tokens \
                or engine_cfg.max_slots * engine_cfg.max_len
            num_pages = -(-pool_tokens // ps) + 1   # +1: reserved null page
            host_pool = None
            if engine_cfg.host_kv_tokens > 0 and self.prefix_cache:
                host_pool = HostPoolConfig(
                    num_pages=-(-engine_cfg.host_kv_tokens // ps),
                    quant=engine_cfg.kv_quant)
            self.kv_mgr = PagedKVCacheManager(
                PagePoolConfig(num_pages=num_pages, page_size=ps),
                prefix_cache=self.prefix_cache, host_pool=host_pool)
            # block-table width: one request may span the whole pool
            self.max_pages = num_pages - 1
            # pools hold the model's dtype, so the kernels read them as
            # they are
            self.pools = init_page_pools(self.cfg, self.kv_mgr.pool,
                                         dtype=model.dtype,
                                         device=self.device,
                                         kv_heads=self.ctx.local_kv_heads)
            self.cache = model.init_state_cache(engine_cfg.max_slots)
        else:
            # the page manager only accounts: one max_len row per slot
            pool_pages = engine_cfg.max_slots * (
                -(-engine_cfg.max_len // ps)) + 1
            self.kv_mgr = PagedKVCacheManager(
                PagePoolConfig(num_pages=pool_pages, page_size=ps))
            self.max_pages = -(-engine_cfg.max_len // ps)
            self.pools = None
            self.cache = model.init_cache(engine_cfg.max_slots,
                                          engine_cfg.max_len)
        # the multiplexer plans with the geometry the ranks execute: the
        # context sets the communication term's TP degree, and a TP replica
        # spans tp devices, each of hw.units_per_device units (a card's
        # TPCs; one TPU chip, partitioned below at grid granularity)
        units = max(engine_cfg.units, self._tp) * hw.units_per_device
        self.mux = AdaptiveMultiplexer(
            self.cfg, hw=hw, total_units=units,
            tbt_slo=engine_cfg.tbt_slo, tp=self._tp,
            unit_step=getattr(hw, "unit_step", 1),
            page_size=ps if self.paged else 1,
            mesh=self.ctx if self.ctx.tp > 1 else None)
        self.policy = DuetPolicy(self.mux,
                                 token_budget=engine_cfg.token_budget,
                                 max_batch=engine_cfg.max_slots,
                                 kv_mgr=self.kv_mgr,
                                 reserve_on_admit=False)
        self.state = QueueState()
        self.now = 0.0
        self.free_slots = list(range(engine_cfg.max_slots))
        self.slot_pos = np.zeros(engine_cfg.max_slots, np.int32)
        self.slot_last_token = np.zeros(engine_cfg.max_slots, np.int32)
        self.finished: List[Request] = []
        # submission queue + epoch bookkeeping: ``submit`` accumulates, the
        # serving loop consumes, and ``run`` reports metrics over the
        # requests ingested since the previous ``run``
        self._pending: List[Request] = []
        self._all: List[Request] = []
        self._epoch = 0
        self._epoch_now = 0.0
        self._decode_fns: Dict[int, callable] = {}

    # ------------------------------------------------------------- plumbing
    def _h2d(self, arr, dtype=None) -> torch.Tensor:
        return to_device(arr, self.device, dtype)

    def _decode_fn(self, k: int):
        if k not in self._decode_fns:
            make = make_paged_lookahead_fn if self.paged \
                else make_lookahead_fn
            self._decode_fns[k] = make(self.model, k,
                                       temperature=self.ec.temperature)
        return self._decode_fns[k]

    def _table_width(self, rids: List[int]) -> int:
        """Per-dispatch block-table width: the smallest power-of-two bucket
        covering the widest table in the batch. Keeps the plain gather path
        O(context) instead of O(pool); ``max_pages`` stays the admission
        bound only."""
        n = max((len(self.kv_mgr.page_table(rid)) for rid in rids),
                default=1)
        return 1 << (max(1, n) - 1).bit_length()

    # ------------------------------------------------------------ lifecycle
    def _materialize_prompt(self, r: Request):
        """Deterministic rid-derived prompt tokens for trace requests that
        carry lengths only (shared with the async engine)."""
        if r.prompt_tokens is None:
            r.prompt_tokens = synth_prompt_tokens(
                r.rid, self.cfg.vocab_size, r.prompt_len)

    def submit(self, requests: Union[Request, Sequence[Request]],
               at: Optional[float] = None):
        """Enqueue requests for serving. Calls accumulate; ``at`` overrides
        every submitted request's arrival time (pass ``engine.now`` for
        "now")."""
        if isinstance(requests, Request):
            requests = [requests]
        reqs = list(requests)
        for r in reqs:
            self._materialize_prompt(r)
            if at is not None:
                r.arrival = at
        self._pending.extend(reqs)
        self._pending.sort(key=lambda r: r.arrival)
        self._all.extend(reqs)

    # --------------------------------------------------- admission / eviction
    def _admit_waiting(self) -> List[Request]:
        """Slot admission, FCFS. A request whose footprint can never fit is
        rejected with a recorded outcome — never silently dropped. Newly
        slotted requests take a prefix-cache lock. Returns the rejected
        requests (the async engine emits events)."""
        rejected = []
        for r in list(self.state.waiting):
            if not self._admissible(r):
                self.state.waiting.remove(r)
                self._reject(r, "kv_footprint_exceeds_capacity")
                rejected.append(r)
            elif r.slot is None and self.free_slots:
                r.slot = self.free_slots.pop()
                self._try_prefix_lock(r)
        return rejected

    def _try_prefix_lock(self, r: Request):
        """Start ``r`` at its longest cached prefix: matched pages map
        read-only into its block table and ``prefilled`` jumps to the
        matched length, so only the uncached suffix is scheduled."""
        if not self.prefix_cache:
            return
        if r.prefilled or self.kv_mgr.page_table(r.rid):
            return
        matched = self.kv_mgr.lock_prefix(r.rid, r.prefill_token_ids())
        if matched:
            r.prefilled = matched
            r.cached_prompt += matched

    def _admissible(self, r: Request) -> bool:
        """Can this request's full KV footprint ever fit the engine?"""
        if self.paged:
            need = -(-(r.prompt_len + r.output_len) // self.ec.page_size)
            return need <= self.max_pages
        return r.prompt_len + r.output_len <= self.ec.max_len

    def _reject(self, r: Request, why: str):
        if r.slot is not None:
            self.free_slots.append(r.slot)
            r.slot = None
        self.kv_mgr.free(r.rid)
        r.phase = Phase.REJECTED
        r.finish_reason = f"rejected:{why}"
        self.finished.append(r)

    def _preempt(self, r: Request):
        """Victim eviction: free the request's pages and requeue it at the
        head of the waiting queue for recompute-from-prompt (the prefill
        replays prompt + already-sampled outputs; greedy decode regenerates
        the identical suffix)."""
        self.kv_mgr.free(r.rid)
        if r.generated:
            r.resume_len = r.prompt_len + r.generated - 1
        r.prefilled = 0
        r.preemptions += 1
        r.phase = Phase.WAITING
        if r in self.state.running:
            self.state.running.remove(r)
        if r in self.state.prefilling:
            self.state.prefilling.remove(r)
        if r.slot is not None:
            self.free_slots.append(r.slot)
            r.slot = None
        self.state.waiting.insert(0, r)

    def drain_requests(self):
        """Evict every live request for re-dispatch elsewhere (elastic
        scale-down): running/prefilling requests go through the
        recompute-from-prompt preemption path (greedy decode regenerates
        the identical suffix on the new replica), queued and pending ones
        are withdrawn as-is. Drained requests leave this engine's
        accounting entirely — the router re-submits them, so they must
        count exactly once in the merged metrics.

        Returns:
            ``(requests, events)`` — the drained requests sorted by
            ``(arrival, rid)``, plus any serving events flushed on the way
            (always ``[]`` for the synchronous engine; the async override
            retires its in-flight super-iteration first).
        """
        for r in list(self.state.running) + list(self.state.prefilling):
            self._preempt(r)
        drained = []
        for r in list(self.state.waiting):
            # waiting slot-holders may hold a prefix lock from admission
            if r.slot is not None:
                self.free_slots.append(r.slot)
                r.slot = None
            self.kv_mgr.free(r.rid)
            r.prefilled = 0
            drained.append(r)
        self.state.waiting.clear()
        drained.extend(self._pending)
        self._pending.clear()
        gone = {id(r) for r in drained}
        self._all = [r for r in self._all if id(r) not in gone]
        drained.sort(key=lambda r: (r.arrival, r.rid))
        return drained, []

    def _ensure_pages(self, r: Request, new_tokens: int) -> bool:
        """Make room for a prefill chunk (including a potential CoW copy of
        a shared first page). Only other in-flight prefills are evicted
        (latest arrival first); decode requests are never sacrificed for
        prefill progress. If that is not enough the chunk is deferred."""
        def fits() -> bool:
            need = self.kv_mgr.pages_needed(r.rid, new_tokens) \
                + self.kv_mgr.cow_pages_needed(r.rid, r.prefilled)
            return need <= self.kv_mgr.free_pages

        if fits():
            return True
        pre = sorted((x for x in self.state.prefilling
                      if x is not r and self.kv_mgr.page_table(x.rid)),
                     key=lambda x: x.arrival, reverse=True)
        for victim in pre:
            self._preempt(victim)
            if fits():
                return True
        return False

    # ----------------------------------------------------- tier migrations
    def _service_tiers(self):
        """Move queued page migrations: capture demoted pages' pool content
        for the host store, then scatter promoted host blocks into their
        fresh pages. Demotions are captured *first* — a promotion may
        target the very page id whose old content is still queued. The
        captures are clones: the pools are updated in place, so a view of
        the page would see a later write."""
        for page, key in self.kv_mgr.drain_demotions():
            self._capture_demotion(key, [
                None if p is None else (p[0][page].clone(),
                                        p[1][page].clone())
                for p in self.pools])
        promos = self.kv_mgr.drain_promotions()
        if promos:
            idx = self._h2d(np.asarray([page for page, _, _ in promos]),
                            torch.long)
            for li, p in enumerate(self.pools):
                if p is None:
                    continue
                for j, pages in enumerate(p):
                    new = self._h2d(np.stack([pl[li][j]
                                              for _, _, pl in promos]),
                                    pages.dtype)
                    pages.index_copy_(0, idx, new)

    def _capture_demotion(self, key: bytes, slices: List):
        """Read one demoted page's per-layer device slices to host and
        complete the migration. Synchronous engine: immediate blocking
        reads. The async engine batches them into its one fetch."""
        self.kv_mgr.complete_demotion(key, [
            None if s is None else (s[0].float().cpu().numpy(),
                                    s[1].float().cpu().numpy())
            for s in slices])

    def _cow_copy(self, copies):
        """Apply CoW page copies, servicing the migration queues first —
        the CoW destination may be the very page a pending demotion still
        needs to capture."""
        if copies:
            self._service_tiers()
            copy_pool_pages(self.pools, copies)

    # ------------------------------------------------------------ execution
    def _exec_prefill_chunk(self, r: Request, chunk: int) -> str:
        """Run one prefill chunk. Returns "continue" (more prompt left),
        "first" (prompt done, first token sampled), "resumed" (prompt done,
        resuming after preemption), or "deferred" (no pages and nothing to
        preempt)."""
        if not self._ensure_pages(r, chunk):
            return "deferred"
        if self.paged:
            # the chunk's first write may land in a shared/cached page
            # (fully page-aligned prefix hit): privatise it first
            self._cow_copy(self.kv_mgr.ensure_writable(r.rid, r.prefilled))
        self.kv_mgr.allocate(r.rid, chunk)
        toks = self._h2d(
            r.prefill_token_ids()[r.prefilled:r.prefilled + chunk][None, :])
        self._reset_if_new(r)
        if self.paged:
            # flush tier migrations before the program touches the pools
            self._service_tiers()
            tbl = self._h2d(self.kv_mgr.padded_tables(
                [r.rid], self._table_width([r.rid])))
            logits, self.pools, _ = self.model.prefill_paged(
                toks, self.pools, slot_views(self.cache, r.slot), tbl,
                start_pos=r.prefilled)
        else:
            logits, _ = self.model.prefill(
                toks, cache=slot_views(self.cache, r.slot),
                start_pos=r.prefilled)
        r.prefilled += chunk
        r.prefill_executed += chunk
        if r.remaining_prompt > 0:
            return "continue"
        if self.prefix_cache:
            self.kv_mgr.insert_prefix(r.rid, r.prefill_token_ids())
        self.slot_pos[r.slot] = r.prefill_total
        if r.resume_len:
            self.slot_last_token[r.slot] = r.output_tokens[-1]
            return "resumed"
        # the synchronous oracle reads the first token at once
        tok = int(torch.argmax(logits[0]).cpu())
        self.slot_last_token[r.slot] = tok
        r.output_tokens.append(tok)
        return "first"

    def _reset_if_new(self, r: Request):
        """A chunk at position 0 (a new occupant of the slot, or a
        re-prefill after preemption) starts from the initial recurrent
        state, not from what the slot's last occupant left (the
        reference's engines keep it). A device write, no read."""
        if r.prefilled == 0:
            reset_slot_state(self.cache, r.slot)

    def _reserve_for(self, reqs: List[Request], kb: int) -> int:
        """Shrink kb down the bucket ladder until the look-ahead reservation
        covers every request; 0 when even k=1 does not fit. The reservation
        also budgets the CoW copies the decode append may trigger."""
        cow = sum(self.kv_mgr.cow_pages_needed(r.rid,
                                               self.kv_mgr.length(r.rid))
                  for r in reqs)
        while kb >= 1:
            if self.kv_mgr.reserve_lookahead([r.rid for r in reqs], kb,
                                             headroom=cow):
                return kb
            kb = _k_bucket(kb - 1) if kb > 1 else 0
        return 0

    def _plan_decode_batch(self, decode_reqs: List[Request],
                           k: int) -> Tuple[int, List[Request]]:
        """Host-side half of §4.3 decode planning: reserve look-ahead pages
        for k steps, shrinking k down the bucket ladder and preempting
        victims under pool pressure. Returns the bucketed depth and the
        surviving batch — pure bookkeeping, no device work."""
        reqs = list(decode_reqs)
        kb = 0
        while reqs:
            want = min(_k_bucket(k),
                       min(r.output_len - r.generated for r in reqs))
            want = _k_bucket(max(1, want))
            kb = self._reserve_for(reqs, want)
            if kb:
                break
            # decode-first priority: evict page-holding prefills before
            # sacrificing a decode request
            pre = [x for x in self.state.prefilling
                   if self.kv_mgr.page_table(x.rid)]
            if pre:
                self._preempt(max(pre, key=lambda r: r.arrival))
                continue
            victim = max(reqs, key=lambda r: r.arrival)
            reqs.remove(victim)
            self._preempt(victim)
        return kb, reqs

    def _privatize_decode_pages(self, reqs: List[Request]):
        """CoW guard for the decode append: only the page holding the next
        write position can be shared (look-ahead pages are fresh)."""
        if not self.paged:
            return
        for r in reqs:
            self._cow_copy(
                self.kv_mgr.ensure_writable(r.rid,
                                            self.kv_mgr.length(r.rid)))

    def _decode_args(self, dec_reqs: List[Request], kb: int):
        """Decode-dispatch inputs (active mask, block tables, width bucket)
        for the current batch, as host arrays. Must be called while every
        batch member still owns its pages."""
        B = self.ec.max_slots
        active = np.zeros(B, bool)
        for r in dec_reqs:
            active[r.slot] = True
        if self.paged and kb > 0 and dec_reqs:
            width = self._table_width([r.rid for r in dec_reqs])
            tbl = np.zeros((B, width), np.int32)
            rows = self.kv_mgr.padded_tables([r.rid for r in dec_reqs],
                                             width)
            for r, row in zip(dec_reqs, rows):
                tbl[r.slot] = row
        else:
            width = 1
            tbl = np.zeros((B, 1), np.int32)
        return active, tbl, width

    def _exec_decode(self, decode_reqs: List[Request],
                     k: int) -> Tuple[int, List[Request]]:
        kb, reqs = self._plan_decode_batch(decode_reqs, k)
        if not reqs:
            return 0, []
        self._privatize_decode_pages(reqs)
        self._service_tiers()
        active, tbl, _ = self._decode_args(reqs, kb)
        fn = self._decode_fn(kb)
        first = self._h2d(self.slot_last_token[:, None])
        pos = self._h2d(self.slot_pos)
        if self.paged:
            d_toks, self.pools, self.cache, d_pos = fn(
                self.pools, self.cache, first, pos, self._h2d(tbl),
                self.gen, self._h2d(active))
        else:
            d_toks, self.cache, d_pos = fn(self.cache, first, pos, self.gen,
                                           self._h2d(active))
        # the synchronous oracle reads tokens and positions every iteration
        toks = d_toks.cpu().numpy()
        self.slot_pos = d_pos.cpu().numpy().astype(np.int32)
        for r in reqs:
            seq = toks[r.slot, :kb]
            take = min(kb, r.output_len - r.generated)
            r.output_tokens.extend(int(t) for t in seq[:take])
            # seq is a host numpy row (fetched above), not a device value
            # duetlint: disable-next=host-sync
            self.slot_last_token[r.slot] = int(seq[take - 1])
            self.kv_mgr.commit_tokens(r.rid, take)
        return kb, reqs

    # ------------------------------------------------------------- run loop
    def run(self) -> ServingMetrics:
        """Serve every submitted request to a terminal state. Returns
        :class:`ServingMetrics` over the requests ingested since the
        previous ``run``."""
        self.service_until(math.inf)
        reqs = self._all[self._epoch:]
        self._epoch = len(self._all)
        duration, self._epoch_now = self.now - self._epoch_now, self.now
        return ServingMetrics(requests=reqs, duration=duration)

    def service_until(self, t: float) -> List:
        """Advance the engine's virtual clock up to time ``t`` (an in-flight
        iteration may overshoot it). Returns the serving events produced —
        always ``[]`` for the synchronous engine."""
        out: List = []
        while self.now < t:
            evs, progressed = self._tick()
            out.extend(evs)
            if not progressed:
                break
        return out

    def _tick(self) -> Tuple[List, bool]:
        """One serving-loop pass: admit arrivals, plan, execute one
        iteration (or jump the clock to the next arrival, or reject
        starved requests). Returns ``(events, progressed)``."""
        self.state.admit_arrivals(self._pending, self.now)
        self._admit_waiting()
        plan = self._plan()
        if not plan.is_idle:
            self._execute(plan)
            return [], True
        if self._pending:
            self.now = max(self.now, self._pending[0].arrival)
            return [], True
        if self.state.waiting:
            # nothing runs, nothing is pending, and the policy still
            # refuses every waiting request: no completion can ever free
            # pages, so these can never start.
            for r in list(self.state.waiting):
                self.state.waiting.remove(r)
                self._reject(r, "kv_admission_starved")
            return [], True
        return [], False

    def outstanding_tokens(self) -> int:
        """Total tokens of work this engine still owes: the remaining
        prefill + decode tokens of every resident request plus
        submitted-but-unarrived requests."""
        n = sum(ld.q for ld in self.state.outstanding_loads())
        n += sum(r.remaining_prompt + max(0, r.output_len - r.generated)
                 for r in self._pending)
        return n

    def _plan(self) -> IterationPlan:
        # only slot-admitted requests are schedulable
        sched_state = QueueState(
            waiting=[r for r in self.state.waiting if r.slot is not None],
            running=self.state.running,
            prefilling=self.state.prefilling)
        plan = self.policy.schedule(sched_state)
        for r, _ in plan.prefill:
            if r in self.state.waiting:
                self.state.waiting.remove(r)
                if r not in self.state.prefilling:
                    self.state.prefilling.append(r)
        self.state.prefilling = sched_state.prefilling
        return plan

    def _iteration_timing(self, plan: IterationPlan):
        """(k, t_decode, t_prefill) for this iteration from the roofline
        decision. Shared by the sync and async engines — their virtual
        clocks must advance identically."""
        if plan.mode == "duet" and plan.decision.partition is not None:
            part = plan.decision.partition
            return part.k, part.t_decode, part.t_prefill
        pre_loads, dec_loads = plan.loads()
        t_iter = self.mux.predict_mixed(pre_loads + dec_loads) \
            + self.ec.sched_overhead \
            + (self.ec.dispatch_overhead if plan.prefill else 0.0)
        return 1, t_iter, t_iter

    def _iteration_span(self, plan: IterationPlan, kb: int, t_d: float,
                        t_p: float) -> float:
        """Span of this iteration on the virtual clock."""
        if plan.mode == "duet" and plan.decision.partition is not None:
            return max(kb * t_d, t_p) + self.ec.sched_overhead \
                + self.ec.dispatch_overhead
        return t_d

    def _execute(self, plan: IterationPlan):
        k, t_d, t_p = self._iteration_timing(plan)
        kb, ran = (self._exec_decode(plan.decode, k)
                   if plan.decode else (0, []))
        # metrics: decode tokens at t_d spacing (decode dispatched first),
        # recorded before the prefill chunks run
        for j in range(1, kb + 1):
            ts = self.now + j * t_d
            for r in list(ran):
                if r.generated < len(r.output_tokens):
                    r.record_token(ts)
                    if r.done:
                        self.state.running.remove(r)
                        self._retire(r)
        for r, chunk in plan.prefill:
            if r.phase != Phase.PREFILL:
                continue   # preempted earlier in this iteration
            status = self._exec_prefill_chunk(r, chunk)
            if status in ("first", "resumed"):
                self.state.prefilling.remove(r)
                r.phase = Phase.DECODE
                if status == "first":
                    r.record_token(self.now + t_p)
                if r.done:
                    self._retire(r)
                else:
                    self.state.running.append(r)
        self.now += self._iteration_span(plan, kb, t_d, t_p)

    def _retire(self, r: Request):
        self.kv_mgr.free(r.rid)
        if r.slot is not None:
            self.free_slots.append(r.slot)
            r.slot = None
        self.finished.append(r)
