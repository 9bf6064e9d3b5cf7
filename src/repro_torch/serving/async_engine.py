"""Interruption-free asynchronous serving engine (paper §4.3) with
streaming admission.

:class:`AsyncDuetEngine` removes the two host round-trips the synchronous
:class:`~repro_torch.serving.engine.DuetEngine` pays every iteration:

* **Fused super-iteration dispatch** — the k look-ahead decode steps *and*
  the iteration's prefill chunk run as a single program
  (:func:`repro_torch.core.lookahead.make_superiter_fn`). All sampling
  happens in-program: the decode input tokens and slot positions live on
  the device (``d_last_tok`` / ``d_pos``, updated in place) and thread
  from one program to the next, so the host never reads a device value to
  build the next dispatch. Host inputs go up through pinned buffers
  without waiting for the device. Programs are cached per shape bucket —
  (k bucket, block-table width bucket, chunk length, chunk table width,
  finish/sample flags, the SM split's S_d, duet) —
  (``dstats.cache_hits``); no per-dispatch value enters the key.

* **CUDA Graphs per dispatch bucket** (``graphs``; on by default for a
  CUDA engine without collectives) — each bucket
  (:class:`~repro_torch.core.lookahead.BucketProgram`) owns static input
  tensors (tables, active mask, the chunk's tokens and table, and the
  chunk's start, its slot and the resume token as 0-d device tensors),
  filled before each dispatch. A bucket's first dispatch runs eagerly
  (the warm-up), its second is captured into a ``torch.cuda.CUDAGraph``
  in the engine's one memory pool and replayed, and every later one
  replays the graph: the port's counterpart of the reference's jitted
  program per bucket (``dstats.captures`` / ``replays``; a key seen once
  is never captured). A replay's tokens are copied out on the stream at
  once, since the next replay of that bucket overwrites the graph's
  outputs before the engine fetches them. Launch counters count replays
  (each adds the launches its capture recorded). What runs eagerly is
  counted in ``dstats.eager_dispatches`` by its rule
  (``dstats.eager_reasons``): a bucket's first dispatch (``warmup``); a
  chunk on the slab path (``slab_chunk``: its slab views are cut at the
  chunk's end, a shape that follows the host's start); every dispatch of
  an engine under a collective group (``collectives``: TP, CP, the grid,
  whose gloo all-reduces run on the host), on the CPU (``cpu``: the same
  static buffers, no graph) or with ``graphs=False`` (``off``). Sampling
  at ``temperature > 0`` is captured: each graph registers the engine's
  generator, so a replay draws fresh numbers. ``graphs=True`` where capture cannot
  happen raises, and so does a failed capture or replay: nothing falls
  back. The synchronous engine stays eager, the oracle.

* **The SM split** (``sm_split``; on by default where it can run) — a
  duet-mode iteration runs its k decode steps and its prefill chunk at
  once on two green contexts of disjoint SMs, 2·S_d and 2·S_p of them,
  the (S_p, S_d) Algorithm 1 chose in the card's TPCs
  (:class:`~repro_torch.core.device.SmSplit`, one per S_d, kept for the
  engine's life). The bucket's program is the sequential program cut in
  two halves (``make_superiter_fn(..., split=True)``) that fork from the
  engine's stream onto the two contexts' streams and join back; both
  halves are captured into the bucket's one CUDA graph, so a replay stays
  one ``cudaGraphLaunch``. The bucket key gains S_d. Where a decode
  request finishes inside the iteration (``_duet_safe`` False) the chunk
  may take over its pages, so that iteration runs the sequential program
  on the whole card, as it does without the split. ``dstats`` counts
  split dispatches by ``"S_p:S_d"``, their captures and replays. The
  virtual clock is the same either way: it already charges
  ``max(kb·t_d(S_d), t_p(S_p))``. ``sm_split=None`` turns the split on
  for a CUDA engine on one device, paged, on the kernel path with every
  block GQA attention; ``True`` raises elsewhere (``split_blocker``);
  ``False`` keeps the fused duet launch. Only an engine that splits
  prices the split: given no ``hw`` it plans with
  ``device_pricing(..., split=True)`` (B(S) on the split's green
  contexts, Algorithm 1's S_d at the driver's step); a given ``hw`` must
  plan over one card's TPCs at that step. Every other engine makes no
  green context.

* **Double-buffered host scheduling** — while iteration *i* executes on
  the device, the host plans iteration *i+1* from last-known loads:
  admission, page reservation and the duet/aggregated mux decision are pure
  bookkeeping (greedy decode makes completion deterministic from counts).
  Iteration *i*'s tokens come back in ONE blocking fetch when *i+1* has
  already been dispatched — at most one host sync per super-iteration
  (``dstats.host_syncs``; a capture's own device sync is counted in
  ``captures``).

* **Streaming front-end** — :meth:`submit` accepts requests mid-run (from
  event callbacks, another thread, or an asyncio task) and the engine
  yields :class:`TokenEvent` / :class:`FinishEvent` through
  :meth:`events` (generator), :meth:`run` (callback), or :meth:`astream`
  (async iterator).

The synchronous engine remains the token-equivalence oracle: greedy decode
makes the async engine's output streams token-identical on the same trace.
"""
from __future__ import annotations

import asyncio
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import GQA_KINDS
from repro_torch.core.device import (DeviceLike, SmSplit, card_unit_step,
                                     fetch_to_host, resolve_device)
from repro_torch.core.lookahead import (BucketProgram, graph_pool_bytes,
                                        make_superiter_fn)
from repro_torch.core.roofline import HardwareSpec
from repro_torch.kernels.ops import build_duet_schedule, duet_block_q
from repro_torch.models.transformer import Model
from repro_torch.serving.engine import (DuetEngine, EngineConfig,
                                        device_pricing)
from repro_torch.serving.request import Phase, Request, ServingMetrics
from repro_torch.serving.scheduler import IterationPlan


# --------------------------------------------------------------------- events
@dataclass(frozen=True)
class TokenEvent:
    """One generated token, streamed as soon as its iteration retires."""
    rid: int
    token: int
    index: int          # position in the request's output stream
    t: float            # virtual-clock emission time


@dataclass(frozen=True)
class FinishEvent:
    """Terminal outcome of a request (completed or rejected)."""
    rid: int
    reason: str         # "completed" | "rejected:<why>"
    t: float
    n_tokens: int
    output_tokens: List[int] = field(default_factory=list)


Event = Union[TokenEvent, FinishEvent]


@dataclass
class DispatchStats:
    """Dispatch-cache and host-sync accounting for the async engine.
    ``host_syncs`` counts the engine's own fetches; under tensor
    parallelism a collective backend may wait on the device inside its
    all-reduces (gloo does), which ``DeviceContext.all_reduces`` counts
    apart."""
    super_iterations: int = 0
    dispatches: int = 0          # device programs launched
    host_syncs: int = 0          # blocking device->host fetches
    cache_hits: int = 0          # dispatches served by a cached program
    cache_misses: int = 0        # dispatches that built a new bucket
    captures: int = 0            # dispatches that captured their bucket's
    #                              CUDA graph (a device sync each)
    replays: int = 0             # dispatches that replayed a graph
    eager_dispatches: int = 0    # dispatches run op by op from Python
    eager_reasons: Dict[str, int] = field(default_factory=dict)  # by rule
    # SM-split dispatches by "S_p:S_d" (TPCs), and those that captured
    # or replayed their bucket's graph
    split_dispatches: Dict[str, int] = field(default_factory=dict)
    split_captures: int = 0
    split_replays: int = 0

    @property
    def syncs_per_super_iteration(self) -> float:
        return self.host_syncs / max(1, self.super_iterations)


# why an engine dispatches nothing through CUDA graphs (DispatchStats'
# eager_reasons keys), with what ``graphs=True`` raises there
_NO_GRAPHS = {
    "cpu": "CUDA graphs need a CUDA device",
    "collectives": "the engine's context makes collectives (TP, CP or the "
                   "grid): gloo's all-reduces run on the host and cannot be "
                   "captured",
}


def graph_blocker(device: torch.device, ctx) -> Optional[str]:
    """Why an engine on ``device`` under ``ctx`` cannot capture its
    programs (a key of ``_NO_GRAPHS``), or None."""
    if ctx.collectives:
        return "collectives"
    if device.type != "cuda":
        return "cpu"
    return None


# why an engine cannot run the SM split, with what ``sm_split=True`` raises
# there
_NO_SPLIT = {
    "cpu": "the SM split needs a CUDA card's green contexts",
    "collectives": "the engine's context makes collectives (TP, CP or the "
                   "grid): those keep the fused duet launch",
    "slab": "the SM split runs the paged programs",
    "kernel": "the SM split's chunk runs on the kernel path and needs every "
              "block GQA attention (the fused duet launch's condition)",
    "pricing": "the engine does not plan over one card's TPCs at the "
               "driver's split granularity",
}


def split_blocker(device: torch.device, model: Model,
                  engine_cfg: EngineConfig, hw) -> Optional[str]:
    """Why an engine cannot run the SM split (a key of ``_NO_SPLIT``), or
    None: where no CUDA graph can be captured (the CPU, collectives), the
    split cannot run either. ``hw`` None is priced for the split
    (``device_pricing(..., split=True)``); a given ``hw`` must already
    plan over one card's TPCs at the driver's step."""
    blocker = graph_blocker(device, model.ctx)
    if blocker:
        return blocker
    if not engine_cfg.paged:
        return "slab"
    if not (model.attn_kernel
            and all(k in GQA_KINDS for k in model.cfg.block_pattern)):
        return "kernel"
    if max(engine_cfg.units, engine_cfg.tp) != 1 or hw is not None and (
            getattr(hw, "units_per_device", 1) < 2
            or getattr(hw, "unit_step", 1) != card_unit_step(device)):
        return "pricing"
    return None


# ------------------------------------------------------------------ in-flight
@dataclass
class _DecItem:
    req: Request
    slot: int
    times: List[float] = field(default_factory=list)


@dataclass
class _FirstItem:
    req: Request
    fetch_idx: int
    ts: float


@dataclass
class _Inflight:
    """Device handles + host metadata of one dispatched super-iteration.
    The handles are program *outputs* captured at dispatch, so later
    programs can run before this record is drained."""
    fetch: List[torch.Tensor] = field(default_factory=list)
    toks_idx: int = -1
    dec_items: List[_DecItem] = field(default_factory=list)
    first_items: List[_FirstItem] = field(default_factory=list)
    # tier demotions riding this iteration's one fetch: (digest, per-layer
    # (k_idx, v_idx) positions into `fetch`, None for recurrent layers).
    # The slices are clones taken before any pool-rewriting op.
    demotions: List[tuple] = field(default_factory=list)


class AsyncDuetEngine(DuetEngine):
    """Asynchronous, interruption-free DuetServe engine.

    Inherits all host-side planning from :class:`DuetEngine` (admission,
    page-granular reservation, look-ahead shrink / victim preemption, duet
    mux decision) and replaces the execution layer with fused
    super-iteration programs and a double-buffered dispatch loop.
    """

    def __init__(self, model: Model, engine_cfg: EngineConfig,
                 hw: Optional[HardwareSpec] = None, seed: int = 0,
                 device: DeviceLike = None, graphs: Optional[bool] = None,
                 sm_split: Optional[bool] = None):
        # CUDA graphs: None = wherever capture can happen; True raises where
        # it cannot
        blocker = graph_blocker(resolve_device(device), model.ctx)
        if graphs and blocker:
            raise ValueError(f"graphs=True: {_NO_GRAPHS[blocker]}")
        # the SM split: None = wherever it can run; True raises where it
        # cannot. Only an engine that splits prices the split (the green
        # contexts' B(S), the driver's unit step) and makes green contexts
        no_split = split_blocker(resolve_device(device), model, engine_cfg,
                                 hw)
        if sm_split and no_split:
            raise ValueError(f"sm_split=True: {_NO_SPLIT[no_split]}")
        self.sm_split = no_split is None and sm_split is not False
        if self.sm_split and hw is None:
            hw = device_pricing(resolve_device(device), split=True)
        super().__init__(model, engine_cfg, hw=hw, seed=seed, device=device)
        self.graphs = blocker is None and graphs is not False
        # the rule every dispatch of a graphless engine runs eagerly by
        self._eager_rule = None if self.graphs else (blocker or "off")
        # one memory pool for every bucket's graph (the router gives DP
        # replicas on one card one pool)
        self.graph_pool = (torch.cuda.graph_pool_handle() if self.graphs
                           else None)
        B = engine_cfg.max_slots
        # device-resident decode inputs: next token + cache position per
        # slot, threaded between super-iteration programs
        self.d_last_tok = torch.zeros((B, 1), dtype=torch.int32,
                                      device=self.device)
        self.d_pos = torch.zeros((B,), dtype=torch.int32, device=self.device)
        # paged duet kernel: with the kernel path on and every block GQA
        # attention, the decode batch and the prefill chunk fuse into ONE
        # duet_attention_paged launch per layer (paper Algorithm 1). The
        # tile permutation depends only on (max_slots, chunk), so it is
        # cached per chunk bucket as a device tensor.
        self._duet_kernel = (
            self.model.attn_kernel and self.paged
            and all(k in GQA_KINDS for k in self.cfg.block_pattern))
        self._duet_orders: dict = {}
        # rows of one duet tile: a chunk tile fills one 64-row block of the
        # paged kernel (the reference tiles one row at a time; only
        # scheduling differs)
        self._duet_bq = duet_block_q(self.cfg.num_heads,
                                     self.cfg.num_kv_heads,
                                     self.cfg.head_dim)
        self._duet_safe = True
        # one SmSplit per S_d, made at its first dispatch and kept for the
        # engine's life (its buckets' graphs use its streams)
        self._sm_splits: dict = {}
        self._programs: dict = {}
        self.dstats = DispatchStats()
        # _pending/_all/_epoch bookkeeping lives in the base engine; the
        # async front-end adds only the thread-safe inbox feeding it
        self._inbox: deque = deque()
        self._lock = threading.Lock()
        self._inflight: Optional[_Inflight] = None
        # demotion slices captured during the current super-iteration's
        # planning/dispatch, waiting to ride its one fetch
        self._tier_captures: List[tuple] = []

    # ------------------------------------------------------------- streaming
    def submit(self, requests: Union[Request, Sequence[Request]],
               at: Optional[float] = None):
        """Enqueue requests; callable any time, including mid-run (from an
        event callback, another thread, or an asyncio task). ``at``
        overrides the arrival time (pass ``engine.now`` for "now")."""
        if isinstance(requests, Request):
            requests = [requests]
        reqs = list(requests)
        for r in reqs:
            self._materialize_prompt(r)
            if at is not None:
                r.arrival = at
        with self._lock:
            self._inbox.extend(reqs)

    def _ingest(self):
        with self._lock:
            new = list(self._inbox)
            self._inbox.clear()
        if not new:
            return
        self._all.extend(new)
        self._pending.extend(new)
        self._pending.sort(key=lambda r: r.arrival)

    def _finish_event(self, r: Request,
                      t: Optional[float] = None) -> FinishEvent:
        return FinishEvent(r.rid, r.finish_reason or "completed",
                           self.now if t is None else t,
                           len(r.output_tokens), list(r.output_tokens))

    # ------------------------------------------------------------- run loops
    def run(self, on_event: Optional[Callable[[Event], None]] = None
            ) -> ServingMetrics:
        """Serve until every submitted request reaches a terminal state.
        Returns metrics over the requests ingested since the last run."""
        for ev in self.events():
            if on_event is not None:
                on_event(ev)
        reqs = self._all[self._epoch:]
        self._epoch = len(self._all)
        duration, self._epoch_now = self.now - self._epoch_now, self.now
        return ServingMetrics(requests=reqs, duration=duration)

    async def astream(self):
        """Async iterator over serving events. The blocking engine loop runs
        on a worker thread and events are pumped through an asyncio queue,
        so concurrent tasks on the loop keep running. Abandoning the
        iterator early does not stop the engine."""
        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue()
        done = object()

        def pump():
            try:
                for ev in self.events():
                    loop.call_soon_threadsafe(queue.put_nowait, ev)
            finally:
                loop.call_soon_threadsafe(queue.put_nowait, done)

        worker = loop.run_in_executor(None, pump)
        try:
            while True:
                ev = await queue.get()
                if ev is done:
                    break
                yield ev
        finally:
            await worker   # surfaces engine exceptions

    def events(self) -> Iterator[Event]:
        """Generator core: open-loop arrival replay plus streaming
        admission. Terminates when queues, pending arrivals and the inbox
        are all empty.

        Yields:
            :class:`TokenEvent` / :class:`FinishEvent` in virtual-time
            order as super-iterations retire.
        """
        while True:
            evs, progressed = self._tick()
            yield from evs
            if not progressed:
                break
        yield from self._drain()   # safety net; the idle tick drained

    def _tick(self):
        """One pass of the async serving loop (``(events, progressed)``, as
        the base engine)."""
        evs: List[Event] = []
        self._ingest()
        self.state.admit_arrivals(self._pending, self.now)
        for r in self._admit_waiting():
            evs.append(self._finish_event(r))
        plan = self._plan()
        if not plan.is_idle:
            evs.extend(self._step(plan))
            return evs, True
        # idle: flush the pipeline, then wait for arrivals or stop
        evs.extend(self._drain())
        self._ingest()
        if self._pending:
            self.now = max(self.now, self._pending[0].arrival)
            return evs, True
        if self.state.waiting:
            for r in list(self.state.waiting):
                self.state.waiting.remove(r)
                self._reject(r, "kv_admission_starved")
                evs.append(self._finish_event(r))
            return evs, True
        return evs, False

    def outstanding_tokens(self) -> int:
        """Outstanding-work signal; extends the base count with requests
        still sitting in the thread-safe inbox."""
        with self._lock:
            inbox = list(self._inbox)
        return super().outstanding_tokens() + sum(
            r.remaining_prompt + max(0, r.output_len - r.generated)
            for r in inbox)

    def drain_requests(self):
        """Elastic scale-down drain. The in-flight super-iteration is
        retired *first* — its device tokens belong to requests about to be
        preempted, and preempting under an open ``_Inflight`` would append
        a stale fetch onto a recomputing request — then the inbox is
        folded into ``_pending`` so withdrawn work includes requests not
        yet ingested. The flushed token/finish events are returned for the
        caller to stream (they happened; a drain must not swallow them)."""
        evs = list(self._drain())
        self._ingest()
        drained, more = super().drain_requests()
        return drained, evs + more

    # ---------------------------------------------------------------- tiers
    def _capture_demotion(self, key: bytes, slices: List):
        """Defer the host read: hold the page's cloned device slices until
        :meth:`_attach_tier_captures` folds them into the iteration's one
        fetch."""
        self._tier_captures.append((key, slices))

    def _attach_tier_captures(self, inf: _Inflight):
        for key, slices in self._tier_captures:
            layout = []
            for s in slices:
                if s is None:
                    layout.append(None)
                else:
                    layout.append((len(inf.fetch), len(inf.fetch) + 1))
                    inf.fetch.extend(s)
            inf.demotions.append((key, layout))
        self._tier_captures = []

    # -------------------------------------------------------- super-iteration
    def _step(self, plan: IterationPlan) -> Iterator[Event]:
        """Plan + dispatch one super-iteration, then drain the previous one.
        Bookkeeping is completion-deterministic (greedy decode), so the
        whole plan is built from host state while the previous iteration is
        still executing on the device."""
        self.dstats.super_iterations += 1
        # a preemption-resume chunk that replays already-sampled outputs is
        # the only plan input that needs device token values — catch up
        # only then
        if any(r.resume_len and (r.prefilled + c > r.prompt_len
                                 or c >= r.remaining_prompt)
               for r, c in plan.prefill):
            yield from self._drain()

        k, t_d, t_p = self._iteration_timing(plan)

        kb, ran = (self._plan_decode_batch(plan.decode, k)
                   if plan.decode else (0, []))
        self._privatize_decode_pages(ran)
        # duet fusion safety: a decode request finishing inside this
        # iteration returns its pages to the pool below, and the prefill
        # chunk may reallocate them. The sequential program orders decode
        # reads before the chunk's writes; the fused duet launch does not —
        # so those iterations dispatch the sequential program instead.
        self._duet_safe = not any(
            r.output_len - r.generated <= kb for r in ran)
        dec_items = [_DecItem(r, r.slot) for r in ran]
        for r in ran:
            self.kv_mgr.commit_tokens(r.rid, kb)
        # snapshot the decode dispatch inputs NOW, while every member still
        # owns its pages
        dec_args = self._decode_args(ran, kb)
        for j in range(1, kb + 1):
            ts = self.now + j * t_d
            for it in dec_items:
                if not it.req.done:
                    it.req.record_token(ts)
                    it.times.append(ts)
                    if it.req.done:
                        self.state.running.remove(it.req)
                        self._retire(it.req)

        pre_items = []
        for r, chunk in plan.prefill:
            if r.phase != Phase.PREFILL:
                continue   # preempted earlier in this iteration
            if not self._ensure_pages(r, chunk):
                continue   # deferred: decode completions free pages
            if self.paged:
                # privatise a shared first page (CoW) before the chunk
                # writes
                self._cow_copy(
                    self.kv_mgr.ensure_writable(r.rid, r.prefilled))
            self.kv_mgr.allocate(r.rid, chunk)
            self._reset_if_new(r)
            start = r.prefilled
            toks_np = r.prefill_token_ids()[start:start + chunk]
            # a short slice means a resume replay ran ahead of the drain
            # gate — fail loudly rather than dispatch a truncated chunk
            assert len(toks_np) == chunk, \
                "prefill chunk dispatched with stale host token values"
            r.prefilled += chunk
            r.prefill_executed += chunk
            if r.remaining_prompt > 0:
                status = "continue"
            elif r.resume_len:
                status = "resumed"
            else:
                status = "first"
            if status != "continue" and self.prefix_cache:
                self.kv_mgr.insert_prefix(r.rid, r.prefill_token_ids())
            # snapshot the chunk's block table before any retire below can
            # free the pages (an output_len==1 request finishes here)
            if self.paged:
                pwidth = self._table_width([r.rid])
                ptbl = self.kv_mgr.padded_tables([r.rid], pwidth)
            else:
                pwidth, ptbl = 1, None
            # the slot too: a request finishing below gives it back
            pre_items.append((r, chunk, start, toks_np, status, ptbl,
                              pwidth, r.slot))
            if status in ("first", "resumed"):
                self.state.prefilling.remove(r)
                r.phase = Phase.DECODE
                if status == "first":
                    r.record_token(self.now + t_p)
                if r.done:
                    self._retire(r)
                else:
                    self.state.running.append(r)

        # device dispatch: decode fuses with the first prefill chunk into
        # one program; extra chunks ride prefill-only programs (more
        # dispatches, still zero extra host syncs)
        inf = _Inflight(dec_items=dec_items)
        part = plan.decision.partition if plan.mode == "duet" else None
        if ran or pre_items:
            self._dispatch(inf, kb if ran else 0, dec_args,
                           pre_items[0] if pre_items else None, t_p,
                           part)
            for item in pre_items[1:]:
                self._dispatch(inf, 0, None, item, t_p)
        self._attach_tier_captures(inf)
        prev, self._inflight = self._inflight, (inf if inf.fetch else None)
        if prev is not None:
            yield from self._drain_record(prev)
        self.now += self._iteration_span(plan, kb, t_d, t_p)

    # ---------------------------------------------------------------- device
    def _program(self, key) -> BucketProgram:
        """The bucket of ``key`` = (kb, width, chunk, pwidth, finish,
        sample, S_d, duet): built at its first dispatch with its static
        inputs; S_d > 0 is a split bucket on the engine's SmSplit of S_d
        TPCs."""
        prog = self._programs.get(key)
        if prog is None:
            self.dstats.cache_misses += 1
            kb, width, chunk, pwidth, finish, sample, s_d, duet = key
            split = None
            if s_d:
                split = self._sm_splits.get(s_d)
                if split is None:
                    split = self._sm_splits[s_d] = SmSplit(self.device, s_d)
            prog = BucketProgram(
                make_superiter_fn(
                    self.model, kb, paged=self.paged, chunk=chunk,
                    finish=finish, sample=sample,
                    temperature=self.ec.temperature, duet_kernel=duet,
                    duet_block_q=self._duet_bq, split=bool(s_d)),
                self.device, self.ec.max_slots, width=max(width, 1),
                chunk=chunk, pwidth=max(pwidth, 1), paged=self.paged,
                split=split)
            self._programs[key] = prog
        else:
            self.dstats.cache_hits += 1
        return prog

    def _execute(self, prog: BucketProgram, args, rule: Optional[str]):
        """Run one dispatch of ``prog`` on ``args``: replay its graph,
        capture it (its second dispatch) or run it eagerly, by ``rule``
        (None on a graphed engine, else why this dispatch is eager)."""
        st = self.dstats
        if rule is None:
            if prog.graph is not None:
                st.replays += 1
                st.split_replays += prog.split is not None
                return prog.replay()
            if prog.runs:
                st.captures += 1
                if prog.split is not None:
                    st.split_captures += 1
                return prog.capture(args, self.graph_pool,
                                    self.gen if self.ec.temperature > 0
                                    else None)
            rule = "warmup"
        st.eager_dispatches += 1
        st.eager_reasons[rule] = st.eager_reasons.get(rule, 0) + 1
        return prog.run(*args)

    def graph_pool_bytes(self) -> int:
        """Device bytes the engine's graph memory pool holds (0 without
        graphs): the segments the caching allocator gave that pool."""
        return 0 if self.graph_pool is None else \
            graph_pool_bytes(self.graph_pool)

    def _duet_order(self, chunk: int) -> torch.Tensor:
        """Tile schedule for the fused duet launch: decode rows 0..B-1 one
        per tile, interleaved at the Algorithm-1 ratio among the chunk rows
        B..B+chunk-1 in tiles of ``duet_block_q`` rows; its ``row_src``
        (-1 = pad) is the program's ``order``. Scheduling only — the
        numerics do not depend on it. Built once per chunk length and
        uploaded once (no host read)."""
        order = self._duet_orders.get(chunk)
        if order is None:
            B = self.ec.max_slots
            sched = build_duet_schedule(
                [(b, 0) for b in range(B)],
                [(B, i) for i in range(chunk)], block_q=self._duet_bq)
            order = self._h2d(sched.row_src.astype(np.int32))
            self._duet_orders[chunk] = order
        return order

    def _dispatch(self, inf: _Inflight, kb: int, dec_args, pre_item,
                  t_p: float, part=None):
        """Launch one fused program; capture its output handles in `inf`.
        ``part`` is the iteration's duet partition, if any: with both
        phases and the split on, the program runs on its (S_p, S_d).
        Everything here is host->device only — no blocking reads."""
        # flush tier migrations first: promoted pages must hold their
        # content before this program can read them, and pending demotion
        # slices must be captured before the program rewrites their pages
        self._service_tiers()
        B = self.ec.max_slots
        if dec_args is None:
            dec_args = (np.zeros(B, bool), np.zeros((B, 1), np.int32), 1)
        active, tbl, width = dec_args

        if pre_item is not None:
            r, chunk, start, toks_np, status, ptbl, pwidth, pre_slot = \
                pre_item
            finish = status in ("first", "resumed")
            sample = status == "first"
            if finish and not sample:
                # resume finish: the pre-preemption next token becomes the
                # decode input — the _step drain gate must have caught us up
                assert len(r.output_tokens) == r.generated, \
                    "resume dispatched with stale host token values"
                override = int(r.output_tokens[-1])
            else:
                override = 0
        else:
            chunk, finish, sample, pwidth = 0, False, False, 1
            start, pre_slot, override = 0, 0, 0
            toks_np = ptbl = None

        both = self._duet_safe and kb > 0 and chunk > 0
        s_d = part.s_decode if both and self.sm_split and part else 0
        duet = both and self._duet_kernel and not s_d
        key = (kb, width if kb else 0, chunk, pwidth if chunk else 0,
               finish, sample, s_d, duet)
        prog = self._program(key)
        self.dstats.dispatches += 1
        if s_d:
            where = f"{part.s_prefill}:{s_d}"
            split = self.dstats.split_dispatches
            split[where] = split.get(where, 0) + 1
        prog.feed(active, tbl if self.paged else None,
                  None if toks_np is None else np.asarray(toks_np)[None, :],
                  ptbl, (start, pre_slot, override))
        rule = self._eager_rule
        if self.paged:
            args = (self.pools, self.cache, self.d_last_tok, self.d_pos,
                    prog.tables, self.gen, prog.active, prog.pre_toks,
                    prog.pre_tbl, prog.pre_start, prog.pre_slot,
                    prog.override_tok)
            if duet:
                args += (self._duet_order(chunk),)
        else:
            # the slab chunk's views are cut at its start + C on the host
            where = (start, pre_slot) if chunk else (prog.pre_start,
                                                     prog.pre_slot)
            args = (self.cache, self.d_last_tok, self.d_pos, self.gen,
                    prog.active, prog.pre_toks, *where, prog.override_tok)
            if chunk and rule is None:
                rule = "slab_chunk"
        toks, sampled = self._execute(prog, args, rule)
        if kb > 0:
            inf.toks_idx = len(inf.fetch)
            inf.fetch.append(toks)
        if pre_item is not None and sample:
            inf.first_items.append(
                _FirstItem(pre_item[0], len(inf.fetch), self.now + t_p))
            inf.fetch.append(sampled)

    # ----------------------------------------------------------------- drain
    def _drain(self) -> Iterator[Event]:
        inf, self._inflight = self._inflight, None
        if inf is not None:
            yield from self._drain_record(inf)

    def _drain_record(self, inf: _Inflight) -> Iterator[Event]:
        """Retire one dispatched super-iteration: fetch every device value
        it produced with one blocking sync, append token values to their
        requests, and emit stream events."""
        if not inf.fetch:
            return
        vals = fetch_to_host(inf.fetch)
        self.dstats.host_syncs += 1
        if inf.toks_idx >= 0:
            toks = vals[inf.toks_idx]
            for it in inf.dec_items:
                seq = toks[it.slot, :len(it.times)]
                base = len(it.req.output_tokens)
                it.req.output_tokens.extend(int(t) for t in seq)
                for j, (tok, ts) in enumerate(zip(seq, it.times)):
                    yield TokenEvent(it.req.rid, int(tok), base + j, ts)
                yield from self._maybe_finish(it.req)
        for fi in inf.first_items:
            tok = int(vals[fi.fetch_idx])
            yield TokenEvent(fi.req.rid, tok, len(fi.req.output_tokens),
                             fi.ts)
            fi.req.output_tokens.append(tok)
            yield from self._maybe_finish(fi.req)
        for key, layout in inf.demotions:
            self.kv_mgr.complete_demotion(key, [
                None if pair is None else (vals[pair[0]], vals[pair[1]])
                for pair in layout])

    def _maybe_finish(self, r: Request) -> Iterator[Event]:
        if r.phase == Phase.FINISHED and \
                len(r.output_tokens) >= r.output_len:
            yield self._finish_event(r, t=r.finish_time)
