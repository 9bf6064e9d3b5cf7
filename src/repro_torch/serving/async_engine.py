"""Interruption-free asynchronous serving engine (paper §4.3) with
streaming admission.

:class:`AsyncDuetEngine` removes the two host round-trips the synchronous
:class:`~repro_torch.serving.engine.DuetEngine` pays every iteration:

* **Fused super-iteration dispatch** — the k look-ahead decode steps *and*
  the iteration's prefill chunk run as a single program
  (:func:`repro_torch.core.lookahead.make_superiter_fn`). All sampling
  happens in-program: the decode input tokens and slot positions live on
  the device (``d_last_tok`` / ``d_pos``) and thread from one program to
  the next, so the host never reads a device value to build the next
  dispatch. Host inputs go up through pinned buffers without waiting for
  the device. Programs are cached per shape bucket — (k bucket, block-table
  width bucket, chunk length, finish/sample flags, duet) —
  (``dstats.cache_hits``).

* **Double-buffered host scheduling** — while iteration *i* executes on
  the device, the host plans iteration *i+1* from last-known loads:
  admission, page reservation and the duet/aggregated mux decision are pure
  bookkeeping (greedy decode makes completion deterministic from counts).
  Iteration *i*'s tokens come back in ONE blocking fetch when *i+1* has
  already been dispatched — at most one host sync per super-iteration
  (``dstats.host_syncs``).

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
from typing import Callable, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import GQA_KINDS
from repro_torch.core.device import DeviceLike, fetch_to_host
from repro_torch.core.lookahead import make_superiter_fn
from repro_torch.core.roofline import HardwareSpec, TPU_V5E
from repro_torch.kernels.ops import build_duet_schedule, duet_block_q
from repro_torch.models.transformer import Model
from repro_torch.serving.engine import DuetEngine, EngineConfig
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
    """Dispatch-cache and host-sync accounting for the async engine."""
    super_iterations: int = 0
    dispatches: int = 0          # device programs launched
    host_syncs: int = 0          # blocking device->host fetches
    cache_hits: int = 0          # dispatches served by a cached program
    cache_misses: int = 0        # dispatches that built a new bucket

    @property
    def syncs_per_super_iteration(self) -> float:
        return self.host_syncs / max(1, self.super_iterations)


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
                 hw: HardwareSpec = TPU_V5E, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__(model, engine_cfg, hw=hw, seed=seed, device=device)
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
        if ran or pre_items:
            self._dispatch(inf, kb if ran else 0, dec_args,
                           pre_items[0] if pre_items else None, t_p)
            for item in pre_items[1:]:
                self._dispatch(inf, 0, None, item, t_p)
        self._attach_tier_captures(inf)
        prev, self._inflight = self._inflight, (inf if inf.fetch else None)
        if prev is not None:
            yield from self._drain_record(prev)
        self.now += self._iteration_span(plan, kb, t_d, t_p)

    # ---------------------------------------------------------------- device
    def _program(self, key, kb, chunk, finish, sample, duet=False):
        prog = self._programs.get(key)
        if prog is None:
            self.dstats.cache_misses += 1
            prog = make_superiter_fn(
                self.model, kb, paged=self.paged, chunk=chunk,
                finish=finish, sample=sample,
                temperature=self.ec.temperature, duet_kernel=duet,
                duet_block_q=self._duet_bq)
            self._programs[key] = prog
        else:
            self.dstats.cache_hits += 1
        return prog

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
                  t_p: float):
        """Launch one fused program; capture its output handles in `inf`.
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
            pre_toks = self._h2d(np.asarray(toks_np)[None, :])
            pre_tbl = None if ptbl is None else self._h2d(ptbl)
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
            pre_toks = pre_tbl = None

        duet = (self._duet_kernel and self._duet_safe
                and kb > 0 and chunk > 0)
        key = (kb, width if kb else 0, chunk, pwidth if chunk else 0,
               finish, sample, duet)
        prog = self._program(key, kb, chunk, finish, sample, duet)
        self.dstats.dispatches += 1
        if self.paged:
            pargs = (self.pools, self.cache, self.d_last_tok, self.d_pos,
                     self._h2d(tbl), self.gen, self._h2d(active), pre_toks,
                     pre_tbl, start, pre_slot, override)
            if duet:
                pargs += (self._duet_order(chunk),)
            (toks, sampled, self.d_last_tok, self.d_pos, self.pools,
             self.cache, self.gen) = prog(*pargs)
        else:
            (toks, sampled, self.d_last_tok, self.d_pos, self.cache,
             self.gen) = prog(self.cache, self.d_last_tok, self.d_pos,
                              self.gen, self._h2d(active), pre_toks, start,
                              pre_slot, override)
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
