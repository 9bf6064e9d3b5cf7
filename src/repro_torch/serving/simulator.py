"""Discrete-event serving simulator with the roofline model as the latency
oracle.

A host-only copy of the reference's ``repro.serving.simulator``: request
streams replay through the port's copies of the scheduler policies
(``repro_torch.serving.scheduler``), and each engine iteration advances
virtual time by the attention-aware roofline prediction (§4.1), priced for
a TPU v5e by default as in the reference. The same requests give the same
``ServingMetrics`` in both packages, exactly
(``tests/test_torch_simulator.py``).

Instance kinds:
  * InstanceSim   — one replica (aggregated or duet scheduling)
  * ClusterSim    — N replicas behind the same pluggable dispatch policies
                    as the real ``serving.router.Router`` (round-robin =
                    the Fig. 2 Agg-vLLM setup; least-loaded and
                    prefix-affinity keep sim-vs-real deltas
                    apples-to-apples)
  * DisaggSim     — 1P+1D phase disaggregation with KV-transfer delay
                    (Fig. 2 Disagg-Dynamo setup, Obs. 3)
"""
from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

from repro_torch.configs.base import GQA_KINDS, MLA_KINDS, ArchConfig
from repro_torch.core.multiplexer import AdaptiveMultiplexer
from repro_torch.core.roofline import (HardwareSpec, RequestLoad,
                                       RooflineModel, TPU_V5E)
from repro_torch.serving.kvcache import (DEFAULT_PAGE_SIZE,
                                         PagedKVCacheManager, PagePoolConfig,
                                         block_keys)
from repro_torch.serving.request import Phase, Request, ServingMetrics
from repro_torch.serving.router import (DispatchPolicy, ElasticConfig,
                                        ElasticPolicy, RouterEvent,
                                        ScaleEvent, make_dispatch_policy)
from repro_torch.serving.scheduler import (BasePolicy, ChunkedPrefillPolicy,
                                           DuetPolicy, IterationPlan,
                                           PrefillFirstPolicy, QueueState)


def kv_bytes_per_token(cfg: ArchConfig, dtype_bytes: int = 2) -> int:
    total = 0
    for kind in cfg.block_pattern:
        if kind in GQA_KINDS:
            total += 2 * cfg.num_kv_heads * cfg.head_dim * dtype_bytes
        elif kind in MLA_KINDS:
            total += (cfg.kv_lora_rank + cfg.qk_rope_dim) * dtype_bytes
        # recurrent blocks: O(1) state, no per-token cost
    return total


def kv_capacity_tokens(cfg: ArchConfig, hw: HardwareSpec, units: int,
                       mem_fraction: float = 0.9,
                       hbm_per_unit: float = 16e9,
                       dtype_bytes: int = 2) -> int:
    """Pool size after weights, mirroring the gpu-memory-utilization knob."""
    from repro_torch.models.params import count_params_analytical
    weights = count_params_analytical(cfg) * dtype_bytes
    avail = hbm_per_unit * units * mem_fraction - weights
    per_tok = max(1, kv_bytes_per_token(cfg, dtype_bytes))
    return max(1024, int(avail / per_tok))


@dataclass
class SimConfig:
    units: int = 8                  # chips in this replica
    tp: int = 8
    tbt_slo: float = 0.1
    sched_overhead: float = 0.0005  # CPU scheduling cost per iteration (s)
    dispatch_overhead: float = 0.004  # per-iteration host dispatch (prefill
    # kernels are host-launched; decode replays a cached program, §4.3)
    horizon: float = 1e6
    mem_fraction: float = 0.9
    hbm_per_unit: float = 16e9
    # paged-KV geometry: admission rounds footprints to page multiples and
    # the roofline pads KV reads the same way (page_size=1 = token-granular,
    # the pre-paging behaviour).
    page_size: int = 1
    # host-synchronisation model (paper §4.3): each blocking device->host
    # round-trip costs `host_sync_overhead`. The interruption-free engine
    # pays one per super-iteration; a synchronous engine pays one per
    # decode step (the hidden overhead duet mode amplifies — k fetches per
    # super-iteration) plus one per *finishing* prefill chunk (the host
    # argmax of the first token). 0.0 disables the term (legacy
    # behaviour). ``interruption_free`` defaults to True because the
    # repo's engines are now interruption-free — set it False explicitly
    # when modelling a synchronous engine generation.
    host_sync_overhead: float = 0.0
    interruption_free: bool = True


class InstanceSim:
    """One serving replica driven by a scheduling policy."""

    def __init__(self, cfg: ArchConfig, policy: BasePolicy,
                 sim: SimConfig, hw: HardwareSpec = TPU_V5E,
                 record_trace: bool = False):
        self.cfg = cfg
        self.policy = policy
        self.sim = sim
        self.hw = hw
        self.model = RooflineModel(cfg, hw, tp=sim.tp,
                                   page_size=sim.page_size)
        self.state = QueueState()
        self.now = 0.0
        self.finished: List[Request] = []
        self._queue: List[Request] = []   # submitted, not yet arrived
        self._all: List[Request] = []
        self._epoch = 0          # first request index of the current run()
        self._epoch_now = 0.0    # virtual clock when the last run() ended
        self.record_trace = record_trace
        self.trace: List[dict] = []   # per-iteration timeline (paper Fig. 10)

    # ------------------------------------------------------------------
    def _finish(self, r: Request):
        self.policy.release(r)
        self.state.running.remove(r)
        self.finished.append(r)

    def _host_sync_cost(self, plan: IterationPlan, k: int) -> float:
        """§4.3 host-synchronisation term: the interruption-free engine
        fetches once per super-iteration; a synchronous engine blocks
        after every decode step and on every finishing prefill chunk's
        first-token argmax (continue-chunks dispatch without read-back)."""
        h = self.sim.host_sync_overhead
        if h == 0.0:
            return 0.0
        if self.sim.interruption_free:
            return h
        finishing = sum(1 for r, c in plan.prefill
                        if c >= r.remaining_prompt)
        return h * ((k if plan.decode else 0) + finishing)

    def _apply_aggregated(self, plan: IterationPlan):
        pre_loads, dec_loads = plan.loads()
        t = self.model.iteration_latency(pre_loads + dec_loads,
                                         units=self.sim.units)
        t += self.sim.sched_overhead + self._host_sync_cost(plan, 1)
        if plan.prefill:
            t += self.sim.dispatch_overhead
        if self.record_trace:
            self.trace.append({
                "t": self.now, "mode": "aggregated", "dur": t, "k": 1,
                "decode_batch": len(plan.decode),
                "prefill_tokens": sum(c for _, c in plan.prefill),
                "sched_overhead": self.sim.sched_overhead})
        self.now += t
        for r in list(plan.decode):
            r.record_token(self.now)
            if r.done:
                self._finish(r)
        self._advance_prefill(plan, self.now)

    def _apply_duet(self, plan: IterationPlan):
        part = plan.decision.partition
        k = part.k
        span = max(k * part.t_decode, part.t_prefill) \
            + self.sim.sched_overhead + self.sim.dispatch_overhead \
            + self._host_sync_cost(plan, k)
        if self.record_trace:
            self.trace.append({
                "t": self.now, "mode": "duet", "dur": span, "k": k,
                "s_prefill": part.s_prefill, "s_decode": part.s_decode,
                "t_decode": part.t_decode, "t_prefill": part.t_prefill,
                "decode_batch": len(plan.decode),
                "prefill_tokens": sum(c for _, c in plan.prefill),
                "bubble": abs(k * part.t_decode - part.t_prefill),
                "sched_overhead": self.sim.sched_overhead})
        # decode stream: k steps, each t_decode apart (decode launches first)
        for j in range(1, k + 1):
            ts = self.now + j * part.t_decode
            for r in list(plan.decode):
                if r.done:
                    continue
                r.record_token(ts)
                if r.done:
                    self._finish(r)
        self._advance_prefill(plan, self.now + part.t_prefill)
        self.now += span

    def _advance_prefill(self, plan: IterationPlan, ts: float):
        for r, chunk in plan.prefill:
            r.prefilled += chunk
            r.prefill_executed += chunk
            if r.remaining_prompt <= 0:
                # prompt fully processed -> first token sampled this iteration
                self.state.prefilling.remove(r)
                r.phase = Phase.DECODE
                # ...unless this is a resume-from-preemption prefill: the
                # replayed outputs were recorded before the preemption and
                # the next decode input was sampled back then (the real
                # engine's "resumed" status samples nothing either)
                if not r.resume_len:
                    r.record_token(ts)
                if r.done:
                    self.policy.release(r)
                    self.finished.append(r)
                else:
                    self.state.running.append(r)

    # ------------------------------------------------------------------
    def submit(self, requests: Union[Request, Sequence[Request]]):
        """Enqueue requests (incremental — the cluster router's feed
        hook; mirrors ``DuetEngine.submit``)."""
        if isinstance(requests, Request):
            requests = [requests]
        reqs = list(requests)
        self._queue.extend(reqs)
        self._queue.sort(key=lambda r: r.arrival)
        self._all.extend(reqs)

    def _tick(self) -> bool:
        """One simulation step. Returns False when nothing can advance
        without new submissions (mirrors the engines' tick contract)."""
        self.state.admit_arrivals(self._queue, self.now)
        plan = self.policy.schedule(self.state)
        if plan.is_idle:
            if self._queue:
                self.now = max(self.now, self._queue[0].arrival)
                return True
            return False
        if plan.mode == "duet":
            self._apply_duet(plan)
        else:
            self._apply_aggregated(plan)
        return True

    def service_until(self, t: float):
        """Advance the replica's virtual clock up to ``min(t, horizon)``
        (the same lockstep stepping hook the real engines expose)."""
        t = min(t, self.sim.horizon)
        while self.now < t and self._tick():
            pass

    def outstanding_tokens(self) -> int:
        """Remaining prefill+decode tokens across resident and queued
        requests — the routing load signal (see
        ``scheduler.request_work``)."""
        n = sum(load.q for load in self.state.outstanding_loads())
        n += sum(r.remaining_prompt + max(0, r.output_len - r.generated)
                 for r in self._queue)
        return n

    def drain_requests(self):
        """Evict every live request for re-dispatch elsewhere (elastic
        scale-down) — the simulator twin of ``DuetEngine.drain_requests``:
        resident requests take the recompute-from-prompt preemption
        bookkeeping (``resume_len`` freezes the replay target; the resumed
        prefill samples no token), queued ones are withdrawn as-is, and
        all of them leave this replica's accounting.

        Returns:
            ``(requests, events)`` with requests sorted by
            ``(arrival, rid)`` (events always ``[]`` — the sim streams
            nothing), matching the engines' signature."""
        for r in list(self.state.running) + list(self.state.prefilling):
            self.policy.release(r)
            if r.generated:
                r.resume_len = r.prompt_len + r.generated - 1
            r.prefilled = 0
            r.preemptions += 1
            r.phase = Phase.WAITING
            self.state.waiting.append(r)
        self.state.running.clear()
        self.state.prefilling.clear()
        drained = list(self.state.waiting) + list(self._queue)
        self.state.waiting.clear()
        self._queue.clear()
        gone = {id(r) for r in drained}
        self._all = [r for r in self._all if id(r) not in gone]
        drained.sort(key=lambda r: (r.arrival, r.rid))
        return drained, []

    def metrics(self) -> ServingMetrics:
        """Full-lifetime view: every request ever submitted, clock as
        duration (what ``ClusterSim`` merges after a single drain)."""
        return ServingMetrics(requests=list(self._all), duration=self.now)

    def run(self, requests: List[Request]) -> ServingMetrics:
        """Serve a full (deep-copied) request list to completion or the
        horizon. Returns metrics over the requests submitted since the
        previous ``run`` (epoch-scoped, mirroring ``DuetEngine.run`` — a
        reused instance never double-counts earlier epochs)."""
        self.submit(sorted(copy.deepcopy(requests),
                           key=lambda r: r.arrival))
        self.service_until(self.sim.horizon)
        reqs = self._all[self._epoch:]
        self._epoch = len(self._all)
        duration, self._epoch_now = self.now - self._epoch_now, self.now
        return ServingMetrics(requests=reqs, duration=duration)


# ---------------------------------------------------------------------------
class _SimPrefixIndex:
    """Optimistic per-replica block-hash index for routing simulation.

    The sim router inserts a routed request's full-page prompt digests
    immediately (prefill completion is assumed — the one deliberate
    divergence from the real replica, which indexes at prefill
    completion), so prefix affinity has the same signal shape as the real
    ``kv_mgr.match_prefix`` without device pools. Uses the exact hashing
    convention of the live manager (``kvcache.block_keys``).

    Tier-blind by design: a digest inserted here is matchable forever,
    which models the real manager's *unified* view across tiers — the real
    ``match_prefix_keys`` reports HBM- and host-resident blocks
    identically, so demotion never changes a routing decision, only the
    promotion copies behind it. (With a host tier the never-evicts
    optimism tightens: real blocks now survive pool pressure by demoting,
    so sim-vs-real dispatch parity holds under pressure traces that would
    previously diverge — the reference pins it in its tiered-KV tests.)"""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self._keys: set = set()

    def match_keys(self, keys) -> int:
        n = 0
        for key in keys:
            if key not in self._keys:
                break
            n += 1
        return n * self.page_size

    def insert_keys(self, keys):
        self._keys.update(keys)


class _SimReplicaView:
    """Routing-signal adapter over one simulated replica (the sim twin of
    ``router._EngineView``)."""

    def __init__(self, inst: "InstanceSim", index: _SimPrefixIndex):
        self.inst = inst
        self.index = index
        self.page_size = index.page_size

    def outstanding_tokens(self) -> int:
        return self.inst.outstanding_tokens()

    def match_keys(self, keys) -> int:
        return self.index.match_keys(keys)


class ClusterSim:
    """N independent replicas behind a dispatch policy.

    Shares the policy implementations of the real cluster router
    (``repro_torch.serving.router``) and the same discrete-event routing
    semantics: every replica is advanced to each request's arrival before
    the dispatch decision, so load and prefix signals are the replica
    state at route time. A routed request's modeled prefix hit is written
    to ``Request.cached_prompt`` (the prefix-cache machinery: the policy then
    starts its prefill at the cached length) and its prompt tokens are
    dropped — simulated replicas consume lengths only.
    """

    def __init__(self, make_instance, n: int,
                 policy: Union[str, DispatchPolicy] = "round-robin",
                 page_size: int = DEFAULT_PAGE_SIZE,
                 elastic: Optional[ElasticConfig] = None):
        """Args:
            make_instance: ``replica_index -> InstanceSim`` factory.
            n: replica count (with ``elastic``: the maximum; must equal
                ``elastic.max_replicas``).
            policy: dispatch policy name (``router.ROUTER_POLICIES``) or
                instance; default round-robin (the Fig. 2 baseline and
                the real router's parity oracle).
            page_size: granularity of the modeled prefix index (match the
                engine's page size for sim-vs-real comparisons).
            elastic: optional ``router.ElasticConfig`` — the *identical*
                scaling policy the real router runs, so sim-vs-real
                scaling decision sequences stay pinned. Note one modeled
                gap: drained sim requests carry lengths only, so a
                prefix-affinity re-route degrades to the load fallback
                (use round-robin/least-loaded for elastic parity pins).
        """
        self.instances: List[InstanceSim] = [make_instance(i)
                                             for i in range(n)]
        self.policy = policy if isinstance(policy, DispatchPolicy) \
            else make_dispatch_policy(policy)
        self._page_size = page_size
        self._indices = [_SimPrefixIndex(page_size) for _ in range(n)]
        self._views = [_SimReplicaView(inst, idx) for inst, idx
                       in zip(self.instances, self._indices)]
        self.decisions: List[RouterEvent] = []
        if elastic is not None and elastic.max_replicas != n:
            raise ValueError(
                f"elastic.max_replicas={elastic.max_replicas} contradicts "
                f"the replica count ({n})")
        self.elastic = elastic
        self._elastic_policy = ElasticPolicy(elastic) if elastic else None
        self._active: List[int] = list(range(
            elastic.min_replicas if elastic else n))
        self.scale_events: List[ScaleEvent] = []

    def _route(self, r: Request, t: float):
        """One dispatch over the active subset (the whole cluster when not
        elastic) — identical positional-policy semantics to the real
        ``Router._route``."""
        # one hashing pass per dispatch: the digests feed the policy's
        # probe AND the chosen replica's hit-model/insert below
        keys = None if r.prompt_tokens is None \
            else block_keys(r.prompt_tokens, self._page_size)
        views = [self._views[i] for i in self._active]
        local, matched = self.policy.choose(views, r.prompt_tokens, keys)
        idx = self._active[local]
        self.policy.record(local)
        if keys is not None:
            # model the hit on the CHOSEN replica regardless of policy
            # — a real replica's kv_mgr serves its cached pages even
            # when a blind policy routed the request there — capped
            # the way the real lock is: at most prompt_len-1 cached so
            # one suffix token recomputes
            hit = self._indices[idx].match_keys(keys)
            if hit:
                r.cached_prompt = min(hit, r.prompt_len - 1)
            self._indices[idx].insert_keys(keys)
            r.prompt_tokens = None   # sim replicas consume lengths only
        self.decisions.append(RouterEvent(
            rid=r.rid, replica=idx, policy=self.policy.name,
            matched_tokens=matched,
            outstanding=tuple(v.outstanding_tokens()
                              for v in self._views),
            t=t))
        self.instances[idx].submit(r)

    def _control(self, t: float):
        """One elastic control tick (the sim half of the pinned scaling
        contract — same :class:`ElasticPolicy`, same realisation order)."""
        decision = self._elastic_policy.decide(
            [v.outstanding_tokens() for v in self._views], self._active, t)
        if decision is None:
            return
        action, idx = decision
        if action == "up":
            self._active = sorted(self._active + [idx])
            self.scale_events.append(ScaleEvent(
                "up", idx, tuple(self._active),
                tuple(v.outstanding_tokens() for v in self._views), 0, t))
            return
        drained, _ = self.instances[idx].drain_requests()
        self._active = [i for i in self._active if i != idx]
        self.scale_events.append(ScaleEvent(
            "down", idx, tuple(self._active),
            tuple(v.outstanding_tokens() for v in self._views),
            len(drained), t))
        for r in drained:
            self._route(r, t)

    def run(self, requests: List[Request]) -> ServingMetrics:
        """Route + simulate the full trace; returns cluster-merged
        metrics (duration = the slowest replica's clock). Dispatch
        decisions are recorded in ``self.decisions`` (and scaling
        decisions in ``self.scale_events``) for parity checks against the
        real router."""
        reqs = sorted(copy.deepcopy(requests), key=lambda r: r.arrival)
        for r in reqs:
            for inst in self.instances:
                inst.service_until(r.arrival)
            if self.elastic:
                self._control(r.arrival)
            self._route(r, r.arrival)
        if self.elastic:
            # drain with live control, on the same absolute check_interval
            # grid the real router steps (scale-downs happen here)
            ci = self.elastic.check_interval
            while any(inst.outstanding_tokens() > 0
                      for inst in self.instances):
                now = max(inst.now for inst in self.instances)
                horizon = (math.floor(now / ci) + 1) * ci
                for inst in self.instances:
                    inst.service_until(horizon)
                self._control(max(inst.now for inst in self.instances))
        merged = ServingMetrics()
        for inst in self.instances:
            inst.service_until(float("inf"))
            m = inst.metrics()
            merged.requests.extend(m.requests)
            merged.duration = max(merged.duration, m.duration)
        return merged


# ---------------------------------------------------------------------------
class DisaggSim:
    """nP+mD disaggregation (Dynamo-like): ``n_prefill`` replicas run all
    prefills FCFS (round-robin dispatch), ``n_decode`` replicas run
    decode-only continuous batching. The KV cache for each finished prompt is
    transferred over the interconnect before decode can start — the overhead
    aggregation avoids (Obs. 3)."""

    def __init__(self, cfg: ArchConfig, sim: SimConfig,
                 hw: HardwareSpec = TPU_V5E,
                 transfer_bw: float = 100e9,
                 token_budget: int = 8192, max_batch: int = 1024,
                 n_prefill: int = 1, n_decode: int = 1):
        self.cfg = cfg
        self.sim = sim
        self.hw = hw
        self.model = RooflineModel(cfg, hw, tp=sim.tp,
                                   page_size=sim.page_size)
        self.transfer_bw = transfer_bw
        self.token_budget = token_budget
        self.max_batch = max_batch
        self.n_prefill = n_prefill
        self.n_decode = n_decode
        self.kv_per_tok = kv_bytes_per_token(cfg)
        # the decode worker has the same per-chip KV pool as an aggregated
        # replica — without this cap disaggregation gets a free lunch
        self.kv_capacity = kv_capacity_tokens(cfg, hw, sim.units,
                                              sim.mem_fraction,
                                              sim.hbm_per_unit)

    def run(self, requests: List[Request]) -> ServingMetrics:
        reqs = sorted(copy.deepcopy(requests), key=lambda r: r.arrival)
        # ---- prefill workers: FCFS round-robin, chunk budget/iteration -----
        clocks = [0.0] * self.n_prefill
        ready: List[tuple] = []   # (decode_ready_time, request)
        for i, r in enumerate(reqs):
            w = i % self.n_prefill
            clocks[w] = max(clocks[w], r.arrival)
            done = 0
            while done < r.prompt_len:
                q = min(self.token_budget, r.prompt_len - done)
                clocks[w] += self.model.iteration_latency(
                    [RequestLoad(q=q, c=done, phase="prefill")],
                    units=self.sim.units) + self.sim.sched_overhead \
                    + self.sim.dispatch_overhead
                done += q
            r.prefilled = r.prompt_len
            r.record_token(clocks[w])   # first token sampled on prefill side
            transfer = r.prompt_len * self.kv_per_tok / self.transfer_bw
            if not r.done:
                ready.append((clocks[w] + transfer, r))
        t_p = max(clocks)
        if self.n_decode > 1:
            # split decode work across decode replicas round-robin
            shards: List[List[tuple]] = [[] for _ in range(self.n_decode)]
            ready.sort(key=lambda x: x[0])
            for i, item in enumerate(ready):
                shards[i % self.n_decode].append(item)
            t_d = 0.0
            for shard in shards:
                t_d = max(t_d, self._run_decode_worker(shard))
            return ServingMetrics(requests=reqs, duration=max(t_p, t_d))
        t_d = self._run_decode_worker(ready)
        return ServingMetrics(requests=reqs, duration=max(t_p, t_d))

    def _run_decode_worker(self, ready: List[tuple]) -> float:
        # decode-only continuous batching over one worker's share
        ready = sorted(ready, key=lambda x: x[0])
        t_d = 0.0
        running: List[Request] = []
        kv_in_use = 0
        finished = []

        ps = max(1, self.sim.page_size)

        def _kv_need(r):
            # page-rounded, matching the aggregated replicas' ledger
            return -(-(r.prompt_len + r.output_len) // ps) * ps

        while ready or running:
            while ready and (ready[0][0] <= t_d or not running):
                at, r = ready[0]
                if kv_in_use + _kv_need(r) > self.kv_capacity and running:
                    break            # pool full: wait for completions
                ready.pop(0)
                t_d = max(t_d, at) if not running else t_d
                if at <= t_d:
                    running.append(r)
                    kv_in_use += _kv_need(r)
                else:
                    ready.insert(0, (at, r))
                    break
            if not running:
                if ready:
                    t_d = ready[0][0]
                continue
            batch = running[:self.max_batch]
            loads = [RequestLoad(q=1, c=r.context_len) for r in batch]
            t_d += self.model.iteration_latency(loads, units=self.sim.units) \
                + self.sim.sched_overhead
            for r in list(batch):
                r.record_token(t_d)
                if r.done:
                    running.remove(r)
                    kv_in_use -= _kv_need(r)
                    finished.append(r)
        return t_d


# ---------------------------------------------------------------------------
def _admission_ledger(cfg: ArchConfig, sim: SimConfig,
                      hw: HardwareSpec) -> PagedKVCacheManager:
    """Page-granular admission ledger for one simulated replica: the policy
    allocates a request's full prompt+output footprint on admission and
    frees it on finish (BasePolicy reserve_on_admit mode)."""
    cap = kv_capacity_tokens(cfg, hw, sim.units, sim.mem_fraction,
                             sim.hbm_per_unit)
    ps = max(1, sim.page_size)
    return PagedKVCacheManager(
        PagePoolConfig(num_pages=cap // ps + 1, page_size=ps))


def make_duet_instance(cfg: ArchConfig, sim: SimConfig,
                       hw: HardwareSpec = TPU_V5E,
                       token_budget: int = 8192,
                       max_batch: int = 1024,
                       unit_step: int = 1) -> InstanceSim:
    mux = AdaptiveMultiplexer(cfg, hw=hw, total_units=sim.units,
                              tbt_slo=sim.tbt_slo, tp=sim.tp,
                              unit_step=unit_step, page_size=sim.page_size)
    policy = DuetPolicy(mux, token_budget=token_budget, max_batch=max_batch,
                        kv_mgr=_admission_ledger(cfg, sim, hw))
    return InstanceSim(cfg, policy, sim, hw)


def make_baseline_instance(cfg: ArchConfig, sim: SimConfig, kind: str,
                           hw: HardwareSpec = TPU_V5E,
                           token_budget: int = 8192,
                           max_batch: int = 1024) -> InstanceSim:
    mgr = _admission_ledger(cfg, sim, hw)
    if kind in ("vllm", "sglang-chunked"):
        policy = ChunkedPrefillPolicy(token_budget=token_budget,
                                      max_batch=max_batch, kv_mgr=mgr)
    elif kind == "sglang-default":
        policy = PrefillFirstPolicy(token_budget=token_budget,
                                    max_batch=max_batch, kv_mgr=mgr)
    else:
        raise ValueError(kind)
    return InstanceSim(cfg, policy, sim, hw)
