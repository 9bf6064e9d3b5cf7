"""Cluster router: data-parallel engine replicas behind pluggable dispatch.

The port of the reference's ``repro.serving.router``. ``serve.py --dp N``
serves **N real engine replicas** in one process (the reference's
single-controller router): each replica has its own
:class:`~repro_torch.core.device.DeviceContext` from
``DeviceContext.split_replicas`` — card *i* when there are N cards, card 0
for every replica when ``share_card`` asks for it, or the CPU — and owns
its paged KV pool, prefix cache and
:class:`~repro_torch.core.multiplexer.AdaptiveMultiplexer`. The duet
decision stays replica-local (Nexus-style intra-GPU multiplexing), while
the router decides only *which* replica serves each request.

With ``--tp M`` as well, each of the M rank processes runs this router
over its rank of every replica (``split_replicas`` gives each replica a
TP context over a process group of its own), as the reference carves its
mesh's data axes into ``(1, tp)`` submeshes: replica *i*'s rank *m* sits
on card ``i * M + m``, or every one on card 0 with ``share_card``. The
ranks' routers see the same host state (the replicas' engines on every
rank sample the same tokens), so they make the same dispatch, scaling
and drain decisions without talking.

Weights: each replica's model holds ``ctx.place_params`` of the served
model's tree (under TP, the rank's slices moved to the replica's device),
which is the same tensors when the replica's device is the model's. Replicas on one card therefore share one read-only weight tree;
only the pools, the per-slot state and the host state are per replica.
Replicas on one card also share torch's current stream, so one replica's
blocking fetch (``core.device.fetch_to_host``) waits for the other's
queued work too: correct, but the replicas' device work does not overlap.

Dispatch policies (DistServe motivates going beyond blind round-robin):

* ``round-robin``       — ClusterSim parity / oracle baseline: request *i*
                          goes to replica ``i % N`` regardless of state.
* ``least-loaded``      — fewest outstanding tokens
                          (:meth:`DuetEngine.outstanding_tokens`), tie-break
                          on dispatch count then replica index.
* ``prefix``            — prefix-affinity: route to the replica whose
                          block-hash index has the longest cached prefix of
                          the request's prompt (``kv_mgr.match_prefix``),
                          tie-break on load; falls back to least-loaded when
                          no replica has cached pages. Turns the per-replica
                          prefix caches into a routing signal: a
                          shared-system-prompt workload concentrates on warm
                          replicas instead of re-prefilling everywhere.

The host half (events, :class:`ElasticConfig`, :class:`ElasticPolicy`, the
dispatch policies) is a copy of the reference's, shared with the port's
``ClusterSim``; ``tests/test_torch_simulator.py`` pins it to the
reference's decision tables.

Time model: replicas advance on the same virtual clock the engines use
(the roofline's prediction for the device: the card's own on the card, a
TPU v5e's on the CPU, as in the reference). The router
steps every replica to each request's arrival time
(:meth:`DuetEngine.service_until`) *before* routing it, so load and
prefix-index observations are the true replica state at route time — the
same discrete-event semantics ``ClusterSim`` implements over
:class:`InstanceSim` replicas, which keeps sim-vs-real comparisons
apples-to-apples (the sim-parity contract).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Union

from repro_torch.core.device import DeviceContext
from repro_torch.core.roofline import HardwareSpec
from repro_torch.models.params import _map
from repro_torch.models.transformer import Model
from repro_torch.serving.engine import DuetEngine, EngineConfig
from repro_torch.serving.request import Request, ServingMetrics

ROUTER_POLICIES = ("round-robin", "least-loaded", "prefix")


# ------------------------------------------------------------------ events
@dataclass(frozen=True)
class RouterEvent:
    """One dispatch decision, streamed next to the token events."""
    rid: int
    replica: int
    policy: str
    matched_tokens: int          # cached-prefix tokens on the chosen replica
    outstanding: tuple           # per-replica outstanding tokens at route time
    t: float                     # virtual-clock route (= arrival) time


@dataclass(frozen=True)
class ScaleEvent:
    """One elastic scaling decision (streamed like RouterEvent)."""
    action: str                  # "up" | "down"
    replica: int                 # replica activated / drained
    active: tuple                # active replica set AFTER the action
    outstanding: tuple           # per-replica outstanding tokens at decision
    requeued: int                # requests drained & re-routed ("down" only)
    t: float                     # virtual-clock decision time


# ----------------------------------------------------------------- elastic
@dataclass(frozen=True)
class ElasticConfig:
    """Elastic data-parallelism policy knobs (DynaServe-style).

    Scale-up fires when the *mean* outstanding tokens per active replica
    exceed ``scale_up_tokens``; scale-down fires when the cluster total
    would fit under ``scale_down_tokens`` per replica with one replica
    fewer (hysteresis lives in the gap between the two thresholds).
    ``check_interval`` is the drain-phase control-tick grid — decisions are
    also evaluated at every arrival.
    """
    min_replicas: int = 1
    max_replicas: int = 2
    scale_up_tokens: int = 512
    scale_down_tokens: int = 64
    cooldown_s: float = 0.5
    check_interval: float = 0.25

    def __post_init__(self):
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}..{self.max_replicas}")
        if self.check_interval <= 0:
            raise ValueError("check_interval must be > 0")


class ElasticPolicy:
    """Pure scaling decision shared by the real :class:`Router` and
    ``ClusterSim`` — one implementation, so sim-vs-real scaling decision
    *sequences* stay pinned the same way dispatch decisions are.

    Deterministic by construction: replica 0 is never drained (it owns
    prompt materialisation and anchors min_replicas >= 1), scale-up
    activates the lowest inactive index, scale-down drains the
    least-loaded non-zero active replica (ties on index).
    """

    def __init__(self, cfg: ElasticConfig):
        self.cfg = cfg
        self._last_change = -math.inf

    def decide(self, outstanding: Sequence[int],
               active: Sequence[int], t: float):
        """One control-tick decision.

        Args:
            outstanding: per-replica outstanding tokens, indexed by global
                replica id (length = max_replicas).
            active: sorted global ids of currently-active replicas.
            t: virtual-clock decision time (cooldown reference).

        Returns:
            ``("up", replica)`` / ``("down", replica)`` or ``None``.
        """
        cfg = self.cfg
        if t - self._last_change < cfg.cooldown_s:
            return None
        total = sum(outstanding[i] for i in active)
        if len(active) < cfg.max_replicas and \
                total > cfg.scale_up_tokens * len(active):
            idx = min(i for i in range(cfg.max_replicas) if i not in active)
            self._last_change = t
            return ("up", idx)
        if len(active) > cfg.min_replicas and \
                total <= cfg.scale_down_tokens * (len(active) - 1):
            victims = [i for i in active if i != 0]
            idx = min(victims, key=lambda i: (outstanding[i], i))
            self._last_change = t
            return ("down", idx)
        return None


# ---------------------------------------------------------------- policies
class DispatchPolicy:
    """Strategy interface: pick a replica for one request.

    Implementations observe replicas through *views* exposing
    ``outstanding_tokens() -> int``, ``page_size`` and
    ``match_keys(keys) -> int`` (longest cached prefix against
    precomputed ``kvcache.block_keys`` chain digests — the prompt is
    hashed once per dispatch, not once per replica). Both the real
    :class:`Router` (over live engines) and ``ClusterSim`` (over
    simulated instances) provide them, so one policy implementation
    serves both execution paths.
    """

    name = "?"

    def __init__(self):
        self._dispatched: List[int] = []

    def _counts(self, n: int) -> List[int]:
        if len(self._dispatched) < n:
            self._dispatched += [0] * (n - len(self._dispatched))
        return self._dispatched

    def _least_loaded(self, views, candidates: Sequence[int]) -> int:
        """Fewest outstanding tokens; ties broken by fewest dispatches so
        far (so an idle cluster still spreads load), then replica index."""
        counts = self._counts(len(views))
        return min(candidates,
                   key=lambda i: (views[i].outstanding_tokens(),
                                  counts[i], i))

    def choose(self, views, token_ids, keys=None) -> tuple:
        """Route one request.

        Args:
            views: per-replica state views (see class docstring).
            token_ids: the request's prompt token ids, or ``None`` when the
                trace carries lengths only (prefix matching then degrades
                to the load-based fallback).
            keys: optional precomputed ``block_keys`` chain digests of
                ``token_ids`` — a caller that needs the digests itself
                (``ClusterSim``'s hit modeling) passes them so the prompt
                is hashed exactly once per dispatch.

        Returns:
            ``(replica_index, matched_tokens)`` — ``matched_tokens`` is the
            cached-prefix length on the chosen replica (0 for non-prefix
            policies).
        """
        raise NotImplementedError

    def record(self, idx: int):
        """Bookkeeping hook: the caller confirms the dispatch."""
        self._counts(idx + 1)
        self._dispatched[idx] += 1


class RoundRobinPolicy(DispatchPolicy):
    """Blind cyclic dispatch — the ClusterSim parity oracle."""
    name = "round-robin"

    def __init__(self):
        super().__init__()
        self._next = 0

    def choose(self, views, token_ids, keys=None) -> tuple:
        idx = self._next % len(views)
        self._next += 1
        return idx, 0


class LeastLoadedPolicy(DispatchPolicy):
    """Least-outstanding-tokens dispatch."""
    name = "least-loaded"

    def choose(self, views, token_ids, keys=None) -> tuple:
        return self._least_loaded(views, range(len(views))), 0


class PrefixAffinityPolicy(DispatchPolicy):
    """Longest-cached-prefix dispatch, tie-break on load."""
    name = "prefix"

    def choose(self, views, token_ids, keys=None) -> tuple:
        matched = [0] * len(views)
        if token_ids is not None and views:
            # hash the prompt ONCE (replicas share the engine page size),
            # then probe every replica's index with the same digests
            if keys is None:
                from repro_torch.serving.kvcache import block_keys
                keys = block_keys(token_ids, views[0].page_size)
            matched = [v.match_keys(keys) for v in views]
        best = max(matched)
        if best <= 0:
            return self._least_loaded(views, range(len(views))), 0
        warm = [i for i, m in enumerate(matched) if m == best]
        return self._least_loaded(views, warm), best


_POLICY_CLASSES = {
    "round-robin": RoundRobinPolicy,
    "least-loaded": LeastLoadedPolicy,
    "prefix": PrefixAffinityPolicy,
}


def make_dispatch_policy(name: str) -> DispatchPolicy:
    """Instantiate a dispatch policy by CLI name.

    Args:
        name: one of :data:`ROUTER_POLICIES`.

    Raises:
        ValueError: unknown policy name.
    """
    try:
        return _POLICY_CLASSES[name]()
    except KeyError:
        raise ValueError(
            f"unknown router policy {name!r}; choose from "
            f"{ROUTER_POLICIES}") from None


# ------------------------------------------------------------ replica view
class _EngineView:
    """Routing-signal adapter over one live engine replica."""

    def __init__(self, engine: DuetEngine):
        self.engine = engine
        self.page_size = engine.kv_mgr.page_size

    def outstanding_tokens(self) -> int:
        return self.engine.outstanding_tokens()

    def match_keys(self, keys) -> int:
        if not self.engine.paged:
            return 0
        return self.engine.kv_mgr.match_prefix_keys(keys)[0]


# ------------------------------------------------------------------ router
class Router:
    """N real engine replicas behind a dispatch policy.

    Builds one engine per replica context — each on its own model view of
    the served weights, with its own paged KV pool/prefix cache and its
    own duet decisions — then replays the submitted trace: every request
    is routed at its arrival time against live replica state, and the
    replicas are driven to completion on the shared virtual clock.
    """

    def __init__(self, model: Model, engine_cfg: EngineConfig, *,
                 ctx: Optional[DeviceContext] = None,
                 replicas: Optional[int] = None,
                 policy: Union[str, DispatchPolicy] = "round-robin",
                 engine_cls=DuetEngine,
                 hw: Optional[HardwareSpec] = None, seed: int = 0,
                 elastic: Optional[ElasticConfig] = None):
        """Args:
            model: the served model; each replica gets a :class:`Model`
                over its weights for its context ``c``. At tp 1 those are
                ``c.place_params`` of the model's whole tree (the same
                tensors on the model's device). Under TP ``model`` is this
                rank's, so its tree already holds the rank's slices, and
                each replica (the same rank of its own TP group) takes
                them on its device: never cut twice, and no whole tree is
                built. The port's engines take no separate ``params``.
            engine_cfg / hw / seed: forwarded to every replica engine
                (``hw`` None: each prices its device, the card or, on the
                CPU, a TPU v5e; replicas on one card share its measured
                curve).
            ctx: cluster device context (``DeviceContext.for_replicas``, or
                under TP the rank's context with ``dp`` replicas, e.g.
                ``Rank.context(cfg, dp=...)``); ``split_replicas`` gives
                one context per replica (under TP one of tp ranks over a
                process group of its own). Every rank's router makes the
                same decisions: they read only host state, which the
                ranks' identical engines keep identical.
                Defaults, at tp 1, to ``replicas`` replicas on the
                model's device type, one card a replica (raising when
                there are fewer cards: sharing one takes an explicit
                context with ``share_card=True``).
            replicas: replica count; defaults to ``ctx.dp`` (or 2 when no
                context is given). With ``elastic`` this is the *maximum*
                replica count — all engines are built up front, but
                dispatch only sees the active subset.
            policy: dispatch policy name (:data:`ROUTER_POLICIES`) or a
                :class:`DispatchPolicy` instance.
            engine_cls: ``DuetEngine`` (default) or ``AsyncDuetEngine``
                (streaming token events through :meth:`events`).
            elastic: optional :class:`ElasticConfig` — scale the active
                replica set against measured outstanding tokens, draining
                scaled-down replicas via the preempt→recompute requeue
                path and re-routing their requests.

        Raises:
            ValueError: replica count contradicts ``ctx.dp`` (or the
                elastic ``max_replicas``), fewer than one replica
                requested, or a TP model without its rank's context.
        """
        cfg = model.cfg
        mctx = model.ctx
        if mctx.tp > 1 and (ctx is None or (ctx.tp, ctx.rank)
                            != (mctx.tp, mctx.rank)):
            raise ValueError(
                f"a TP model (rank {mctx.rank} of tp={mctx.tp}) is served "
                "by replicas of its rank: pass ctx=DeviceContext(cfg, "
                "device, tp=..., rank=..., dp=...) of the same rank")
        if ctx is None:
            n = replicas or (elastic.max_replicas if elastic else 2)
            ctx = DeviceContext.for_replicas(cfg, n,
                                             device=model.device.type)
        if replicas is None:
            replicas = ctx.dp
        if replicas < 1:
            raise ValueError(f"need >= 1 replica, got {replicas}")
        if replicas != ctx.dp:
            raise ValueError(
                f"replicas={replicas} contradicts the context's data axes "
                f"(dp={ctx.dp}); pass one geometry")
        if elastic is not None and elastic.max_replicas != replicas:
            raise ValueError(
                f"elastic.max_replicas={elastic.max_replicas} contradicts "
                f"the replica count ({replicas}); the context must hold the "
                "maximum")
        self.ctx = ctx
        self.cfg = cfg
        self.ec = engine_cfg
        self.policy = policy if isinstance(policy, DispatchPolicy) \
            else make_dispatch_policy(policy)
        tree = model.param_tree()

        def weights(c: DeviceContext) -> dict:
            if mctx.tp == 1:
                return c.place_params(tree)
            return _map(lambda _, t: t.to(c.device), tree)

        self.engines: List[DuetEngine] = [
            engine_cls(Model(cfg, weights(c), ctx=c,
                             mla_absorb=model.mla_absorb,
                             attn_kernel=model.attn_kernel,
                             split_kv_threshold=model.split_kv_threshold),
                       engine_cfg, hw=hw, seed=seed, device=c.device)
            for c in ctx.split_replicas()]
        # async replicas on one card capture their CUDA graphs into one
        # memory pool (they replay in turn on its one stream)
        pools: dict = {}
        for e in self.engines:
            if getattr(e, "graphs", False):
                e.graph_pool = pools.setdefault(e.device, e.graph_pool)
        self._views = [_EngineView(e) for e in self.engines]
        self._pending: List[Request] = []
        self.decisions: List[RouterEvent] = []
        self._metrics: Optional[ServingMetrics] = None
        self._replica_metrics: List[ServingMetrics] = []
        self.elastic = elastic
        self._elastic_policy = ElasticPolicy(elastic) if elastic else None
        self._active: List[int] = list(range(
            elastic.min_replicas if elastic else len(self.engines)))
        self.scale_events: List[ScaleEvent] = []

    # ------------------------------------------------------------- frontend
    @property
    def n_replicas(self) -> int:
        return len(self.engines)

    def submit(self, requests: Union[Request, Sequence[Request]]):
        """Enqueue requests for routed serving.

        Prompt tokens are materialised up front (the prefix-affinity
        policy hashes them at route time). Routing itself happens inside
        :meth:`events`/:meth:`run`, at each request's arrival on the
        virtual clock. Callable mid-run from an event callback (the
        serving loop re-checks the queue); unlike the async engines'
        inbox, ``submit`` is NOT thread-safe — feed a cluster from the
        driving thread.
        """
        if isinstance(requests, Request):
            requests = [requests]
        reqs = list(requests)
        for r in reqs:
            self.engines[0]._materialize_prompt(r)
        self._pending.extend(reqs)
        self._pending.sort(key=lambda r: r.arrival)

    def events(self) -> Iterator:
        """Serve the submitted trace, yielding events as they happen.

        Yields:
            One :class:`RouterEvent` per dispatch decision, interleaved
            with the replicas' own serving events (token/finish events
            when the replicas are ``AsyncDuetEngine``; synchronous
            replicas emit none). Replica events are yielded in per-replica
            virtual-time order; events of different replicas may arrive
            slightly out of global order (each carries its ``t``).
        """
        while True:
            while self._pending:
                r = self._pending.pop(0)
                # advance every replica to the arrival so dispatch
                # observes true replica state (in-flight work, cache
                # contents) at route time
                for eng in self.engines:
                    yield from eng.service_until(r.arrival)
                if self.elastic:
                    yield from self._control(r.arrival)
                yield self._route(r)
            if self.elastic:
                yield from self._elastic_drain()
            else:
                for eng in self.engines:
                    yield from eng.service_until(math.inf)
            # an event callback may have submitted more work during the
            # drain — loop back instead of dropping it
            if not self._pending:
                break

    def _route(self, r: Request, at: Optional[float] = None) -> RouterEvent:
        # elastic mode dispatches over the *active* subset; the policy sees
        # positional views (its bookkeeping is positional in both the real
        # router and ClusterSim, so decision sequences still line up)
        views = [self._views[i] for i in self._active]
        local, matched = self.policy.choose(views, r.prompt_tokens)
        idx = self._active[local]
        outstanding = tuple(v.outstanding_tokens() for v in self._views)
        self.policy.record(local)
        self.engines[idx].submit(r)
        ev = RouterEvent(rid=r.rid, replica=idx, policy=self.policy.name,
                         matched_tokens=matched, outstanding=outstanding,
                         t=r.arrival if at is None else at)
        self.decisions.append(ev)
        return ev

    # ------------------------------------------------------------- elastic
    def _control(self, t: float) -> Iterator:
        """One elastic control tick: observe outstanding tokens, apply the
        shared :class:`ElasticPolicy`, realise the decision. A scale-down
        drains the victim through the engines' preempt→recompute path and
        re-routes the drained requests over the remaining active set."""
        decision = self._elastic_policy.decide(
            [v.outstanding_tokens() for v in self._views], self._active, t)
        if decision is None:
            return
        action, idx = decision
        if action == "up":
            self._active = sorted(self._active + [idx])
            ev = ScaleEvent(
                "up", idx, tuple(self._active),
                tuple(v.outstanding_tokens() for v in self._views), 0, t)
            self.scale_events.append(ev)
            yield ev
            return
        drained, evs = self.engines[idx].drain_requests()
        yield from evs       # flushed in-flight tokens must still stream
        self._active = [i for i in self._active if i != idx]
        ev = ScaleEvent(
            "down", idx, tuple(self._active),
            tuple(v.outstanding_tokens() for v in self._views),
            len(drained), t)
        self.scale_events.append(ev)
        yield ev
        for r in drained:
            yield self._route(r, at=t)

    def _elastic_drain(self) -> Iterator:
        """Drain phase with live control: advance the cluster in
        ``check_interval`` steps (grid-aligned on the virtual clock, so
        sim and real evaluate at the same absolute tick times) and run a
        control tick after each, until every engine is idle. This is where
        scale-downs happen — load subsides as the tail of the trace
        completes."""
        ci = self.elastic.check_interval
        while True:
            if self._pending:
                return           # mid-drain submission: loop back to route
            if all(e.outstanding_tokens() == 0 for e in self.engines):
                for eng in self.engines:
                    yield from eng.service_until(math.inf)
                return
            now = max(e.now for e in self.engines)
            horizon = (math.floor(now / ci) + 1) * ci
            for eng in self.engines:
                yield from eng.service_until(horizon)
            yield from self._control(max(e.now for e in self.engines))

    def run(self, on_event=None) -> ServingMetrics:
        """Route + serve every submitted request to a terminal state.

        Args:
            on_event: optional callback receiving every event
                :meth:`events` would yield.

        Returns:
            Cluster-merged :class:`ServingMetrics` (requests from all
            replicas; duration = the slowest replica's span).
        """
        for ev in self.events():
            if on_event is not None:
                on_event(ev)
        merged = ServingMetrics()
        self._replica_metrics = []
        for eng in self.engines:
            m = eng.run()   # drained by events(); collects epoch metrics
            self._replica_metrics.append(m)
            merged.requests.extend(m.requests)
            merged.duration = max(merged.duration, m.duration)
        self._metrics = merged
        return merged

    # ------------------------------------------------------------ reporting
    def prefix_stats(self) -> dict:
        """Cluster-aggregated prefix-cache stats: counters summed across
        replicas, ``hit_rate`` recomputed over the cluster totals, and
        ``per_replica`` carrying each replica's own view."""
        per = [e.kv_mgr.prefix_stats() for e in self.engines]
        agg = {k: sum(p[k] for p in per)
               for k in ("lookups", "lookup_tokens", "hit_requests",
                         "hit_tokens", "cow_copies", "evictions",
                         "pages_allocated", "demotions", "promotions",
                         "host_hit_requests", "host_hit_tokens",
                         "host_evictions", "cached_pages", "shared_pages")}
        agg["tiers"] = {t: sum(p["tiers"][t] for p in per)
                        for t in per[0]["tiers"]} if per else {}
        agg["hit_rate"] = agg["hit_tokens"] / max(1, agg["lookup_tokens"])
        agg["enabled"] = any(p["enabled"] for p in per)
        agg["host_tier"] = any(p["host_tier"] for p in per)
        agg["per_replica"] = per
        return agg

    def router_summary(self) -> dict:
        """Dispatch accounting: policy, per-replica request counts, and
        how many prompt tokens prefix-affinity found cached at route
        time."""
        counts = [0] * self.n_replicas
        for d in self.decisions:
            counts[d.replica] += 1
        out = {
            "policy": self.policy.name,
            "replicas": self.n_replicas,
            "dispatch_counts": counts,
            "routed_requests": len(self.decisions),
            "prefix_routed_tokens": sum(d.matched_tokens
                                        for d in self.decisions),
        }
        if self.elastic:
            out["elastic"] = {
                "min_replicas": self.elastic.min_replicas,
                "max_replicas": self.elastic.max_replicas,
                "scale_ups": sum(1 for e in self.scale_events
                                 if e.action == "up"),
                "scale_downs": sum(1 for e in self.scale_events
                                   if e.action == "down"),
                "requeued_requests": sum(e.requeued
                                         for e in self.scale_events),
                "final_active": list(self._active),
                "events": [{"action": e.action, "replica": e.replica,
                            "requeued": e.requeued, "t": round(e.t, 6)}
                           for e in self.scale_events],
            }
        return out

    def summary(self) -> dict:
        """Cluster-level summary: merged TTFT/TBT/throughput plus SLO
        attainment, the router block, and per-replica summaries. Call
        after :meth:`run`.

        Raises:
            RuntimeError: ``run`` has not completed yet.
        """
        if self._metrics is None:
            raise RuntimeError("Router.summary() before run()")
        out = self._metrics.summary()
        out["slo_attainment"] = self._metrics.slo_attainment(self.ec.tbt_slo)
        out["router"] = self.router_summary()
        out["per_replica"] = []
        for i, (eng, m) in enumerate(zip(self.engines,
                                         self._replica_metrics)):
            rep = {"replica": i, **m.summary(),
                   "slo_attainment": m.slo_attainment(self.ec.tbt_slo),
                   "duet_fraction": eng.mux.stats.duet_fraction,
                   "iterations": eng.mux.stats.iterations,
                   "mesh": eng.ctx.describe()}
            if self.ec.paged:
                rep["prefix_cache"] = eng.kv_mgr.prefix_stats()
            out["per_replica"].append(rep)
        return out
