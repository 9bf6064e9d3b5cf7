"""Serving launcher: run the port's DuetServe engine on a trace (CLI).

One process drives one replica on one device — the CUDA card by default,
the CPU with ``--device cpu`` — or, with ``--tp N``, N processes (one a
tensor-parallel rank, ``launch/mesh.py``) drive one replica together:
each holds its slices of the weights, KV heads and recurrent state (every
block kind and both frontends shard, as the reference's axis rules say),
every rank runs the same engine on the same requests, rank 0 prints, and
the run fails unless every rank produced the same token streams. The
ranks talk over gloo on the CPU, over nccl with a card a rank, and over
gloo with ``--share-card``, which puts every rank on card 0.

``--dp N`` serves N real engine replicas behind the cluster router
(``serving/router.py``) from this one process: requests are dispatched
per ``--router-policy``, each replica keeps its own KV pool, prefix cache
and duet multiplexer, and the summary reports per-replica plus
cluster-aggregate metrics. A replica takes card *i* when there are N
cards; ``--share-card`` puts every replica on card 0, where they share one
weight tree (and torch's stream). ``--elastic`` scales the active replica
set between ``--min-dp`` and ``--max-dp``. ``--dp`` (or ``--elastic``)
with ``--tp M`` serves N replicas of M ranks: each of the M rank
processes runs the router over its rank of every replica (each replica a
process group of its own; replica *i*'s rank *m* on card ``i * M + m``,
or every one on card 0 with ``--share-card``), and the run fails unless
every rank produced the same streams. ``--arrival``, ``--service-mix``
and ``--rho`` draw the trace from the seeded open-loop load generator
(``serving/loadgen.py``). The flags are the reference's
(``repro.launch.serve``). ``--no-paged`` serves from the slab KV cache
(the reference's equivalence oracle for the paged path). Weights are
random, from ``--seed``.

Two execution modes:

* default — synchronous :class:`DuetEngine` (the token-equivalence oracle)
* ``--stream`` — asynchronous :class:`AsyncDuetEngine` with open-loop
  arrival replay; per-token events print as JSON lines while generation is
  still in flight. On one card each dispatch bucket's program is captured
  into a CUDA graph and replayed (TP ranks dispatch every program eagerly;
  the library's ``AsyncDuetEngine(..., graphs=False)`` turns graphs off);
  ``dispatch_stats`` counts captures, replays and eager dispatches by
  their rule.

The summary's TTFT/TBT/throughput come from the engine's virtual clock:
the roofline's prediction for the card (its TPCs and its measured
bandwidth curve; a TPU v5e's with ``--device cpu``, as in the
reference), not a measurement of the card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
      --attn-kernel --stream --num-requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced \\
      --device cpu --stream --num-requests 4
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced \\
      --device cpu --no-paged --stream --num-requests 4
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced \\
      --device cpu --tp 2 --num-requests 4 --attn-kernel
  PYTHONPATH=src python -m repro_torch.launch.serve --arch \\
      deepseek-v2-lite-16b --reduced --device cpu --tp 2 --num-requests 4
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced \\
      --device cpu --dp 2 --router-policy prefix --shared-prefix-len 32 \\
      --num-requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --attn-kernel \\
      --dp 2 --share-card --stream --num-requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced \\
      --device cpu --tp 2 --dp 2 --num-requests 8
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.core.device import DeviceContext
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.transformer import Model
from repro_torch.serving.async_engine import (AsyncDuetEngine, FinishEvent,
                                              TokenEvent)
from repro_torch.serving.engine import (DuetEngine, EngineConfig,
                                        device_pricing)
from repro_torch.serving.kvcache import DEFAULT_PAGE_SIZE, KV_QUANT_MODES
from repro_torch.serving.loadgen import (ARRIVAL_PROCESSES, SERVICE_MIXES,
                                         ArrivalSpec, LoadGenerator,
                                         LoadSpec, ServiceSpec, qps_for_rho,
                                         request_cost)
from repro_torch.serving.request import synth_prompt_tokens
from repro_torch.serving.router import (ROUTER_POLICIES, ElasticConfig,
                                        Router, RouterEvent, ScaleEvent)
from repro_torch.serving.traces import TRACES, synth_trace


def _warn(msg: str):
    print(f"warning: {msg}", file=sys.stderr)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Run the port's DuetServe engine on a synthesised "
                    "trace.")
    ap.add_argument("--arch", choices=list_configs(), default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch path)")
    ap.add_argument("--trace", choices=list(TRACES), default="azure-conv")
    ap.add_argument("--qps", type=float, default=4.0)
    ap.add_argument("--num-requests", type=int, default=16)
    ap.add_argument("--token-budget", type=int, default=256)
    ap.add_argument("--tbt-slo", type=float, default=0.1)
    ap.add_argument("--max-len", type=int, default=1024)
    ap.add_argument("--max-slots", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paged", dest="paged", action="store_true",
                    default=True, help="paged-KV execution (default)")
    ap.add_argument("--no-paged", dest="paged", action="store_false",
                    help="slab-KV oracle mode")
    ap.add_argument("--page-size", type=int, default=DEFAULT_PAGE_SIZE)
    ap.add_argument("--kv-pool-tokens", type=int, default=None,
                    help="device page-pool size in tokens "
                         "(default: max_slots * max_len)")
    ap.add_argument("--attn-kernel", action="store_true",
                    help="route decode and duet attention through the CUDA "
                         "kernels (plain PyTorch versions on the CPU; with "
                         "--no-paged the slab duet_attention kernel); the "
                         "summary reports the executed path as kernel_path "
                         "(cuda or torch)")
    ap.add_argument("--split-kv-threshold", type=int, default=None,
                    help="block-table capacity (tokens) above which the "
                         "kernel path decodes with the split-KV kernel "
                         "(default: priced from the roofline; 0 disables "
                         "splitting)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: one process a rank, "
                         "every arch the engines serve; with --dp, the "
                         "ranks of every replica")
    ap.add_argument("--share-card", action="store_true",
                    help="--tp > 1 on CUDA: every rank on card 0, over "
                         "gloo (its collectives copy through host memory); "
                         "--dp > 1 on CUDA: every replica on card 0, "
                         "sharing one weight tree")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel replica count: dp > 1 serves N "
                         "real engine replicas behind the cluster router "
                         "from this process, each with its own paged KV "
                         "pool and prefix cache; on CUDA one card a "
                         "replica's rank, or --share-card")
    # elastic data-parallelism: the active replica set breathes between
    # --min-dp and --max-dp against measured outstanding tokens; a drained
    # replica requeues its work via the preempt->recompute path
    ap.add_argument("--elastic", action="store_true",
                    help="scale the active replica set against load: "
                         "--max-dp replicas are built but dispatch starts "
                         "at --min-dp; scale decisions print as JSONL "
                         "'scale' events under --stream")
    ap.add_argument("--min-dp", type=int, default=1,
                    help="initial/minimum active replicas (--elastic)")
    ap.add_argument("--max-dp", type=int, default=None,
                    help="maximum replicas (--elastic; default: --dp, or 2 "
                         "when --dp is 1)")
    ap.add_argument("--scale-up-tokens", type=int, default=512,
                    help="scale up when mean outstanding tokens per active "
                         "replica exceed this (--elastic)")
    ap.add_argument("--scale-down-tokens", type=int, default=64,
                    help="scale down when the cluster total fits under "
                         "this per replica with one fewer (--elastic)")
    ap.add_argument("--scale-cooldown", type=float, default=0.5,
                    help="minimum virtual seconds between scale actions")
    ap.add_argument("--scale-interval", type=float, default=0.25,
                    help="drain-phase control-tick grid in virtual seconds")
    # stochastic load generation (serving/loadgen.py): any non-default
    # selection switches trace synthesis from synth_trace to the seeded
    # open-loop generator
    ap.add_argument("--arrival", choices=list(ARRIVAL_PROCESSES),
                    default="poisson",
                    help="arrival process: poisson, or mmpp (2-state "
                         "Markov-modulated bursts at the same mean rate)")
    ap.add_argument("--service-mix", choices=list(SERVICE_MIXES),
                    default="lognormal",
                    help="request-length mix: the trace's lognormal, or a "
                         "two-point mixture with a heavy tail at the same "
                         "mean")
    ap.add_argument("--rho", type=float, default=None,
                    help="target utilisation: sets qps to rho * k / E[S] "
                         "using the roofline per-request cost estimate "
                         "(overrides --qps)")
    ap.add_argument("--router-policy", choices=list(ROUTER_POLICIES),
                    default="round-robin",
                    help="dispatch policy for --dp > 1: round-robin "
                         "(ClusterSim parity oracle), least-loaded "
                         "(fewest outstanding tokens), or prefix "
                         "(longest cached prompt prefix, tie-break on "
                         "load)")
    # copy-on-write prefix caching (paged mode only; default: follow
    # --paged, so --no-paged alone never warns about a flag nobody passed)
    ap.add_argument("--prefix-cache", dest="prefix_cache",
                    action="store_true", default=None,
                    help="share prompt-prefix KV pages across requests "
                         "(default in paged mode)")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false",
                    help="disable prefix sharing (cold-cache baseline)")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="prepend a common system prompt of this many "
                         "tokens to every trace request")
    ap.add_argument("--shared-prefix-every", type=int, default=1,
                    metavar="N",
                    help="apply the shared prefix to every Nth request "
                         "only (default 1 = all)")
    ap.add_argument("--host-kv-tokens", type=int, default=0,
                    help="host-DRAM demotion tier capacity in tokens "
                         "(0 = eviction-only; requires the prefix cache)")
    ap.add_argument("--kv-quant", choices=list(KV_QUANT_MODES),
                    default="none",
                    help="storage format of host-tier pages")
    ap.add_argument("--clamp", dest="clamp", action="store_true",
                    default=True,
                    help="clamp trace lengths into the engine capacity "
                         "(default; a warning reports every truncation)")
    ap.add_argument("--no-clamp", dest="clamp", action="store_false",
                    help="submit trace lengths unmodified; oversized "
                         "requests get explicit REJECTED outcomes")
    ap.add_argument("--stream", action="store_true",
                    help="serve with AsyncDuetEngine and print per-token "
                         "events as JSON lines")
    return ap


def _elastic_geometry(args):
    """(replica count, ElasticConfig or None), as the reference's serve:
    elastic builds --max-dp replicas and dispatch starts at --min-dp."""
    if not args.elastic:
        if args.max_dp is not None or args.min_dp != 1:
            _warn("--min-dp/--max-dp only apply with --elastic; ignored")
        return args.dp, None
    dp = args.max_dp or max(args.dp, 2)
    if args.dp > 1 and dp != args.dp:
        raise SystemExit("--max-dp contradicts --dp; pass one of them")
    return dp, ElasticConfig(
        min_replicas=args.min_dp, max_replicas=dp,
        scale_up_tokens=args.scale_up_tokens,
        scale_down_tokens=args.scale_down_tokens,
        cooldown_s=args.scale_cooldown,
        check_interval=args.scale_interval)


def _trace(args, cfg, dp: int, hw):
    """The trace: the seeded open-loop generator when any stochastic load
    knob is non-default, ``synth_trace`` otherwise. ``--rho`` prices a
    request's E[S] with ``hw``, the spec the engines plan with
    (``device_pricing``), over a replica's units."""
    if (args.arrival == "poisson" and args.service_mix == "lognormal"
            and args.rho is None):
        return synth_trace(args.trace, args.num_requests, args.qps,
                           seed=args.seed)
    qps = args.qps
    service = ServiceSpec(trace=TRACES[args.trace], mix=args.service_mix)
    if args.rho is not None:
        cost = request_cost(cfg, service, hw,
                            units=max(1, args.tp) * hw.units_per_device,
                            tp=args.tp, token_budget=args.token_budget)
        qps = qps_for_rho(args.rho, cost, replicas=dp)
        _warn(f"rho={args.rho}: roofline E[S]={cost:.4f}s -> "
              f"qps={qps:.3f} over {dp} replica(s)")
    spec = LoadSpec(arrival=ArrivalSpec(process=args.arrival, qps=qps),
                    service=service, seed=args.seed)
    return LoadGenerator(spec).generate(args.num_requests)


def _apply_shared_prefix(reqs, prefix_len: int, vocab_size: int, seed: int,
                         every: int = 1):
    """Prepend one common system prompt to every `every`-th request (the
    body comes from the same rid-seeded derivation the engine uses)."""
    if prefix_len <= 0:
        return reqs
    if every < 1:
        raise SystemExit("--shared-prefix-every must be >= 1")
    common = np.random.default_rng(10_000 + seed).integers(
        0, vocab_size, prefix_len).astype(np.int32)
    for r in reqs:
        if r.rid % every:
            continue
        body = synth_prompt_tokens(r.rid, vocab_size, r.prompt_len)
        r.prompt_tokens = np.concatenate([common, body])
        r.prompt_len += prefix_len
    return reqs


def _clamp_lengths(reqs, max_len: int, clamp: bool):
    """Fit trace lengths to the engine, loudly. Returns the request list."""
    p_cap, o_cap = max_len // 2, max_len // 4
    over = [r for r in reqs
            if r.prompt_len > p_cap or r.output_len > o_cap]
    if not over:
        return reqs
    if clamp:
        _warn(f"{len(over)}/{len(reqs)} trace requests exceed --max-len "
              f"{max_len} (prompt cap {p_cap}, output cap {o_cap}); "
              "clamping lengths — pass --no-clamp to reject them instead")
        for r in over:
            r.prompt_len = min(r.prompt_len, p_cap)
            r.output_len = min(r.output_len, o_cap)
            if r.prompt_tokens is not None:
                r.prompt_tokens = r.prompt_tokens[:r.prompt_len]
    else:
        _warn(f"{len(over)}/{len(reqs)} trace requests exceed --max-len "
              f"{max_len}; submitting unmodified — the engine will record "
              "REJECTED outcomes for footprints beyond its KV capacity")
    return reqs


def describe_device(device: torch.device) -> dict:
    """The device a rank runs on."""
    out = {"type": device.type, "count": 1}
    if device.type == "cuda":
        out["name"] = torch.cuda.get_device_name(device)
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.tp <= 1:
        serve(None, args)
        return
    if args.device not in (None, "cpu", "cuda"):
        raise SystemExit("--tp > 1 places its ranks itself; pass --device "
                         "cpu or cuda")
    streams = run_ranks(serve, args.tp, device=args.device or "cuda",
                        share_card=args.share_card, args=(args,))
    if any(s != streams[0] for s in streams[1:]):
        raise SystemExit(f"the {args.tp} ranks produced different token "
                         "streams")


def serve(rank, args):
    """Serve the trace on one device or on ``--dp`` replicas behind the
    router (``rank`` None), or as one rank of a TP group
    (``launch.mesh.Rank``), which with ``--dp`` holds its rank of every
    replica; only rank 0 prints. Returns the token streams."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    dp, elastic_cfg = _elastic_geometry(args)
    if rank is not None:
        ctx = rank.context(cfg, dp=dp, share_card=args.share_card)
    elif dp > 1:
        ctx = DeviceContext.for_replicas(cfg, dp, args.device,
                                         share_card=args.share_card)
    else:
        ctx = DeviceContext.single(cfg, args.device)
    device = ctx.device
    out_rank = ctx.rank == 0

    def emit(obj, **kw):
        if out_rank:
            print(json.dumps(obj, **kw), flush=True)

    # weights and KV in bf16 on the card, fp32 on the CPU
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = Model.init(cfg, seed=args.seed, dtype=dtype, ctx=ctx,
                       attn_kernel=args.attn_kernel)

    reqs = _trace(args, cfg, dp, device_pricing(device, ctx))
    reqs = _apply_shared_prefix(reqs, args.shared_prefix_len,
                                cfg.vocab_size, args.seed,
                                every=args.shared_prefix_every)
    reqs = _clamp_lengths(reqs, args.max_len, args.clamp)

    if args.prefix_cache and not args.paged and out_rank:
        # only reachable when --prefix-cache was passed explicitly
        _warn("--prefix-cache requires paged KV; running without it")
    prefix_cache = args.paged if args.prefix_cache is None \
        else args.prefix_cache
    if args.host_kv_tokens > 0 and not (args.paged and prefix_cache) \
            and out_rank:
        _warn("--host-kv-tokens requires paged KV with the prefix cache; "
              "running without the host tier")
    ec = EngineConfig(
        max_slots=args.max_slots, max_len=args.max_len,
        token_budget=args.token_budget, tbt_slo=args.tbt_slo,
        paged=args.paged, page_size=args.page_size,
        kv_pool_tokens=args.kv_pool_tokens,
        prefix_cache=prefix_cache,
        host_kv_tokens=args.host_kv_tokens, kv_quant=args.kv_quant,
        temperature=args.temperature,
        split_kv_threshold=args.split_kv_threshold,
        strict_kernel=args.attn_kernel and not args.clamp)
    if args.split_kv_threshold is not None and not (
            args.attn_kernel and args.paged) and out_rank:
        _warn("--split-kv-threshold only applies to paged serving with "
              "--attn-kernel; ignored")

    def print_event(ev):
        if isinstance(ev, TokenEvent):
            emit({"event": "token", "rid": ev.rid, "index": ev.index,
                  "token": ev.token, "t": round(ev.t, 6)})
        elif isinstance(ev, FinishEvent):
            emit({"event": "finish", "rid": ev.rid, "reason": ev.reason,
                  "n_tokens": ev.n_tokens, "t": round(ev.t, 6)})
        elif isinstance(ev, RouterEvent):
            emit({"event": "router", "rid": ev.rid, "replica": ev.replica,
                  "policy": ev.policy, "matched_tokens": ev.matched_tokens,
                  "outstanding": list(ev.outstanding),
                  "t": round(ev.t, 6)})
        elif isinstance(ev, ScaleEvent):
            emit({"event": "scale", "action": ev.action,
                  "replica": ev.replica, "active": list(ev.active),
                  "outstanding": list(ev.outstanding),
                  "requeued": ev.requeued, "t": round(ev.t, 6)})

    if dp > 1:
        # cluster path: dp real replicas behind the dispatch policy; the
        # router drives sync or async replicas on the shared virtual clock
        router = Router(model, ec, ctx=ctx, policy=args.router_policy,
                        engine_cls=AsyncDuetEngine if args.stream
                        else DuetEngine,
                        seed=args.seed, elastic=elastic_cfg)
        router.submit(reqs)
        metrics = router.run(on_event=print_event if args.stream else None)
        engines = router.engines
    else:
        engine = (AsyncDuetEngine if args.stream else DuetEngine)(
            model, ec, seed=args.seed, device=device)
        engine.submit(reqs)   # async: arrivals replay on the inbox
        if args.stream:
            for ev in engine.events():
                print_event(ev)
        metrics = engine.run()   # after events(): collects metrics only
        engines = [engine]
    pc = None
    if args.paged:
        # under DP the cluster aggregate; each replica's own stats are
        # under out["per_replica"]
        pc = router.prefix_stats() if dp > 1 \
            else engine.kv_mgr.prefix_stats()
        pc.pop("per_replica", None)
    if args.stream:
        # the executed geometry and the predicted collective count ride the
        # stream next to the prefix-cache outcome
        emit({"event": "mesh", **ctx.describe(),
              "device": describe_device(device),
              "kernel_path": engines[0].kernel_path,
              "collectives_per_iteration": ctx.collectives_per_iteration()})
        if pc is not None:
            emit({"event": "prefix_cache", **pc})
    if dp > 1:
        out = router.summary()
    else:
        out = metrics.summary()
        out["slo_attainment"] = metrics.slo_attainment(args.tbt_slo)
        out["duet_fraction"] = engine.mux.stats.duet_fraction
        out["iterations"] = engine.mux.stats.iterations
    if args.stream:
        stats = [dataclasses.asdict(e.dstats) for e in engines]
        out["dispatch_stats"] = stats if dp > 1 else stats[0]
    out["device"] = describe_device(device)
    out["mesh"] = ctx.describe()
    out["kernel_path"] = engines[0].kernel_path
    out["collectives_per_iteration"] = ctx.collectives_per_iteration()
    if pc is not None:
        out["prefix_cache"] = pc
    emit(out, indent=2)
    return {r.rid: list(r.output_tokens) for r in metrics.requests}

if __name__ == "__main__":
    main()
