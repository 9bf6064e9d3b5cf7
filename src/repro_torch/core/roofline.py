"""Attention-aware roofline analytical model (paper §4.1).

Operators are classed exactly as in the paper:

  * token-level   — cost depends only on the total scheduled token count n
                    (linear projections, norms, activations, MoE experts)
  * sequence-level— cost depends on each request's (q, c) = scheduled query
                    tokens / cached context tokens (attention; and — beyond
                    the paper — SSM scan / recurrent-state operators so the
                    model covers the assigned SSM/hybrid/xLSTM families)
  * communication — tensor-parallel AllReduce, ring formulation (paper
                    eq. t_allreduce)

Latency of an operator on a partition of ``u`` units is
``max(F / Pi(u), B / Bw(u))``; per-request attention terms are summed over the
batch (the paper's t_attn).

What is priced: the engines on a CUDA card price that card
(:func:`card_spec`): its TPCs (two SMs each) are the partition units, the
datasheet's bf16 peak and HBM rate are spread over them, and the
multiplexer reads B(S) from the card's own measured curve
(``core.device.partition_curves``: superlinear over SMs, paper Fig. 3a)
and Pi(S) linear in SMs. ``TPU_V5E`` (a unit is a chip with its own HBM,
so both curves are linear) and ``H100_LIKE`` are the reference's specs,
kept as they are: the CPU engines price ``TPU_V5E``, as the reference
does, so their virtual clocks equal its.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Iterable, Literal, Optional

import numpy as np

from repro_torch.configs.base import GQA_KINDS, MLA_KINDS, ArchConfig

Phase = Literal["prefill", "decode"]


# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float          # per unit (chip), bf16 FLOP/s
    hbm_bw: float              # per unit, bytes/s
    ici_bw: float              # per link, bytes/s
    ici_links: int = 2         # effective links per chip for a ring
    num_units: int = 256       # partitionable units (chips per pod)
    alpha: float = 1e-6        # collective startup latency (s)
    # bandwidth scaling exponent over units: 1.0 = linear (TPU chips own
    # their HBM). GPU SMs sharing one HBM show superlinear utilisation at
    # small partitions — modelled as u^gamma normalised, used only by the
    # Fig. 3 reproduction benchmark.
    bw_gamma: float = 1.0
    # units one device holds: 1 where a device is one unit (a TPU chip;
    # below it the engines partition kernel-grid slots), the TPCs of a
    # GPU card from card_spec (an engine's replica spans its devices'
    # units)
    units_per_device: int = 1

    def pi(self, units: float) -> float:
        return self.peak_flops * units

    def bw(self, units: float) -> float:
        if self.bw_gamma == 1.0:
            return self.hbm_bw * units
        n = self.num_units
        return self.hbm_bw * n * (units / n) ** self.bw_gamma


TPU_V5E = HardwareSpec("tpu_v5e", peak_flops=197e12, hbm_bw=819e9,
                       ici_bw=50e9, ici_links=2, num_units=256)
# GPU-regime spec (PER-TPC values; 66 TPCs per H100). The superlinear
# bandwidth curve (bw_gamma<1: 20% of SMs reach ~60% of peak bandwidth,
# paper Fig. 3a) is what makes SM-partitioned co-execution a net throughput
# win on GPUs; used for the paper-faithful GPU-regime validation
# (EXPERIMENTS.md) and the Fig. 3 reproduction.
H100_LIKE = HardwareSpec("h100_like", peak_flops=989e12 / 66,
                         hbm_bw=3.35e12 / 66,
                         ici_bw=450e9, ici_links=1, num_units=66,
                         alpha=3e-6, bw_gamma=0.32)


# datasheet values of the cards the port prices, by the card's name
# (torch.cuda.get_device_properties(...).name, as nvidia-smi gives it): dense bf16 tensor-core FLOP/s and HBM bytes/s of the whole card
# (NVIDIA's H100 datasheet, SXM5 80 GB part)
CARD_DATASHEET = {
    "NVIDIA H100 80GB HBM3": (989.4e12, 3.35e12),
}


def card_spec(props) -> HardwareSpec:
    """The :class:`HardwareSpec` of a CUDA card from its device properties
    (duck-typed: ``.name``, ``.multi_processor_count``; the object
    ``torch.cuda.get_device_properties`` returns). Its units are TPCs
    (SMs / 2: 66 on the H100 SXM); the datasheet's peak FLOP/s and HBM
    bytes/s are spread evenly over them; the NVLink terms are
    ``H100_LIKE``'s. A card missing from :data:`CARD_DATASHEET` raises:
    nothing falls back to another card's prices."""
    if props.name not in CARD_DATASHEET:
        raise ValueError(
            f"no datasheet values for the card {props.name!r} (known: "
            f"{sorted(CARD_DATASHEET)}); add its dense bf16 FLOP/s and "
            "HBM bytes/s to roofline.CARD_DATASHEET")
    flops, hbm = CARD_DATASHEET[props.name]
    tpcs = props.multi_processor_count // 2
    return HardwareSpec(props.name, peak_flops=flops / tpcs,
                        hbm_bw=hbm / tpcs, ici_bw=H100_LIKE.ici_bw,
                        ici_links=H100_LIKE.ici_links, num_units=tpcs,
                        alpha=H100_LIKE.alpha, units_per_device=tpcs)


@dataclass(frozen=True)
class RequestLoad:
    """One scheduled request's contribution to the iteration."""
    q: int               # scheduled query tokens this iteration
    c: int               # cached context tokens before this iteration
    phase: Phase = "decode"


# ---------------------------------------------------------------------------
@dataclass
class OpCost:
    flops: float = 0.0
    bytes: float = 0.0

    def __iadd__(self, other: "OpCost"):
        self.flops += other.flops
        self.bytes += other.bytes
        return self

    def time(self, pi: float, bw: float) -> float:
        t_c = self.flops / pi if pi else 0.0
        t_m = self.bytes / bw if bw else 0.0
        return max(t_c, t_m)


def _linear(n: int, d_i: int, d_o: int, b: int) -> OpCost:
    """Paper token-level linear: F=2·n·di·do; B = n·di·b + di·do·b + n·do·b."""
    return OpCost(2.0 * n * d_i * d_o,
                  float(n * d_i * b + d_i * d_o * b + n * d_o * b))


def _elementwise(n: int, d: int, b: int, flops_per_elt: float = 8.0) -> OpCost:
    return OpCost(flops_per_elt * n * d, 2.0 * n * d * b)


# ---------------------------------------------------------------------------
class RooflineModel:
    """Per-iteration latency estimator for one architecture on one partition.

    ``tp``: tensor-parallel degree *within* the partition (the partition's
    units are split tp-ways for the model; the communication operator models
    the resulting AllReduces). ``units`` passed to estimates are the chips
    assigned to this phase (the paper's SM count S).
    """

    def __init__(self, cfg: ArchConfig, hw: HardwareSpec = TPU_V5E, *,
                 tp: int = 1, dtype_bytes: int = 2,
                 mla_absorb: bool = False,
                 sliding_window: Optional[int] = None,
                 page_size: int = 1, mesh=None,
                 kernel_path: Optional[str] = None):
        self.cfg = cfg
        self.hw = hw
        # ``mesh``: the jax.sharding.Mesh the engine actually executes on.
        # The ring-AllReduce communication term then prices the *executed*
        # TP geometry (model-axis size) rather than a hand-passed degree,
        # so the partition optimizer and the multiplexer cannot plan with
        # a different shape than the sharded programs run with.
        if mesh is not None:
            mesh_tp = int(mesh.shape.get("model", 1))
            if tp not in (1, mesh_tp):
                raise ValueError(
                    f"RooflineModel: tp={tp} contradicts the mesh's model "
                    f"axis ({mesh_tp}); pass one geometry, not two")
            tp = mesh_tp
        self.tp = tp
        self.b = dtype_bytes
        self.mla_absorb = mla_absorb
        self.sliding_window = sliding_window
        # paged-KV geometry: attention streams whole pages, so per-request
        # KV read traffic rounds the context up to a page multiple.
        # page_size=1 models contiguous (slab) KV exactly as before.
        self.page_size = max(1, page_size)
        # How attention executes. The jnp paged path gathers pages into a
        # dense slab before attending, so each cached byte moves ~3x (pool
        # read, slab write, slab read); the Pallas kernels stream each page
        # once. None prices like the kernels so existing virtual-clock
        # pins are unchanged.
        self.kernel_path = kernel_path
        self.kv_read_factor = 3.0 if kernel_path == "jnp" else 1.0

    def _page_pad(self, ctx: np.ndarray) -> np.ndarray:
        if self.page_size == 1:
            return ctx
        ps = float(self.page_size)
        return np.ceil(ctx / ps) * ps

    # ----------------------------------------------------------- token level
    def _block_token_cost(self, kind: str, n: int) -> OpCost:
        cfg, b = self.cfg, self.b
        D = cfg.d_model
        cost = OpCost()
        if kind in GQA_KINDS:
            H, G, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
            cost += _linear(n, D, (H + 2 * G) * dh, b)   # qkv
            cost += _linear(n, H * dh, D, b)             # out
        elif kind in MLA_KINDS:
            H = cfg.num_heads
            r, nope, rope, vd = (cfg.kv_lora_rank, cfg.qk_nope_dim,
                                 cfg.qk_rope_dim, cfg.v_head_dim)
            cost += _linear(n, D, H * (nope + rope), b)  # w_q
            cost += _linear(n, D, r + rope, b)           # w_dkv + w_krope
            if not self.mla_absorb:
                cost += _linear(n, r, H * (nope + vd), b)  # expand k,v (prefill)
            cost += _linear(n, H * vd, D, b)             # out
        elif kind == "mamba2":
            di, ns, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
            cost += _linear(n, D, 2 * di + 2 * ns + h, b)
            cost += _elementwise(n, di + 2 * ns, b, 2.0 * cfg.ssm_conv)
            cost += _linear(n, di, D, b)
        elif kind == "mlstm":
            di = int(cfg.mlstm_proj_factor * D)
            cost += _linear(n, D, 2 * di, b)
            cost += _elementwise(n, di, b, 2.0 * cfg.ssm_conv)
            cost += _linear(n, di, 3 * di + 2 * cfg.num_heads, b)  # qkv+gates
            cost += _linear(n, di, D, b)
        elif kind == "slstm":
            dh = D // cfg.num_heads
            f = int(round(D * 4 / 3 / 64)) * 64
            cost += _linear(n, D, 4 * D, b)              # input gates
            cost += _linear(n, dh, 4 * dh, b)            # recurrent (per head ≈)
            cost += _linear(n, D, 2 * f, b)              # gated FFN up
            cost += _linear(n, f, D, b)
        else:
            raise ValueError(kind)

        # FFN / MoE of transformer-style blocks
        if kind in ("attn", "mla", "shared_attn"):
            m = cfg.d_ff
            up = 2 if cfg.mlp_gated else 1
            cost += _linear(n, D, up * m, b)
            cost += _linear(n, m, D, b)
        elif kind in ("attn_moe", "mla_moe"):
            E, k, F = cfg.num_experts, cfg.moe_top_k, cfg.moe_d_ff
            cost += _linear(n, D, E, b)                  # router
            # each token passes through k experts (gate+up+down)
            cost.flops += 2.0 * n * k * D * 3 * F
            # weight traffic: every *touched* expert's weights stream once
            touched = min(E, n * k)
            cost.bytes += touched * 3.0 * D * F * self.b
            cost.bytes += 2.0 * n * k * (D + F) * self.b
            if cfg.num_shared_experts:
                Fs = cfg.num_shared_experts * F
                cost += _linear(n, D, 2 * Fs, b)
                cost += _linear(n, Fs, D, b)
        # norms
        cost += _elementwise(n, D, b, 8.0)
        return cost

    # -------------------------------------------------------- sequence level
    def _block_seq_cost_vec(self, kind: str, q: np.ndarray, c: np.ndarray):
        """Vectorised per-request (FLOPs, bytes) arrays for one block kind."""
        cfg, b = self.cfg, self.b
        q = q.astype(np.float64)
        c = c.astype(np.float64)
        if kind in GQA_KINDS:
            H, G, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
            ctx = q + c
            if self.sliding_window is not None:
                ctx = np.minimum(ctx, self.sliding_window + q)
            F = 4.0 * H * q * ctx * dh + 2.0 * H * q * ctx
            B = (2.0 * H * q * dh * b
                 + self.kv_read_factor * 2.0 * G * self._page_pad(ctx) * dh * b)
            return F, B
        if kind in MLA_KINDS:
            H = cfg.num_heads
            r, nope, rope, vd = (cfg.kv_lora_rank, cfg.qk_nope_dim,
                                 cfg.qk_rope_dim, cfg.v_head_dim)
            ctx = q + c
            ctx_rd = self._page_pad(ctx)
            if self.mla_absorb:
                F = (2.0 * H * q * r * nope + 2.0 * H * q * ctx * (r + rope)
                     + 2.0 * H * q * ctx * r + 2.0 * H * q * r * vd)
                B = ctx_rd * (r + rope) * b + 2.0 * H * q * (nope + rope) * b
            else:
                F = (2.0 * ctx * r * H * (nope + vd)
                     + 2.0 * H * q * ctx * (nope + rope + vd)
                     + 2.0 * H * q * ctx)
                B = ctx_rd * (r + rope) * b + 2.0 * H * ctx * (nope + vd) * b
            return F, B
        if kind == "mamba2":
            h, p, ns = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
            L = np.minimum(256, np.maximum(q, 1))
            F = np.where(q == 1, 6.0 * h * p * ns,
                         2.0 * h * q * L * (ns + p) + 6.0 * h * q * p * ns)
            B = np.where(q == 1, 8.0 * h * p * ns,
                         8.0 * h * p * ns * np.maximum(1, q // 256))
            return F, B
        if kind == "mlstm":
            h = cfg.num_heads
            dh = int(cfg.mlstm_proj_factor * cfg.d_model) // h
            L = np.minimum(256, np.maximum(q, 1))
            F = np.where(q == 1, 8.0 * h * dh * dh,
                         4.0 * h * q * L * dh + 4.0 * h * q * dh * dh)
            B = np.where(q == 1, 8.0 * h * dh * dh,
                         8.0 * h * dh * dh * np.maximum(1, q // 256))
            return F, B
        if kind == "slstm":
            F = 16.0 * q * cfg.d_model
            B = np.full_like(q, 16.0 * cfg.d_model)
            return F, B
        raise ValueError(kind)

    def _block_seq_cost(self, kind: str, q: int, c: int) -> OpCost:
        F, B = self._block_seq_cost_vec(kind, np.asarray([q]),
                                        np.asarray([c]))
        return OpCost(float(F[0]), float(B[0]))

    # -------------------------------------------------------- communication
    def _allreduce_time(self, n: int, units: float) -> float:
        """Paper eq. (ring AllReduce) with ICI bandwidth; per transformer
        block there are two AllReduces (attention out + FFN out)."""
        N = self.tp
        if N <= 1:
            return 0.0
        bytes_out = float(n * self.cfg.d_model * self.b)
        bw = self.hw.ici_bw * self.hw.ici_links
        t = (2 * (N - 1) * self.hw.alpha
             + 2 * (N - 1) * bytes_out / (N * bw)
             + (N - 1) * bytes_out / self.hw.bw(max(units / N, 1e-9)))
        return 2.0 * t  # two sync points per block

    # ------------------------------------------------------------- estimate
    def iteration_latency(self, requests: Iterable[RequestLoad],
                          units: Optional[float] = None) -> float:
        """Predicted latency (s) of one engine iteration running ``requests``
        on ``units`` chips (default: the full pod partition)."""
        reqs = list(requests)
        if not reqs:
            return 0.0
        units = float(units if units is not None else self.hw.num_units)
        per_shard_units = units / self.tp
        pi = self.hw.pi(per_shard_units) * self.tp   # model is tp-sharded
        bw = self.hw.bw(per_shard_units) * self.tp
        n = sum(r.q for r in reqs)
        q_arr = np.asarray([r.q for r in reqs])
        c_arr = np.asarray([r.c for r in reqs])

        total = 0.0
        for kind, count in Counter(self.cfg.block_pattern).items():
            tok = self._block_token_cost(kind, n)
            t_block = tok.time(pi, bw)
            F, B = self._block_seq_cost_vec(kind, q_arr, c_arr)
            t_block += float(np.sum(np.maximum(F / pi, B / bw)))
            t_block += self._allreduce_time(n, units)
            total += count * t_block
        # classifier (final linear over padded vocab)
        cls = _linear(n, self.cfg.d_model, self.cfg.padded_vocab, self.b)
        total += cls.time(pi, bw)
        return total

    # convenience wrappers -------------------------------------------------
    def prefill_latency(self, prompt: int, chunk: Optional[int] = None,
                        units: Optional[float] = None) -> float:
        """Full-prompt prefill latency, optionally chunked."""
        chunk = chunk or prompt
        t, done = 0.0, 0
        while done < prompt:
            q = min(chunk, prompt - done)
            t += self.iteration_latency(
                [RequestLoad(q=q, c=done, phase="prefill")], units)
            done += q
        return t

    def decode_latency(self, batch: int, context: int,
                       units: Optional[float] = None) -> float:
        reqs = [RequestLoad(q=1, c=context) for _ in range(batch)]
        return self.iteration_latency(reqs, units)

    def split_kv_threshold(self) -> int:
        """Context length (tokens) above which the flash-decoding split-KV
        kernel pays for its combine epilogue: the point where one request's
        per-layer KV read traffic reaches the layer's attention weight
        traffic, so the sequential page-chain walk — not weight streaming —
        bounds the decode grid and splitting the chain recovers parallelism.
        Rounded up to a page multiple; 0 if the pattern has no GQA blocks."""
        cfg, b = self.cfg, self.b
        if not any(k in GQA_KINDS for k in cfg.block_pattern):
            return 0
        D, dh = cfg.d_model, cfg.head_dim
        H, G = cfg.num_heads, cfg.num_kv_heads
        weight_bytes = (D * (H + 2 * G) * dh + H * dh * D) * b
        kv_bytes_per_token = 2.0 * G * dh * b
        ctx = weight_bytes / kv_bytes_per_token
        ps = self.page_size
        return int(-(-ctx // ps) * ps)

    def model_flops_per_token(self) -> float:
        """6·N_active·(approx) — used for the roofline 'useful FLOPs' ratio."""
        from repro_torch.models.params import count_params_analytical
        return 6.0 * count_params_analytical(self.cfg, active_only=True)
