"""Mixture-of-Experts FFN with capacity-based token dispatch.

Router (as the reference's ``repro.models.moe``): softmax over experts in
fp32, top-k, renormalised gates, capacity
C = ceil(T · k / E · capacity_factor) per routing group; a choice's rank
within its expert counts slot-major (every token's first choice ranks
before any token's second) and then in token order, and choices ranked at
or past C are dropped (their combine weight is zero).

The reference's default dispatch is dense one-hot einsums (shardable under
SPMD); the port dispatches in index form — the reference's ``scatter``
variant, which its tests hold to the einsum form: kept tokens are added
into an (E, C, D) buffer, the experts run as batched matmuls against
their (E, D, F) weights, and each token gathers its k outputs back. Both
give the same kept and dropped choices and the same gates.

Routing is not row-local: a token's capacity and rank depend on every row
of its group, so a caller must route the same rows in the same order as
the reference does (a decode step's every slot, a prefill chunk's rows).

Tensor parallelism (``ctx``): the router stays whole, so every rank
routes every token over all E experts with the global capacity and makes
the same choices and drops as one device. Cut on ``experts``, a rank
holds a contiguous E/tp of them and runs only the choices that landed
there (the others add zero); cut on ``moe_ffn``, it runs every expert on
its share of F. Either way its output is a partial sum; a shared expert
cut on ``ffn`` joins it, and the MoE's one all-reduce sums them. A
shared expert that stays whole is added after that all-reduce. For
autograd the cut MoE is a sharded region: its input and the whole router
enter through ``ctx.copy_to_model``, so their gradients, each rank's
share, sum over the ranks.

Data parallelism: routing groups are ``min(MOE_GROUP_SIZE, T)`` rows of
the tokens a rank holds, so a data-parallel rank with fewer tokens than
the whole batch routes in smaller groups, and its capacity drops differ
from one device's over the whole batch. DP training matches one device
only where each rank's tokens are whole groups of the whole batch's (e.g.
2 sequences of 1024 predicted tokens over 2 data ranks).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import activation_fn, gated_mlp

MOE_GROUP_SIZE = 1024  # routing-group size (the reference's); groups of a
# longer sequence are routed independently, the last one zero-padded


def _capacity(tokens: int, num_experts: int, top_k: int, cf: float) -> int:
    return max(1, int(-(-tokens * top_k * cf // num_experts)))  # ceil


def _top_k(probs: torch.Tensor, top_k: int):
    """Top-k over the last axis with ties to the lower index (as
    ``lax.top_k``): a zero-padded row's uniform probabilities pick experts
    0..k-1, and those picks take capacity from the rows after them."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :top_k], idx[..., :top_k]


def _gates_and_ranks(router_logits: torch.Tensor, top_k: int):
    """router_logits (..., T, E) -> renormalised gates (..., T, k), the
    chosen experts (..., T, k) and each choice's rank within its expert
    (..., T, k), counted slot-major then in token order."""
    *lead, T, E = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    gate_vals, gate_idx = _top_k(probs, top_k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    sel = F.one_hot(gate_idx.transpose(-1, -2), E)          # (..., k, T, E)
    flat = sel.reshape(*lead, top_k * T, E)
    ranks = (flat.cumsum(dim=-2) - flat).reshape(sel.shape)
    rank_of_choice = (ranks * sel).sum(dim=-1).transpose(-1, -2)
    return gate_vals, gate_idx, rank_of_choice


def route(router_logits: torch.Tensor, top_k: int, capacity: int):
    """router_logits (T, E) -> dispatch (T, E, C) bool, combine (T, E, C)
    fp32: the reference's one-hot form, for its tests (the port's FFN
    dispatches through :func:`route_indices`)."""
    T, E = router_logits.shape
    gate_vals, gate_idx, rank = _gates_and_ranks(router_logits, top_k)
    keep = rank < capacity                                   # (T, k)
    pos = F.one_hot(rank.clamp(max=capacity - 1), capacity).float() \
        * keep[..., None]                                    # (T, k, C)
    disp_k = F.one_hot(gate_idx, E).float()[..., None] * pos[:, :, None, :]
    dispatch = disp_k.sum(dim=1)                             # (T, E, C)
    combine = torch.einsum("tk,tkec->tec", gate_vals, disp_k)
    return dispatch > 0, combine


def route_indices(router_logits: torch.Tensor, top_k: int, capacity: int):
    """Index-form routing: (..., T, E) logits -> gate_vals (..., T, k),
    slot ids (..., T, k) into a flat (E * capacity) buffer, and the keep
    mask (..., T, k). A dropped choice's slot id is clamped into its
    expert's last slot; its keep is False."""
    gate_vals, gate_idx, rank = _gates_and_ranks(router_logits, top_k)
    keep = rank < capacity
    sid = gate_idx * capacity + rank.clamp(max=capacity - 1)
    return gate_vals, sid, keep


def moe_ffn(params, cfg: ArchConfig, x: torch.Tensor,
            ctx=None) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D). params: router (D, E), experts
    w_gate/w_up (E, D, F) and w_down (E, F, D), optional shared expert MLP
    (run over every token). The B·S rows are routed in groups of
    ``MOE_GROUP_SIZE`` in row order; padded experts (past
    ``num_experts_routed``) are never chosen. Under a TP ``ctx`` the
    expert weights are the rank's (module docstring); the widths come from
    their shapes."""
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    E, k = cfg.num_experts, cfg.moe_top_k
    El, Fl = params["w_gate"].shape[0], params["w_gate"].shape[2]
    cut = El < E or Fl < cfg.moe_d_ff        # y is the rank's partial sum
    router = params["router"]
    if cut:
        # the sharded region: its input, and the whole router its rank's
        # experts read, enter through copy_to_model
        xf, router = ctx.copy_to_model(xf), ctx.copy_to_model(router)

    Tg = min(MOE_GROUP_SIZE, T)
    pad = (-T) % Tg
    xg = F.pad(xf, (0, 0, 0, pad)) if pad else xf
    G = xg.shape[0] // Tg
    xg = xg.reshape(G, Tg, D)
    E_active = cfg.num_experts_routed or E
    C = _capacity(Tg, E_active, k, cfg.capacity_factor)

    logits = torch.einsum("gtd,de->gte", xg, router)
    if cfg.num_experts_routed and cfg.num_experts_routed < E:
        pad_mask = torch.arange(E, device=x.device) >= cfg.num_experts_routed
        logits = logits.masked_fill(pad_mask, -1e30)
    gate_vals, sid, keep = route_indices(logits, k, C)       # (G, Tg, k)
    if El < E:
        # the rank's experts [lo, lo + El): only their choices land in its
        # (El, C) slots; the rest are dropped here and kept by their rank
        lo = ctx.rank * El * C
        keep = keep & (sid >= lo) & (sid < lo + El * C)
        sid = (sid - lo).clamp(0, El * C - 1)

    # dispatch: each kept choice lands alone in its (expert, rank) slot;
    # dropped choices add zeros into a slot they share
    flat_sid = (sid + (torch.arange(G, device=x.device) * (El * C))[:, None,
                                                                  None])
    src = (xg[:, :, None, :] * keep[..., None].to(xg.dtype)).reshape(-1, D)
    expert_in = xg.new_zeros((G * El * C, D)).index_add_(
        0, flat_sid.reshape(-1), src)
    # (G, E, C, D) -> (E, G*C, D): one batched matmul per weight
    xin = expert_in.reshape(G, El, C, D).transpose(0, 1) \
        .reshape(El, G * C, D)
    act = activation_fn(cfg.activation)
    h = act(torch.bmm(xin, params["w_gate"])) * torch.bmm(xin, params["w_up"])
    out = torch.bmm(h, params["w_down"])                     # (E, G*C, D)
    out = out.reshape(El, G, C, D).transpose(0, 1).reshape(G * El * C, D)
    gathered = out.index_select(0, flat_sid.reshape(-1)).reshape(G, Tg, k, D)
    w = (gate_vals * keep).to(xg.dtype)
    y = torch.einsum("gtk,gtkd->gtd", w, gathered).reshape(-1, D)[:T]

    shared = None
    if "shared" in params:
        if cut and ctx.sharded("ffn"):
            # both partial: the one all-reduce below sums them together
            y = y + gated_mlp(params["shared"], xf, cfg.activation)
        else:
            # whole, or its own sharded region: from the block's input
            shared = gated_mlp(params["shared"], x.reshape(T, D),
                               cfg.activation, ctx)
    if cut:
        y = ctx.reduce_from_model(y)
    if shared is not None:
        y = y + shared
    return y.reshape(B, S, D)


def load_balance_loss(router_logits: torch.Tensor,
                      top_k: int) -> torch.Tensor:
    """Switch-style auxiliary load-balancing loss (mean fraction · mean
    prob) over router_logits (T, E)."""
    T, E = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    _, idx = _top_k(probs, top_k)
    frac = F.one_hot(idx, E).float().mean(dim=(0, 1))
    return E * torch.sum(frac * probs.mean(dim=0))
