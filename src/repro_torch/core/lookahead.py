"""Interruption-free look-ahead decode execution — paper §4.3.

The paper records decode into CUDA Graphs and replays k of them without
host synchronisation, with KV slots and metadata for all k steps
preallocated. The reference compiles the k-step loop into one jitted
program; here a "program" is a Python closure that enqueues the k steps
eagerly: no step reads a device value on the host, so the host returns
before the device finishes and the engine syncs only when it fetches the
tokens. (CUDA Graph capture per dispatch bucket is later work.) The
planner half (slot preallocation) lives in the serving engine's KV
manager; this module provides the k-step decode program, the fused duet
super-iteration and greedy/temperature sampling inside the loop.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import torch

from repro_torch.models.attention import slot_views

if TYPE_CHECKING:   # the model imports core.device; no runtime cycle
    from repro_torch.models.transformer import Model


def _sample(logits: torch.Tensor, gen: Optional[torch.Generator],
            temperature: float) -> torch.Tensor:
    """Greedy at temperature 0, else Gumbel-max with noise from ``gen``
    (the reference draws it with jax.random, so only temperature 0 gives
    the reference's tokens)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    g = -torch.log(-torch.log(u + 1e-9) + 1e-9)
    return torch.argmax(logits.float() / temperature + g,
                        dim=-1).to(torch.int32)


def lookahead_decode(model: Model, cache, first_token: torch.Tensor,
                     start_pos: torch.Tensor, k: int, *,
                     gen: Optional[torch.Generator] = None,
                     temperature: float = 0.0, sliding: bool = False,
                     active_mask: Optional[torch.Tensor] = None):
    """k decode steps against the slab cache (updated in place) without a
    host sync.

    Args:
      first_token: (B, 1) int32 — token to feed at the first step.
      start_pos: (B,) int32 — cache position of the first step per request
        (continuous batching: requests sit at different depths).
      active_mask: (B,) bool — inactive slots keep their token, position
        and slab row (retired slots must not corrupt the cache).

    Returns (tokens (B, k), cache, new_pos (B,)).
    """
    B = first_token.shape[0]
    if active_mask is None:
        active_mask = torch.ones((B,), dtype=torch.bool,
                                 device=first_token.device)
    tok, pos = first_token, start_pos
    toks = []
    for _ in range(k):
        logits, cache = model.decode_step(cache, tok, pos, sliding=sliding,
                                          active_mask=active_mask)
        nxt = _sample(logits, gen, temperature)[:, None]
        tok = torch.where(active_mask[:, None], nxt, tok)
        pos = torch.where(active_mask, pos + 1, pos)
        toks.append(tok[:, 0])
    return torch.stack(toks, dim=1), cache, pos


def make_lookahead_fn(model: Model, k: int, *, temperature: float = 0.0,
                      sliding: bool = False):
    """The k-step slab decode program (one per k — the engine caches these
    as the paper caches one CUDA Graph per batch shape)."""
    def run(cache, first_token, start_pos, gen, active_mask):
        return lookahead_decode(model, cache, first_token, start_pos, k,
                                gen=gen, temperature=temperature,
                                sliding=sliding, active_mask=active_mask)
    return run


def lookahead_decode_paged(model: Model, pools, state,
                           first_token: torch.Tensor,
                           start_pos: torch.Tensor, tables: torch.Tensor,
                           k: int, *, gen: Optional[torch.Generator] = None,
                           temperature: float = 0.0,
                           active_mask: Optional[torch.Tensor] = None):
    """k decode steps against per-layer page pools with fixed block tables.
    The engine's look-ahead reservation guarantees every (page, slot)
    address touched by the k steps is already allocated, so ``tables``
    stays constant across the steps — the host never syncs mid-program.

    Args:
      first_token: (B, 1) int32 — token to feed at the first step.
      start_pos: (B,) int32 — cache position of the first step per request.
      active_mask: (B,) bool — inactive slots keep their token and position
        (their writes land in the null page through all-zero table rows).

    Returns (tokens (B, k), pools, state, new_pos (B,)).
    """
    B = first_token.shape[0]
    if active_mask is None:
        active_mask = torch.ones((B,), dtype=torch.bool,
                                 device=first_token.device)
    tok, pos = first_token, start_pos
    toks = []
    for _ in range(k):
        logits, pools, state = model.decode_step_paged(pools, state, tok,
                                                       pos, tables)
        nxt = _sample(logits, gen, temperature)[:, None]
        tok = torch.where(active_mask[:, None], nxt, tok)
        pos = torch.where(active_mask, pos + 1, pos)
        toks.append(tok[:, 0])
    return torch.stack(toks, dim=1), pools, state, pos


def make_paged_lookahead_fn(model: Model, k: int, *,
                            temperature: float = 0.0):
    """The k-step paged decode program (one per k — the engine caches
    these as the paper caches one CUDA Graph per batch shape)."""
    def run(pools, state, first_token, start_pos, tables, gen, active_mask):
        return lookahead_decode_paged(
            model, pools, state, first_token, start_pos, tables, k, gen=gen,
            temperature=temperature, active_mask=active_mask)
    return run


# ---------------------------------------------------------------------------
# Fused duet super-iteration (async engine): k look-ahead decode steps plus
# one prefill chunk in a SINGLE program. All sampling — including the first
# token of a finishing prefill — happens in-program, so the host never reads
# a device value to build the next dispatch; decode input tokens and
# positions stay resident on device (`last_tok`/`pos` threaded through
# successive programs).
# ---------------------------------------------------------------------------
def _set_row(t: torch.Tensor, row: int, value) -> torch.Tensor:
    """Out-of-place ``t[row, ...] = value`` (value a python int or a 0-d
    device tensor — either way no host sync)."""
    t = t.clone()
    t[row] = value
    return t


def make_superiter_fn(model: Model, kb: int, *, paged: bool = True,
                      chunk: int = 0, finish: bool = False,
                      sample: bool = False, temperature: float = 0.0,
                      duet_kernel: bool = False, duet_block_q: int = 1):
    """Build one fused duet super-iteration program.

    Bucket parameters (the engine's dispatch cache keys on them plus the
    argument shape buckets):

      kb      — look-ahead decode depth (0 = prefill-only dispatch)
      chunk   — prefill chunk length (0 = decode-only dispatch)
      finish  — this chunk completes the prompt: set the slot's position and
                decode input token in-program
      sample  — the finishing token is argmax-sampled from the chunk logits
                (False on preemption resume: the host already knows the next
                token and passes it as ``override_tok``)
      duet_kernel — decode step 1 and the chunk run as ONE duet attention
                launch per layer (paged only; needs kb > 0 and chunk > 0)
      duet_block_q — rows of one tile of that launch; ``order`` is the
                schedule's ``row_src`` built with it

    Signatures (B = engine slot count, W/Wp = block-table width buckets,
    C = chunk):

      paged: run(pools, state, last_tok (B,1), pos (B,), tables (B,W), gen,
                 active (B,), pre_toks (1,C), pre_tbl (1,Wp),
                 pre_start: int, pre_slot: int, override_tok: int
                 [, order (T*duet_block_q,)])
               -> (toks (B,kb), sampled, last_tok, pos, pools, state, gen)
      slab:  run(cache, last_tok, pos, gen, active, pre_toks, pre_start,
                 pre_slot, override_tok)
               -> (toks (B,kb), sampled, last_tok, pos, cache, gen)

    ``sampled`` is the finishing prefill's next token (a 0-d device tensor)
    or None: the host fetches it together with ``toks`` in the single
    per-iteration sync.
    """
    if kb == 0 and chunk == 0:
        raise ValueError("empty super-iteration")
    if duet_kernel and (not paged or kb == 0 or chunk == 0):
        raise ValueError("duet_kernel needs paged mode with both phases "
                         "(kb > 0 and chunk > 0)")

    def _finish(logits_row, last_tok, pos, pre_start, pre_slot,
                override_tok):
        sampled = None
        if finish:
            if sample:
                tok = torch.argmax(logits_row).to(torch.int32)
                sampled = tok
            else:
                tok = override_tok
            last_tok = _set_row(last_tok, pre_slot, tok)
            pos = _set_row(pos, pre_slot, pre_start + chunk)
        return sampled, last_tok, pos

    if duet_kernel:
        # Algorithm-1 fused launch: decode step 1 and the whole prefill
        # chunk execute as ONE duet_attention_paged launch per layer
        # (decode rows + chunk rows in tiles of duet_block_q rows,
        # interleaved by the `order` schedule); the remaining kb-1
        # look-ahead steps run as the usual k-step decode.
        def fused(pools, state, last_tok, pos, tables, gen, active,
                  pre_toks, pre_tbl, pre_start, pre_slot, override_tok,
                  order):
            B = last_tok.shape[0]
            dev = last_tok.device
            row_tok = torch.cat([last_tok[:, 0], pre_toks[0]])[:, None]
            row_pos = torch.cat([pos, pre_start + torch.arange(
                chunk, dtype=pos.dtype, device=dev)])
            W, Wp = tables.shape[1], pre_tbl.shape[1]
            Wm = max(W, Wp)
            pad = torch.nn.functional.pad
            row_tbl = torch.cat([
                pad(tables, (0, Wm - W)),
                pad(pre_tbl, (0, Wm - Wp)).expand(chunk, Wm)])
            logits, pools, state = model.duet_step_paged(
                pools, state, row_tok, row_pos, row_tbl, order,
                block_q=duet_block_q)
            # decode step 1 retires inside the duet launch
            nxt = _sample(logits[:B], gen, temperature)[:, None]
            nxt = torch.where(active[:, None], nxt, last_tok)
            pos = torch.where(active, pos + 1, pos)
            toks = nxt
            if kb > 1:
                rest, pools, state, pos = lookahead_decode_paged(
                    model, pools, state, nxt, pos, tables, kb - 1, gen=gen,
                    temperature=temperature, active_mask=active)
                toks = torch.cat([nxt, rest], dim=1)
            last_tok = torch.where(active[:, None], toks[:, -1:], last_tok)
            # the chunk's last row carries the prefill logits
            sampled, last_tok, pos = _finish(
                logits[B + chunk - 1], last_tok, pos, pre_start, pre_slot,
                override_tok)
            return toks, sampled, last_tok, pos, pools, state, gen
        return fused

    if not paged:
        def fused_slab(cache, last_tok, pos, gen, active, pre_toks,
                       pre_start, pre_slot, override_tok):
            toks = torch.zeros((last_tok.shape[0], 0), dtype=torch.int32,
                               device=last_tok.device)
            sampled = None
            if kb > 0:
                toks, cache, pos = lookahead_decode(
                    model, cache, last_tok, pos, kb, gen=gen,
                    temperature=temperature, active_mask=active)
                last_tok = torch.where(active[:, None], toks[:, -1:],
                                       last_tok)
            if chunk > 0:
                logits, _ = model.prefill(
                    pre_toks, cache=slot_views(cache, pre_slot),
                    start_pos=pre_start)
                sampled, last_tok, pos = _finish(
                    logits[0], last_tok, pos, pre_start, pre_slot,
                    override_tok)
            return toks, sampled, last_tok, pos, cache, gen
        return fused_slab

    def fused(pools, state, last_tok, pos, tables, gen, active, pre_toks,
              pre_tbl, pre_start, pre_slot, override_tok):
        toks = torch.zeros((last_tok.shape[0], 0), dtype=torch.int32,
                           device=last_tok.device)
        sampled = None
        if kb > 0:
            toks, pools, state, pos = lookahead_decode_paged(
                model, pools, state, last_tok, pos, tables, kb, gen=gen,
                temperature=temperature, active_mask=active)
            # feed the last generated token back as the next decode input;
            # the engine guarantees kb <= remaining output for every batch
            # member, so the final step is always a live token
            last_tok = torch.where(active[:, None], toks[:, -1:], last_tok)
        if chunk > 0:
            logits, pools, state = model.prefill_paged(
                pre_toks, pools, state, pre_tbl, start_pos=pre_start)
            sampled, last_tok, pos = _finish(
                logits[0], last_tok, pos, pre_start, pre_slot, override_tok)
        return toks, sampled, last_tok, pos, pools, state, gen
    return fused
