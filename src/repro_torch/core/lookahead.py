"""Interruption-free look-ahead decode execution — paper §4.3.

The paper records decode into CUDA Graphs and replays k of them without
host synchronisation, with KV slots and metadata for all k steps
preallocated. The reference compiles each shape bucket's super-iteration
into one jitted program (the k-step loop a ``lax.scan``) and caches it.
Here :func:`make_superiter_fn` builds the program as a Python function
that enqueues the k steps and the prefill chunk without reading a device
value on the host, and :class:`BucketProgram` is one dispatch bucket of
the async engine: that program plus the static tensors it reads. On a
CUDA device the engine captures a bucket's program into a
``torch.cuda.CUDAGraph`` on its second dispatch (the first runs eagerly
and is the warm-up: the kernels are built, their occupancy queries
cached) and replays the graph on every later one: one host call a
super-iteration, the port's counterpart of the reference's jitted
program. So that a graph bakes in no value of one dispatch, the chunk's
start, its slot and the resume token are 0-d device tensors in the
bucket's static buffers, filled before each replay; the page pools, the
recurrent state and the decode inputs (``last_tok``, ``pos``) are read and
written in place.

What stays eager (``serving/async_engine.py`` counts each dispatch by its
rule): the slab path's chunk, whose slab views are cut at ``start + S``,
a shape that follows the host's start (the slab's decode-only buckets
are captured); every engine under a collective group (TP, CP, the grid:
gloo's all-reduces run on the host and cannot be captured); the
synchronous engine's k-step programs (:func:`make_lookahead_fn`,
:func:`make_paged_lookahead_fn`), which stay the eager oracle. The
planner half (slot preallocation) lives in the serving engine's KV
manager.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Optional

import numpy as np
import torch

from repro_torch.core.device import fill_from_host
from repro_torch.kernels import add_launch_counts, launch_counts
from repro_torch.models.attention import slot_gather, slot_scatter, slot_views

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
      active_mask: (B,) bool — inactive slots keep their token, position,
        slab row and recurrent state (retired slots must not corrupt the
        cache).

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
    """The k-step slab decode program (one per k, cached by the
    synchronous engine, which runs it eagerly)."""
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
      active_mask: (B,) bool — inactive slots keep their token, position
        and recurrent state (their attention writes land in the null page
        through all-zero table rows).

    Returns (tokens (B, k), pools, state, new_pos (B,)).
    """
    B = first_token.shape[0]
    if active_mask is None:
        active_mask = torch.ones((B,), dtype=torch.bool,
                                 device=first_token.device)
    tok, pos = first_token, start_pos
    toks = []
    for _ in range(k):
        logits, pools, state = model.decode_step_paged(
            pools, state, tok, pos, tables, active_mask=active_mask)
        nxt = _sample(logits, gen, temperature)[:, None]
        tok = torch.where(active_mask[:, None], nxt, tok)
        pos = torch.where(active_mask, pos + 1, pos)
        toks.append(tok[:, 0])
    return torch.stack(toks, dim=1), pools, state, pos


def make_paged_lookahead_fn(model: Model, k: int, *,
                            temperature: float = 0.0):
    """The k-step paged decode program (one per k, cached by the
    synchronous engine, which runs it eagerly)."""
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
# positions stay resident on device (`last_tok`/`pos`, updated in place by
# successive programs).
# ---------------------------------------------------------------------------
def _scalar(v, device) -> torch.Tensor:
    """A per-dispatch scalar as a 0-d int32 tensor on ``device``: a tensor
    as it is, a host int through a fill (a kernel argument, no copy and no
    sync)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.full((), v, dtype=torch.int32, device=device)


def _set_row(t: torch.Tensor, row, value) -> torch.Tensor:
    """Out-of-place ``t[row, ...] = value``: ``row`` a host int or a 0-d
    device tensor (a device scatter), ``value`` a host int or a 0-d device
    tensor — either way no host sync."""
    t = t.clone()
    if isinstance(row, torch.Tensor):
        value = _scalar(value, t.device).to(t.dtype)
        t.index_put_((row.reshape(1).long(),),
                     value.expand((1,) + t.shape[1:]))
    else:
        t[row] = value
    return t


def _store(buf: torch.Tensor, new: torch.Tensor):
    """End a program: its new decode inputs into the engine's buffer."""
    if new is not buf:
        buf.copy_(new)


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
                 pre_start, pre_slot, override_tok
                 [, order (T*duet_block_q,)])
      slab:  run(cache, last_tok, pos, gen, active, pre_toks, pre_start,
                 pre_slot, override_tok)
      both -> (toks (B,kb), sampled)

    ``pre_start``, ``pre_slot`` and ``override_tok`` are 0-d int32 device
    tensors (host ints are taken too); the slab chunk takes ``pre_start``
    and ``pre_slot`` as host ints, since its slab views are cut at
    ``pre_start + C``. The program updates ``last_tok``, ``pos``, the
    pools, the state (or the slab cache) and ``gen`` in place and returns
    only new tensors: what a captured graph replays has fixed addresses.
    ``sampled`` is the finishing prefill's next token (a 0-d device
    tensor) or None: the host fetches it together with ``toks`` in the
    single per-iteration sync. The chunk reads and writes only slot
    ``pre_slot``'s row of the recurrent state (``slot_gather`` /
    ``slot_scatter``; the slab's ``slot_views``).
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

    def _prefill_paged(pools, state, pre_toks, pre_tbl, pre_start,
                       pre_slot):
        rows = slot_gather(state, pre_slot)
        logits, _, _ = model.prefill_paged(pre_toks, pools, rows, pre_tbl,
                                           start_pos=pre_start)
        slot_scatter(state, rows, pre_slot)
        return logits

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
            pre_start, pre_slot, override_tok = (
                _scalar(v, dev) for v in (pre_start, pre_slot,
                                          override_tok))
            row_tok = torch.cat([last_tok[:, 0], pre_toks[0]])[:, None]
            row_pos = torch.cat([pos, pre_start + torch.arange(
                chunk, dtype=pos.dtype, device=dev)])
            W, Wp = tables.shape[1], pre_tbl.shape[1]
            Wm = max(W, Wp)
            pad = torch.nn.functional.pad
            row_tbl = torch.cat([
                pad(tables, (0, Wm - W)),
                pad(pre_tbl, (0, Wm - Wp)).expand(chunk, Wm)])
            logits, _, _ = model.duet_step_paged(
                pools, state, row_tok, row_pos, row_tbl, order,
                block_q=duet_block_q)
            # decode step 1 retires inside the duet launch
            nxt = _sample(logits[:B], gen, temperature)[:, None]
            nxt = torch.where(active[:, None], nxt, last_tok)
            new_pos = torch.where(active, pos + 1, pos)
            toks = nxt
            if kb > 1:
                rest, _, _, new_pos = lookahead_decode_paged(
                    model, pools, state, nxt, new_pos, tables, kb - 1,
                    gen=gen, temperature=temperature, active_mask=active)
                toks = torch.cat([nxt, rest], dim=1)
            new_tok = torch.where(active[:, None], toks[:, -1:], last_tok)
            # the chunk's last row carries the prefill logits
            sampled, new_tok, new_pos = _finish(
                logits[B + chunk - 1], new_tok, new_pos, pre_start,
                pre_slot, override_tok)
            _store(last_tok, new_tok)
            _store(pos, new_pos)
            return toks, sampled
        return fused

    if not paged:
        def fused_slab(cache, last_tok, pos, gen, active, pre_toks,
                       pre_start, pre_slot, override_tok):
            toks = torch.zeros((last_tok.shape[0], 0), dtype=torch.int32,
                               device=last_tok.device)
            sampled, new_tok, new_pos = None, last_tok, pos
            if kb > 0:
                toks, _, new_pos = lookahead_decode(
                    model, cache, last_tok, pos, kb, gen=gen,
                    temperature=temperature, active_mask=active)
                new_tok = torch.where(active[:, None], toks[:, -1:],
                                      last_tok)
            if chunk > 0:
                logits, _ = model.prefill(
                    pre_toks, cache=slot_views(cache, pre_slot),
                    start_pos=pre_start)
                sampled, new_tok, new_pos = _finish(
                    logits[0], new_tok, new_pos, pre_start, pre_slot,
                    override_tok)
            _store(last_tok, new_tok)
            _store(pos, new_pos)
            return toks, sampled
        return fused_slab

    def fused(pools, state, last_tok, pos, tables, gen, active, pre_toks,
              pre_tbl, pre_start, pre_slot, override_tok):
        dev = last_tok.device
        toks = torch.zeros((last_tok.shape[0], 0), dtype=torch.int32,
                           device=dev)
        sampled, new_tok, new_pos = None, last_tok, pos
        if kb > 0:
            toks, _, _, new_pos = lookahead_decode_paged(
                model, pools, state, last_tok, pos, tables, kb, gen=gen,
                temperature=temperature, active_mask=active)
            # feed the last generated token back as the next decode input;
            # the engine guarantees kb <= remaining output for every batch
            # member, so the final step is always a live token
            new_tok = torch.where(active[:, None], toks[:, -1:], last_tok)
        if chunk > 0:
            pre_start, pre_slot, override_tok = (
                _scalar(v, dev) for v in (pre_start, pre_slot,
                                          override_tok))
            logits = _prefill_paged(pools, state, pre_toks, pre_tbl,
                                    pre_start, pre_slot)
            sampled, new_tok, new_pos = _finish(
                logits[0], new_tok, new_pos, pre_start, pre_slot,
                override_tok)
        _store(last_tok, new_tok)
        _store(pos, new_pos)
        return toks, sampled
    return fused


# ---------------------------------------------------------------------------
# Dispatch buckets and their CUDA graphs
# ---------------------------------------------------------------------------
def graph_pool_bytes(pool) -> int:
    """Device bytes the caching allocator holds in CUDA graph memory pool
    ``pool`` (a ``torch.cuda.graph_pool_handle()``): its segments."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == tuple(pool))


class BucketProgram:
    """One dispatch bucket of the async engine: its super-iteration
    program (:func:`make_superiter_fn`) and the static tensors the program
    reads — the block tables (B, W), the active mask (B,), the chunk's
    tokens (1, C) and block table (1, Wp), and the per-dispatch scalars
    ``pre_start``, ``pre_slot``, ``override_tok`` (0-d int32 views of one
    buffer). :meth:`feed` fills them from host arrays through pinned
    staging (no wait on the device); :meth:`run` runs the program eagerly;
    on a CUDA device :meth:`capture` records it into a CUDA graph and
    :meth:`replay` launches that graph, one host call for the whole
    super-iteration. The arguments handed to :meth:`capture` must be the
    ones every later replay reads: the engine's pools, state, decode
    inputs and generator and this bucket's static tensors."""

    def __init__(self, fn, device: torch.device, slots: int, *,
                 width: int = 1, chunk: int = 0, pwidth: int = 1,
                 paged: bool = True):
        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=device)
        self.fn = fn
        self.tables = zeros(slots, width) if paged else None
        self.active = zeros(slots, dtype=torch.bool)
        self.pre_toks = zeros(1, chunk) if chunk else None
        self.pre_tbl = zeros(1, pwidth) if paged and chunk else None
        self.scalars = zeros(3)
        self.pre_start, self.pre_slot, self.override_tok = \
            self.scalars.unbind(0)
        self.runs = 0                 # eager runs
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None           # the graph's static outputs
        self.launches: Dict[str, int] = {}   # kernel launches a replay

    def feed(self, active, tables=None, pre_toks=None, pre_tbl=None,
             scalars=(0, 0, 0)):
        """Fill the static inputs for one dispatch from host arrays."""
        fill_from_host(self.active, active)
        for dst, arr in ((self.tables, tables), (self.pre_toks, pre_toks),
                         (self.pre_tbl, pre_tbl)):
            if dst is not None and arr is not None:
                fill_from_host(dst, arr)
        fill_from_host(self.scalars, np.asarray(scalars, np.int32))

    def run(self, *args):
        """One eager run of the program on ``args``."""
        self.runs += 1
        return self.fn(*args)

    def capture(self, args, pool, gen: Optional[torch.Generator] = None):
        """Capture the program on ``args`` into a CUDA graph in memory pool
        ``pool`` (a side stream, as ``torch.cuda.graph`` takes it; it
        synchronises the device first), then replay it once: this
        dispatch's outputs. ``gen`` is registered with the graph when the
        program samples from it. The kernel launches counted while
        capturing are what every later replay adds. Raises if capture
        fails; nothing runs eagerly in its place."""
        graph = torch.cuda.CUDAGraph()
        if gen is not None:
            graph.register_generator_state(gen)
        before = launch_counts()
        with torch.cuda.graph(graph, pool=pool):
            outputs = self.fn(*args)
        after = launch_counts()
        self.launches = {k: n - before[k] for k, n in after.items()
                         if n != before[k]}
        self.graph, self.outputs = graph, outputs
        graph.replay()
        return self._copies()

    def replay(self):
        """Replay the captured graph (its inputs fed): the outputs as new
        tensors, copied on the stream right after the replay, since the
        next replay of this graph overwrites its static outputs while the
        engine may not have fetched them yet."""
        self.graph.replay()
        add_launch_counts(self.launches)
        return self._copies()

    def _copies(self):
        toks, sampled = self.outputs
        return toks.clone(), None if sampled is None else sampled.clone()
