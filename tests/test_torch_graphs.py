"""The async engine's dispatch buckets, on the CPU: the static-buffer
programs that the engine captures into CUDA graphs on the card.

(a) One ``BucketProgram`` of each kind, fed through its static buffers,
is reused across dispatches with different chunk starts, slots and resume
tokens (and tables, active masks and decode inputs): its outputs, pools,
recurrent state and decode inputs are bitwise equal to a freshly built
program's, called with new tensors and the per-dispatch scalars as host
ints. A graph bakes in the addresses its capture saw, so a program that
kept any value of one dispatch would show it at the next.
(b) The async engine in its static-buffer mode (every dispatch eager on
the CPU) serves the JAX ``Model.forward`` greedy oracle's tokens on a
trace that reuses buckets at different starts and slots.
(c) ``graphs=True`` raises where capture cannot happen: on the CPU and
under a tensor-parallel context.
(d) The bucket key holds none of the per-dispatch scalars.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.serving.request import synth_prompt_tokens as jsynth
from repro_torch.configs import get_config, reduced
from repro_torch.core.device import DeviceContext
from repro_torch.core.lookahead import BucketProgram, make_superiter_fn
from repro_torch.kernels.ops import build_duet_schedule, duet_block_q
from repro_torch.models import Model, params_from_jax
from repro_torch.models.params import shard_params
from repro_torch.serving import (AsyncDuetEngine, EngineConfig, Request)
from repro_torch.serving.kvcache import PagePoolConfig, init_page_pools

B, PS, NUM_PAGES, W, C = 3, 8, 24, 4, 8
# (start, slot, resume token) of the two dispatches of one bucket
DISPATCHES = [(8, 1, 5), (16, 2, 11)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the reduced model's ops are tiny, and with the
    suite's parallel workers sharing the cores, torch's default thread
    team per op slows these tests by an order of magnitude or more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(name):
    cfg = reduced(get_config(name))
    return Model.init(cfg, seed=0, dtype=torch.float32, device="cpu",
                      attn_kernel=True)


@pytest.fixture(scope="module")
def models():
    return {name: _model(name) for name in
            ("qwen3-4b", "zamba2-1.2b", "granite-moe-3b-a800m")}


def _randomize(tensors, gen):
    for t in tensors:
        if t.is_floating_point():
            t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))


def _world(model, paged, seed):
    """Pools (or the slab cache), recurrent state and decode inputs with
    random contents, so a program that reads the wrong slot, page or
    position shows it."""
    gen = torch.Generator().manual_seed(seed)
    cfg = model.cfg
    if paged:
        pools = init_page_pools(cfg, PagePoolConfig(num_pages=NUM_PAGES,
                                                    page_size=PS))
        state = model.init_state_cache(B)
        _randomize([t for p in pools if p is not None for t in p], gen)
    else:
        pools, state = None, model.init_cache(B, 64)
    _randomize([t for c in state if c is not None for t in c], gen)
    last_tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                             dtype=torch.int32)
    pos = torch.randint(8, 20, (B,), generator=gen, dtype=torch.int32)
    return {"pools": pools, "state": state, "last_tok": last_tok,
            "pos": pos}


def _inputs(rng, vocab, kb, chunk, width, start, slot):
    """Host inputs of one dispatch: the decode rows' tables and active
    mask (the chunk's slot off it), the chunk's tokens and table."""
    active = rng.random(B) < 0.8
    active[slot] = False
    tables = rng.integers(1, NUM_PAGES, (B, width)).astype(np.int32)
    pre_toks = rng.integers(0, vocab, (1, chunk)).astype(np.int32) \
        if chunk else None
    pre_tbl = rng.permutation(np.arange(1, NUM_PAGES))[:W].astype(
        np.int32)[None] if chunk else None
    return active, tables if kb else np.zeros((B, 1), np.int32), \
        pre_toks, pre_tbl


def _snapshot(world):
    return copy.deepcopy(world)


def _flat(world):
    out = [world["last_tok"], world["pos"]]
    for group in (world["pools"] or []) + world["state"]:
        if group is not None:
            out.extend(group)
    return out


KINDS = {
    # name: (model, kb, chunk, finish, sample, duet, paged)
    "fused": ("qwen3-4b", 2, C, True, True, False, True),
    "duet": ("qwen3-4b", 2, C, True, False, True, True),
    "prefill": ("qwen3-4b", 0, C, True, False, False, True),
    "prefill_continue": ("qwen3-4b", 0, C, False, False, False, True),
    "decode": ("qwen3-4b", 2, 0, False, False, False, True),
    "zamba2": ("zamba2-1.2b", 1, C, True, True, False, True),
    "granite_moe": ("granite-moe-3b-a800m", 1, C, True, False, False,
                    True),
    "slab_decode": ("qwen3-4b", 2, 0, False, False, False, False),
}


@pytest.mark.parametrize("kind", list(KINDS))
def test_bucket_reused_across_dispatches_equals_fresh_program(models, kind):
    """(a) The bucket's program over its static buffers, dispatched twice
    with different scalars, against a freshly built program on a copy of
    the same state with new tensors and host-int scalars: bitwise equal
    outputs, pools, state and decode inputs each time."""
    name, kb, chunk, finish, sample, duet, paged = KINDS[kind]
    model = models[name]
    cfg = model.cfg
    bq = duet_block_q(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) \
        if duet else 1
    kw = dict(paged=paged, chunk=chunk, finish=finish, sample=sample,
              duet_kernel=duet, duet_block_q=bq)
    width = W if kb else 1
    bucket = BucketProgram(make_superiter_fn(model, kb, **kw),
                           torch.device("cpu"), B, width=width, chunk=chunk,
                           pwidth=W, paged=paged)
    order = None
    if duet:
        sched = build_duet_schedule([(b, 0) for b in range(B)],
                                    [(B, i) for i in range(chunk)],
                                    block_q=bq)
        order = torch.from_numpy(sched.row_src.astype(np.int32))
    world = _world(model, paged, seed=1)
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    for start, slot, override in DISPATCHES:
        active, tables, pre_toks, pre_tbl = _inputs(
            rng, cfg.vocab_size, kb, chunk, width, start, slot)
        before = _snapshot(world)
        bucket.feed(active, tables if paged else None, pre_toks, pre_tbl,
                    (start, slot, override))
        if paged:
            args = (world["pools"], world["state"], world["last_tok"],
                    world["pos"], bucket.tables, gen, bucket.active,
                    bucket.pre_toks, bucket.pre_tbl, bucket.pre_start,
                    bucket.pre_slot, bucket.override_tok)
            args += (order,) if duet else ()
        else:
            args = (world["state"], world["last_tok"], world["pos"], gen,
                    bucket.active, bucket.pre_toks, bucket.pre_start,
                    bucket.pre_slot, bucket.override_tok)
        got = bucket.run(*args)

        fresh = make_superiter_fn(model, kb, **kw)
        t = torch.from_numpy
        if paged:
            want = fresh(before["pools"], before["state"],
                         before["last_tok"], before["pos"],
                         t(tables.copy()), gen, t(active.copy()),
                         None if pre_toks is None else t(pre_toks.copy()),
                         None if pre_tbl is None else t(pre_tbl.copy()),
                         start, slot, override,
                         *((order.clone(),) if duet else ()))
        else:
            want = fresh(before["state"], before["last_tok"],
                         before["pos"], gen, t(active.copy()), None,
                         start, slot, override)
        assert torch.equal(got[0], want[0])
        assert (got[1] is None) == (want[1] is None) == (not sample)
        if sample:
            assert got[1].shape == () and torch.equal(got[1], want[1])
        for a, b in zip(_flat(world), _flat(before)):
            assert torch.equal(a, b)
        if finish:
            # the chunk's slot now decodes from the chunk's end
            assert int(world["pos"][slot]) == start + chunk
            if not sample:
                assert int(world["last_tok"][slot, 0]) == override
    assert bucket.runs == len(DISPATCHES)


# ------------------------------------------------------------ the engine
KW = dict(max_slots=3, max_len=128, token_budget=16, page_size=32)
# prompts of several 16-token chunks: continuing chunks of one length and
# one page reuse a bucket at other starts, and requests on other slots
SPECS = [(i, 0.0003 * i, 40 + 5 * i, 4 + i) for i in range(5)]


def greedy_oracle(forward, vocab, specs):
    """Greedy continuations from the JAX full-sequence forward (every
    sequence right-padded to one length, so it compiles once)."""
    seqs = {rid: list(jsynth(rid, vocab, p)) for rid, _, p, _ in specs}
    want = {rid: o for rid, _, _, o in specs}
    out = {rid: [] for rid in seqs}
    L = max(p + o for _, _, p, o in specs)
    for _ in range(max(want.values())):
        batch = np.zeros((len(seqs), L), np.int32)
        for i, s in enumerate(seqs.values()):
            batch[i, :len(s)] = s
        logits = np.asarray(forward(jnp.asarray(batch)))
        for i, (rid, s) in enumerate(seqs.items()):
            if len(out[rid]) < want[rid]:
                tok = int(np.argmax(logits[i, len(s) - 1]))
                s.append(tok)
                out[rid].append(tok)
    return out


@pytest.fixture(scope="module")
def jax_setup():
    jcfg = jreduced(jget_config("qwen3-4b"))
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = reduced(get_config("qwen3-4b"))
    tmodel = Model(tcfg, params_from_jax(
        tcfg, jax.tree.map(np.asarray, jparams)), attn_kernel=True)
    forward = jax.jit(lambda toks: jmodel.forward(jparams, toks))
    return forward, tcfg, tmodel


def _feeds(monkeypatch):
    """Record each dispatch's bucket key and its (start, slot, resume
    token) as fed to the bucket's static buffers."""
    seen = []
    feed = BucketProgram.feed

    def spy(self, active, tables=None, pre_toks=None, pre_tbl=None,
            scalars=(0, 0, 0)):
        seen.append((self, tuple(int(v) for v in scalars)))
        return feed(self, active, tables, pre_toks, pre_tbl, scalars)
    monkeypatch.setattr(BucketProgram, "feed", spy)
    return seen


def test_static_buffer_engine_matches_oracle_with_buckets_reused(
        jax_setup, monkeypatch):
    """(b) Every dispatch fed through its bucket's static buffers (eager
    on the CPU, by the ``cpu`` rule): the JAX greedy oracle's tokens, and
    a chunk bucket reused at two starts and two slots."""
    forward, tcfg, tmodel = jax_setup
    seen = _feeds(monkeypatch)
    eng = AsyncDuetEngine(tmodel, EngineConfig(**KW), device="cpu")
    eng.submit([Request(rid=rid, arrival=a, prompt_len=p, output_len=o)
                for rid, a, p, o in SPECS])
    metrics = eng.run()
    toks = {r.rid: list(r.output_tokens) for r in metrics.requests}
    assert toks == greedy_oracle(forward, tcfg.vocab_size, SPECS)
    st = eng.dstats
    assert not eng.graphs and st.captures == st.replays == 0
    assert st.eager_dispatches == st.dispatches == len(seen)
    assert st.eager_reasons == {"cpu": st.dispatches}
    assert 0 < st.host_syncs <= st.super_iterations
    key_of = {id(p): k for k, p in eng._programs.items()}
    by_key = {}
    for prog, (start, slot, _) in seen:
        by_key.setdefault(key_of[id(prog)], set()).add((start, slot))
    reused = [k for k, v in by_key.items() if k[2] and
              len({s for s, _ in v}) > 1 and len({p for _, p in v}) > 1]
    assert reused, by_key


# ------------------------------------------------- where graphs cannot be
def test_graphs_true_raises_on_the_cpu(models):
    """(c) No CUDA graph on the CPU: ``graphs=True`` raises; the default
    runs every dispatch eagerly and says why."""
    with pytest.raises(ValueError, match="CUDA device"):
        AsyncDuetEngine(models["qwen3-4b"], EngineConfig(**KW),
                        device="cpu", graphs=True)
    eng = AsyncDuetEngine(models["qwen3-4b"], EngineConfig(**KW),
                          device="cpu")
    assert not eng.graphs and eng._eager_rule == "cpu"
    assert eng.graph_pool_bytes() == 0


def test_graphs_true_raises_under_tensor_parallelism(models):
    """(c) Under a TP context (rank 0 of 2; nothing runs, so no group is
    needed) ``graphs=True`` raises for the collectives, the rule checked
    before the device, and the default keeps every dispatch eager by it."""
    from repro_torch.serving.async_engine import graph_blocker
    cfg = models["qwen3-4b"].cfg
    ctx = DeviceContext(cfg, torch.device("cpu"), tp=2, rank=0)
    model = Model(cfg, shard_params(models["qwen3-4b"].param_tree(), cfg,
                                    2, 0), ctx=ctx, attn_kernel=True)
    assert ctx.collectives and not models["qwen3-4b"].ctx.collectives
    with pytest.raises(ValueError, match="collectives"):
        AsyncDuetEngine(model, EngineConfig(**KW), device="cpu",
                        graphs=True)
    eng = AsyncDuetEngine(model, EngineConfig(**KW), device="cpu")
    assert not eng.graphs and eng._eager_rule == "collectives"
    assert graph_blocker(torch.device("cuda"), ctx) == "collectives"
    assert graph_blocker(torch.device("cuda"),
                         models["qwen3-4b"].ctx) is None


def test_bucket_key_holds_no_per_dispatch_scalar(jax_setup, monkeypatch):
    """(d) Every key is (kb, width, chunk, pwidth, finish, sample, duet):
    bucket shapes and flags only. A key dispatched at several starts,
    slots and resume tokens is one bucket, and a dispatch's scalars never
    show up among its key's fields."""
    forward, tcfg, tmodel = jax_setup
    seen = _feeds(monkeypatch)
    eng = AsyncDuetEngine(tmodel, EngineConfig(**KW), device="cpu")
    eng.submit([Request(rid=rid, arrival=a, prompt_len=p, output_len=o)
                for rid, a, p, o in SPECS])
    eng.run()
    for key, prog in eng._programs.items():
        kb, width, chunk, pwidth, finish, sample, duet = key
        assert all(isinstance(v, int) for v in (kb, width, chunk, pwidth))
        assert all(isinstance(v, bool) for v in (finish, sample, duet))
        assert prog.tables.shape == (KW["max_slots"], max(width, 1))
        assert prog.pre_toks is None if not chunk else \
            prog.pre_toks.shape == (1, chunk)
    scalars = {}
    for prog, sc in seen:
        scalars.setdefault(id(prog), set()).add(sc)
    assert len(eng._programs) < len(seen)
    assert max(len(v) for v in scalars.values()) > 1
    starts = {sc[0] for v in scalars.values() for sc in v}
    assert len(starts) > 2
