"""Port parity for the recurrent and hybrid configs: zamba2-1.2b (Mamba2
blocks and one weight-shared attention block) and xlstm-350m (mLSTM and
sLSTM blocks), reduced as the reference reduces them and cut to 4 layers
(zamba2: mamba2, shared_attn, mamba2, shared_attn — the shared block runs
twice; xlstm: mlstm, slstm, mlstm, slstm), against the JAX package on the
same weights, in fp32 (xlstm's forget-gate biases set to 5, so its state
outlives a request).

Covered: the configs field for field and their parameter counts; the
parameter tree carried over by ``params_from_jax`` leaf for leaf, the
shared block at its top-level slot and Mamba2's ``uniform_log`` gate
leaves kept fp32 in a bf16 model; the slab ``prefill`` (chunked, into the
cache) and ``decode_step``, and ``prefill_paged`` and
``decode_step_paged`` against the JAX ``Model``'s (logits within
``STEP_TOL``, equal argmax, recurrent state within it too), with the port's
``active_mask`` keeping an inactive row's state; and the greedy streams of
both engines on paged and slab KV against a greedy oracle from the JAX
``Model.forward``, where five requests share three slots (slot reuse: the
engines put a slot's recurrent state back to zeros when a prefill starts
at position 0, which the reference's engines do not), later prompts
prefill while earlier requests decode, one request asks for one token, and
(zamba2, paged) a 48-token pool forces preemption and re-prefill. The
prefix cache turns itself off with a warning, as the reference's does. The
JAX engines are not the oracle: with jax 0.9 on a CPU backend they raise a
ShardingTypeError, while the model-level functions run."""
import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.models.params import \
    count_params_analytical as jcount_params_analytical
from repro.serving.kvcache import PagePoolConfig as JPagePoolConfig
from repro.serving.kvcache import init_page_pools as jinit_page_pools
from repro.serving.request import synth_prompt_tokens as jsynth
from repro_torch.configs import get_config, reduced
from repro_torch.models import Model, count_params_analytical
from repro_torch.models import transformer
from repro_torch.models.attention import slot_views
from repro_torch.models.params import layout, params_from_jax
from repro_torch.models.ssm import MambaCache
from repro_torch.models.xlstm import MLSTMCache, SLSTMCache
from repro_torch.serving import (AsyncDuetEngine, DuetEngine, EngineConfig,
                                 Request)
from repro_torch.serving.kvcache import PagePoolConfig, init_page_pools

NAMES = ("zamba2-1.2b", "xlstm-350m")
LAYERS = 4
# logits and states of the model steps: the mLSTM's chunkwise prefill
# carries fp32 rounding of 1e-4 (tests/test_torch_xlstm.py), and four
# layers carry it on
STEP_TOL = 2e-4
KW = dict(max_slots=3, max_len=128, token_budget=48, page_size=8)
# five requests on three slots (slots are reused), arrivals 0.3 ms apart
# on the virtual clock (later prompts prefill while earlier requests
# decode), and one request of a single output token
# xlstm's forget-gate biases (xLSTM initialises them at 3 to 6): at the
# layout's zero bias the random gates forget a request within a few
# tokens, and a slot's stale state would not show in the tokens
FORGET_BIAS = 5.0
SPECS = [(0, 0.0, 20, 6), (1, 0.0003, 27, 1), (2, 0.0006, 34, 8),
         (3, 0.0009, 41, 9), (4, 0.0012, 30, 10)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the reduced model's ops are tiny, and with the
    suite's parallel workers sharing the cores, torch's default thread
    team per op slows these tests by an order of magnitude or more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=STEP_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _check_logits(got, want):
    _close(got, want)
    np.testing.assert_array_equal(np.asarray(got).argmax(-1),
                                  np.asarray(want).argmax(-1))


def _check_state(tstate, jstate, rows=slice(None)):
    """Every recurrent entry's leaves, at batch ``rows`` (attention entries
    skipped)."""
    n = 0
    for t, j in zip(tstate, jstate):
        if isinstance(t, transformer.STATE_TYPES):
            for a, b in zip(t, j):
                _close(a[rows], np.asarray(b)[rows])
            n += 1
    assert n > 0


def greedy_oracle(forward, vocab, specs):
    """Greedy continuations from the JAX full-sequence forward, every
    sequence right-padded to one length (the blocks are causal, so the
    padding is invisible to earlier positions)."""
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


def _long_memory(jparams, cfg, bias=FORGET_BIAS):
    """The xLSTM layers' forget-gate biases set to ``bias`` (the mLSTM's
    second half of ``b_gates``, the sLSTM's third quarter of ``b_in``)."""
    layers = []
    for p, kind in zip(jparams["layers"], cfg.block_pattern):
        p = dict(p)
        if kind == "mlstm":
            b = p["mlstm"]["b_gates"]
            p["mlstm"] = dict(p["mlstm"], b_gates=b.at[cfg.num_heads:].set(
                bias))
        else:
            D = cfg.d_model
            b = p["slstm"]["b_in"]
            p["slstm"] = dict(p["slstm"], b_in=b.at[2 * D:3 * D].set(bias))
        layers.append(p)
    return dict(jparams, layers=layers)


@functools.lru_cache(maxsize=None)
def _build(name):
    """(name, jcfg, the JAX Model, its params, tcfg, the port's Model with
    the kernel hook on, the greedy oracle's tokens) of one config."""
    jcfg = jreduced(jget_config(name), num_layers=LAYERS)
    tcfg = reduced(get_config(name), num_layers=LAYERS)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    if name == "xlstm-350m":
        jparams = _long_memory(jparams, tcfg)
    tmodel = Model(tcfg, params_from_jax(tcfg, jax.tree.map(np.asarray,
                                                             jparams)),
                   attn_kernel=True)
    forward = jax.jit(lambda toks: jmodel.forward(jparams, toks))
    oracle = greedy_oracle(forward, tcfg.vocab_size, SPECS)
    return name, jcfg, jmodel, jparams, tcfg, tmodel, oracle


@pytest.fixture(scope="module", params=NAMES)
def case(request):
    return _build(request.param)


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_configs_and_param_counts_match_jax(name):
    port, ref = get_config(name), jget_config(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for kw in ({}, {"num_layers": LAYERS}):
        assert dataclasses.asdict(reduced(port, **kw)) == \
            dataclasses.asdict(jreduced(ref, **kw))
    assert count_params_analytical(port) == jcount_params_analytical(ref)


def test_published_recurrent_shapes():
    """The full-width shapes the card serves: zamba2's 32 Mamba2 layers of
    64 heads x 64 channels over a state of 64 and its 6 occurrences of
    one shared block (32 / 32 heads at Dh 64); xlstm's 18 mLSTM and 6
    sLSTM layers, 4 heads, mLSTM heads of 512; their parameters."""
    z, x = get_config("zamba2-1.2b"), get_config("xlstm-350m")
    assert z.block_pattern.count("mamba2") == 32
    assert [i for i, k in enumerate(z.block_pattern)
            if k == "shared_attn"] == [5, 11, 17, 23, 29, 35]
    assert (z.d_inner, z.ssm_heads, z.ssm_head_dim, z.ssm_state) == \
        (4096, 64, 64, 64)
    assert (z.num_heads, z.num_kv_heads, z.head_dim) == (32, 32, 64)
    assert x.block_pattern.count("slstm") == 6 and x.d_ff == 0
    # 2.03 GB and 1.00 GB of bf16 weights
    assert z.param_count() == 1_016_954_880
    assert x.param_count() == 499_868_816
    lay = layout(z)
    assert lay["layers"][5] == {} and "attn" in lay["shared_attn"]
    assert lay["layers"][0]["mamba"]["w_x"].shape == (2048, 4096)


def test_params_from_jax_round_trip(case):
    """Every leaf of the reference's tree lands in the port's layout
    unchanged, the shared block at its top-level slot; in a bf16 model the
    uniform_log gate leaves stay fp32, from the bridge and from
    ``Model.init``."""
    name, jcfg, jmodel, jparams, tcfg, tmodel, _ = case
    tree = jax.tree.map(np.asarray, jparams)
    assert set(layout(tcfg)) == set(tree)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        node = tmodel.params
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        np.testing.assert_array_equal(node.numpy(), leaf)
    assert sum(b.numel() for b in tmodel.buffers()) == tcfg.param_count()
    assert ("shared_attn" in tmodel.params) == (name == "zamba2-1.2b")
    bf = params_from_jax(tcfg, tree, dtype=torch.bfloat16)
    init = Model.init(tcfg, seed=1, dtype=torch.bfloat16, device="cpu")
    for p in (bf, init.params):
        for layer, kind in zip(p["layers"], tcfg.block_pattern):
            if kind == "mamba2":
                assert layer["mamba"]["dt_bias"].dtype == torch.float32
                assert layer["mamba"]["A_log"].dtype == torch.float32
                assert layer["mamba"]["w_x"].dtype == torch.bfloat16
    if name == "zamba2-1.2b":
        # drawn from log(uniform(1e-3, 0.1)), as the reference's
        a = init.params["layers"][0]["mamba"]["A_log"]
        assert float(a.min()) >= np.log(1e-3) and float(a.max()) <= np.log(0.1)


def test_state_caches_match_jax_layouts(case):
    """``init_state_cache`` and ``init_cache`` build the reference's
    entries: None for attention (paged), a recurrent state per recurrent
    layer, zeros, fp32 but for the conv tails (the model's dtype)."""
    name, jcfg, jmodel, jparams, tcfg, tmodel, _ = case
    tstate = tmodel.init_state_cache(3)
    jstate = jmodel.init_state_cache(3)
    for t, j, kind in zip(tstate, jstate, tcfg.block_pattern):
        assert (t is None) == (j is None) == (kind == "shared_attn")
        if t is not None:
            assert type(t).__name__ == type(j).__name__
            for a, b in zip(t, j):
                assert tuple(a.shape) == b.shape and not a.any()
    bf = Model.init(tcfg, seed=0, dtype=torch.bfloat16, device="cpu")
    for c in bf.init_cache(2, 16):
        if isinstance(c, (MambaCache, MLSTMCache)):
            assert c.conv.dtype == torch.bfloat16
            assert all(t.dtype == torch.float32 for t in c[1:])
        elif isinstance(c, SLSTMCache):
            assert all(t.dtype == torch.float32 for t in c)


# ---------------------------------------------------------------------------
# model steps against the JAX Model's
# ---------------------------------------------------------------------------
def _jrow(tree, slot):
    return jax.tree.map(lambda a: a[slot:slot + 1], tree)


def _jwrite(tree, sub, slot):
    return jax.tree.map(lambda full, part: full.at[slot].set(part[0]),
                        tree, sub)


def test_slab_steps_match_jax(case):
    """Two rows prefilled into the slab in chunks of 20 + 17 tokens (the
    port's cache written in place), three decode steps of both, then one
    step with row 1 inactive: row 0 moves as the JAX step's, row 1's state
    stays where it was."""
    name, jcfg, jmodel, jparams, tcfg, tmodel, _ = case
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tcfg.vocab_size, (2, 41)).astype(np.int32)
    jcache = jmodel.init_cache(2, 64)
    tcache = tmodel.init_cache(2, 64)
    jpre = jax.jit(lambda p, t, c, s0: jmodel.prefill(p, t, cache=c,
                                                      start_pos=s0))
    jdec = jax.jit(lambda p, c, t, pos: jmodel.decode_step(p, c, t, pos))
    for s0, s1 in ((0, 20), (20, 37)):
        jl, jcache = jpre(jparams, jnp.asarray(toks[:, s0:s1]), jcache,
                          jnp.int32(s0))
        tl, tcache = tmodel.prefill(torch.from_numpy(toks[:, s0:s1]),
                                    cache=tcache, start_pos=s0)
        _check_logits(tl, jl)
    _check_state(tcache, jcache)
    for t in range(37, 40):
        pos = np.full((2,), t, np.int32)
        jl, jcache = jdec(jparams, jcache, jnp.asarray(toks[:, t:t + 1]),
                          jnp.asarray(pos))
        tl, tcache = tmodel.decode_step(tcache, torch.from_numpy(
            toks[:, t:t + 1]), torch.from_numpy(pos))
        _check_logits(tl, jl)
    _check_state(tcache, jcache)
    before = copy.deepcopy(tcache)
    pos = np.full((2,), 40, np.int32)
    jl, jnew = jdec(jparams, jcache, jnp.asarray(toks[:, 40:41]),
                    jnp.asarray(pos))
    tl, tcache = tmodel.decode_step(
        tcache, torch.from_numpy(toks[:, 40:41]), torch.from_numpy(pos),
        active_mask=torch.tensor([True, False]))
    _check_logits(tl[:1], jl[:1])
    _check_state(tcache, jnew, rows=0)
    for c, b in zip(tcache, before):
        if isinstance(c, transformer.STATE_TYPES):
            for x, y in zip(c, b):
                torch.testing.assert_close(x[1], y[1], atol=0, rtol=0)


def test_paged_steps_match_jax(case):
    """Requests A (14 tokens, one chunk) and B (9 tokens, chunks of 5 + 4)
    prefill through their slots' rows of the per-slot state (the engines'
    ``slot_views``; the JAX side slices and writes the row back), then two
    decode steps of three slots (the third inactive: all-zero table row,
    its state frozen by ``active_mask`` — the reference's look-ahead loop
    restores it)."""
    name, jcfg, jmodel, jparams, tcfg, tmodel, _ = case
    rng = np.random.default_rng(17)
    ps, N, P = 4, 32, 6
    jpools = jinit_page_pools(jcfg, JPagePoolConfig(num_pages=N,
                                                    page_size=ps))
    tpools = init_page_pools(tcfg, PagePoolConfig(num_pages=N, page_size=ps))
    jstate, tstate = jmodel.init_state_cache(3), tmodel.init_state_cache(3)
    tblA = np.asarray([[1, 2, 3, 4, 0, 0]], np.int32)
    tblB = np.asarray([[5, 6, 7, 0, 0, 0]], np.int32)
    toks = {r: rng.integers(0, tcfg.vocab_size, (1, n)).astype(np.int32)
            for r, n in (("A", 16), ("B", 11))}
    jpre = jax.jit(lambda p, t, pools, st, tbl, s0: jmodel.prefill_paged(
        p, t, pools, st, tbl, start_pos=s0))
    for rid, slot, tbl, chunks in (("A", 0, tblA, [(0, 14)]),
                                   ("B", 1, tblB, [(0, 5), (5, 9)])):
        for s0, s1 in chunks:
            t = toks[rid][:, s0:s1]
            jl, jpools, sub = jpre(jparams, jnp.asarray(t), jpools,
                                   _jrow(jstate, slot), jnp.asarray(tbl),
                                   jnp.int32(s0))
            jstate = _jwrite(jstate, sub, slot)
            tl, tpools, _ = tmodel.prefill_paged(
                torch.from_numpy(t), tpools, slot_views(tstate, slot),
                torch.from_numpy(tbl), start_pos=s0)
            _check_logits(tl, jl)
    _check_state(tstate, jstate)
    frozen = copy.deepcopy(tstate)
    tbl = np.concatenate([tblA, tblB, np.zeros((1, P), np.int32)])
    active = torch.tensor([True, True, False])
    jdec = jax.jit(lambda *a: jmodel.decode_step_paged(*a))
    for step in range(2):
        tok = np.asarray([[toks["A"][0, 14 + step]],
                          [toks["B"][0, 9 + step]], [0]], np.int32)
        pos = np.asarray([14 + step, 9 + step, 0], np.int32)
        jl, jpools, jnew = jdec(jparams, jpools, jstate, jnp.asarray(tok),
                                jnp.asarray(pos), jnp.asarray(tbl))
        # the reference's look-ahead freezes the inactive row
        jstate = jax.tree.map(lambda n, o: n.at[2].set(o[2]), jnew, jstate)
        tl, tpools, tstate = tmodel.decode_step_paged(
            tpools, tstate, torch.from_numpy(tok), torch.from_numpy(pos),
            torch.from_numpy(tbl), active_mask=active)
        _check_logits(tl[:2], jl[:2])
        _check_state(tstate, jstate)
    for c, b in zip(tstate, frozen):
        if c is not None:
            for x, y in zip(c, b):
                torch.testing.assert_close(x[2], y[2], atol=0, rtol=0)


# ---------------------------------------------------------------------------
# engines against the greedy oracle
# ---------------------------------------------------------------------------
def _serve(cls, model, specs, **kw):
    eng = cls(model, EngineConfig(**kw), device="cpu")
    eng.submit([Request(rid=r, arrival=a, prompt_len=p, output_len=o)
                for r, a, p, o in specs])
    metrics = eng.run()
    return eng, metrics, {r.rid: list(r.output_tokens)
                          for r in metrics.requests}


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slab"])
@pytest.mark.parametrize("cls", [DuetEngine, AsyncDuetEngine],
                         ids=["sync", "async"])
def test_engines_match_jax_greedy_oracle(case, cls, paged, monkeypatch):
    """Both engines on both KV layouts give the oracle's greedy tokens with
    five requests on three slots; some iteration runs a prefill chunk
    beside decode rows; every slot that a second request takes is reset
    at that request's first chunk; the async engine keeps at most one
    host sync per super-iteration and fuses no duet step (recurrent
    blocks)."""
    name, jcfg, jmodel, jparams, tcfg, tmodel, oracle = case
    resets, mixed = [], []
    plain_reset = transformer.reset_slot_state

    def spy(cache, slot):
        resets.append(slot)
        plain_reset(cache, slot)
    monkeypatch.setattr("repro_torch.serving.engine.reset_slot_state", spy)
    plan_fn = DuetEngine._plan

    def plan(self):
        p = plan_fn(self)
        mixed.append(bool(p.prefill) and bool(p.decode))
        return p
    monkeypatch.setattr(DuetEngine, "_plan", plan)
    eng, metrics, toks = _serve(cls, tmodel, SPECS, paged=paged, **KW)
    assert metrics.summary()["num_finished"] == len(SPECS)
    assert toks == oracle
    assert eng.kv_mgr.used_pages == 0
    assert any(mixed)
    assert len(resets) == len(SPECS) and len(set(resets)) == 3
    if cls is AsyncDuetEngine:
        assert 0 < eng.dstats.host_syncs <= eng.dstats.super_iterations
        assert not eng._duet_kernel
        assert not any(key[-1] for key in eng._programs)


@pytest.mark.parametrize("cls", [DuetEngine, AsyncDuetEngine],
                         ids=["sync", "async"])
def test_zamba2_preemption_keeps_oracle_tokens(cls):
    """zamba2, two requests of 20 + 12 tokens on two slots and a 56-token
    pool of 8-token pages: look-ahead shrinks and a request is preempted
    and re-prefilled from position 0 (its slot's state reset); the greedy
    tokens still equal the oracle's. (xlstm keeps no KV, so no pool can
    press it.)"""
    name, jcfg, jmodel, jparams, tcfg, tmodel, _ = _build("zamba2-1.2b")
    specs = [(i, 0.0, 20, 12) for i in range(2)]
    eng, metrics, toks = _serve(cls, tmodel, specs,
                                **dict(KW, max_slots=2, kv_pool_tokens=56))
    assert metrics.summary()["num_finished"] == 2
    assert metrics.summary()["num_preemptions"] > 0
    forward = jax.jit(lambda t: jmodel.forward(jparams, t))
    assert toks == greedy_oracle(forward, tcfg.vocab_size, specs)
    assert eng.kv_mgr.used_pages == 0


@pytest.mark.parametrize("cls", [DuetEngine, AsyncDuetEngine],
                         ids=["sync", "async"])
def test_prefix_cache_turns_itself_off(case, cls):
    """The prefix cache skips prefill work, which recurrent state cannot
    skip: the engine warns and serves without it, as the reference's. Two
    requests with the same prompt, one after the other, hit nothing and
    give the same tokens."""
    name, jcfg, jmodel, jparams, tcfg, tmodel, _ = case
    with pytest.warns(UserWarning, match="prefix_cache disabled"):
        eng = cls(tmodel, EngineConfig(prefix_cache=True, **KW),
                  device="cpu")
    assert eng.prefix_cache is False
    prompt = np.asarray(jsynth(7, tcfg.vocab_size, 24), np.int32)
    eng.submit([Request(rid=r, arrival=0.05 * r, prompt_len=24,
                        output_len=5, prompt_tokens=prompt.copy())
                for r in range(2)])
    reqs = eng.run().requests
    assert reqs[0].output_tokens == reqs[1].output_tokens
    assert eng.kv_mgr.prefix_stats()["hit_tokens"] == 0
