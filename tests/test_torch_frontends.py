"""Port parity for the two frontends: paligemma-3b (vision: precomputed
patch embeddings prepended to the text under the prefix-LM mask, MQA at
8 : 1 heads, GeGLU, tied embeddings) and musicgen-medium (audio: K = 4
codebook embeddings summed, one head a codebook, a plain GELU FFN),
reduced as the reference reduces them, against the JAX ``Model`` on the
same weights (``params_from_jax``), fp32 on the CPU.

Held: the configs and the layout; the full-sequence forward; the slab
prefill with the patch prefix or the codebook grid and the slab decode
steps after it, plain and through the kernel hook (the slab
``duet_attention``'s plain version here), within 1e-4; the paged steps
refusing audio, as the reference's; and paligemma served text-only by both
port engines on both KV layouts against a greedy oracle from the JAX
``Model.forward`` (exact tokens; the JAX engines raise a
ShardingTypeError under jax 0.9 on the CPU, see tests/test_torch_configs.py).
"""
import dataclasses

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
from repro_torch.configs import get_config, reduced
from repro_torch.models import Model, count_params_analytical, \
    params_from_jax
from repro_torch.models.params import layout
from repro_torch.serving import (AsyncDuetEngine, DuetEngine, EngineConfig,
                                 Request)
from repro_torch.serving.kvcache import PagePoolConfig, init_page_pools

from test_torch_configs import KW, SPECS, greedy_oracle

TOL = 1e-4
NAMES = ("paligemma-3b", "musicgen-medium")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the reduced model's ops are tiny, and with the
    suite's parallel workers sharing the cores, torch's default thread
    team per op slows these tests by an order of magnitude or more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module", params=NAMES)
def case(request):
    """(name, jcfg, JAX model, JAX params, the port's model with the
    kernel hook off, the same with it on)."""
    jcfg = jreduced(jget_config(request.param))
    tcfg = reduced(get_config(request.param))
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams))
    return (request.param, jcfg, jmodel, jparams, Model(tcfg, tparams),
            Model(tcfg, tparams, attn_kernel=True))


@pytest.mark.parametrize("name", NAMES)
def test_configs_and_layout_match_jax(name):
    """The configs (published and reduced, which keeps 4 codebooks and cuts
    the patch prefix to 8) and the parameter layout and count: audio's
    (K, Vp, D) codebook tables and heads in place of the embedding."""
    port, ref = get_config(name), jget_config(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(reduced(port)) == \
        dataclasses.asdict(jreduced(ref))
    assert count_params_analytical(port) == jcount_params_analytical(ref)
    tree = layout(port)
    if name == "musicgen-medium":
        assert "embedding" not in tree
        assert tree["w_heads"].shape == tree["codebook_embeddings"].shape \
            == (4, port.padded_vocab, 1536)
        assert reduced(port).num_codebooks == 4
    else:
        assert "w_out" not in tree and "codebook_embeddings" not in tree
        assert (port.num_heads, port.num_kv_heads, port.head_dim) == \
            (8, 1, 256)
        assert reduced(port).num_prefix_tokens == 8


def test_params_from_jax_round_trip(case):
    name, jcfg, jmodel, jparams, tmodel, _ = case
    flat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jparams))[0]
    for path, leaf in flat:
        node = tmodel.params
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        np.testing.assert_array_equal(node.numpy(), leaf)


def _inputs(jcfg, B, S, seed=0):
    """(tokens, patch embeds or None): (B, K, S) codebook tokens for audio;
    (B, S) text and (B, P, D) patch embeddings for vision."""
    rng = np.random.default_rng(seed)
    if jcfg.frontend == "audio":
        return rng.integers(0, jcfg.vocab_size,
                            (B, jcfg.num_codebooks, S)).astype(np.int32), None
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    patches = (rng.standard_normal((B, jcfg.num_prefix_tokens, jcfg.d_model))
               * 0.02).astype(np.float32)
    return toks, patches


def test_forward_matches_jax(case):
    """Logits at every position: (B, S, K, V) for audio; over the patch
    prefix and the text for vision, the prefix attended bidirectionally."""
    name, jcfg, jmodel, jparams, tmodel, _ = case
    toks, patches = _inputs(jcfg, 2, 12)
    kw = {} if patches is None else {"patch_embeds": patches}
    want = jax.jit(lambda p, t, **k: jmodel.forward(p, t, **k))(
        jparams, jnp.asarray(toks), **{k: jnp.asarray(v)
                                       for k, v in kw.items()})
    with torch.no_grad():
        got = tmodel.forward(_t(toks), **{k: _t(v) for k, v in kw.items()})
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


@pytest.mark.parametrize("kernel", [False, True])
def test_slab_prefill_and_decode_match_jax(case, kernel):
    """A slab prefill of the patch prefix and a prompt (vision) or of a
    codebook grid (audio), then three decode steps, plain or through the
    kernel hook, against the JAX ``prefill(cache=...)`` and
    ``decode_step``: each step's logits ((B, K, V) for audio) and the
    cache."""
    name, jcfg, jmodel, jparams, tplain, tkern = case
    tmodel = tkern if kernel else tplain
    B, S, L = 2, 10, 48
    toks, patches = _inputs(jcfg, B, S, seed=1)
    kw = {} if patches is None else {"patch_embeds": patches}
    jcache = jmodel.init_cache(B, L)
    jlogits, jcache = jax.jit(
        lambda p, t, c, **k: jmodel.prefill(p, t, cache=c, **k))(
        jparams, jnp.asarray(toks), jcache,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    cache = tmodel.init_cache(B, L)
    with torch.no_grad():
        logits, cache = tmodel.prefill(
            _t(toks), cache=cache, **{k: _t(v) for k, v in kw.items()})
    _close(logits, jlogits)
    pos = S + (0 if patches is None else patches.shape[1])
    jdecode = jax.jit(lambda p, c, t, q: jmodel.decode_step(
        p, c, t, q))
    rng = np.random.default_rng(2)
    for step in range(3):
        shape = (B, jcfg.num_codebooks, 1) if jcfg.frontend == "audio" \
            else (B, 1)
        tok = rng.integers(0, jcfg.vocab_size, shape).astype(np.int32)
        p = np.full((B,), pos + step, np.int32)
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(tok),
                                  jnp.asarray(p))
        with torch.no_grad():
            logits, cache = tmodel.decode_step(cache, _t(tok), _t(p))
        assert tuple(logits.shape) == tuple(jlogits.shape)
        _close(logits, jlogits)
    for c, jc in zip(cache, jcache):
        for t, jt in zip(c, jc):
            _close(t, jt)


def test_prefix_lm_mask_reaches_the_prefill():
    """Under the prefix-LM mask a change to the last patch embedding moves
    the first patch position's output; without ``prefix_lm`` it cannot
    (the whole-sequence prefill's returned K/V of layer 2 shows it)."""
    tcfg = reduced(get_config("paligemma-3b"))
    tmodel = Model.init(tcfg, seed=0, device="cpu")
    toks, patches = _inputs(tcfg, 1, 6)
    moved = patches.copy()
    moved[:, -1] += 1.0
    causal = Model(dataclasses.replace(tmodel.cfg, prefix_lm=False),
                   tmodel.param_tree())
    for model, differs in ((tmodel, True), (causal, False)):
        with torch.no_grad():
            _, a = model.prefill(_t(toks), patch_embeds=_t(patches))
            _, b = model.prefill(_t(toks), patch_embeds=_t(moved))
        first = (a[1].k[:, 0] - b[1].k[:, 0]).abs().max().item()
        assert (first > 1e-6) == differs


def test_paged_steps_refuse_audio():
    """As the reference's: the paged steps cover the text frontends."""
    tmodel = Model.init(reduced(get_config("musicgen-medium")), seed=0,
                        device="cpu")
    pools = init_page_pools(tmodel.cfg, PagePoolConfig(num_pages=8,
                                                       page_size=4))
    tables = torch.ones((1, 2), dtype=torch.int32)
    tok = torch.zeros((1, 4, 1), dtype=torch.long)
    pos = torch.zeros((1,), dtype=torch.int32)
    state = tmodel.init_state_cache(1)
    with pytest.raises(NotImplementedError, match="text frontends"):
        tmodel.prefill_paged(tok, pools, state, tables)
    with pytest.raises(NotImplementedError, match="text frontends"):
        tmodel.decode_step_paged(pools, state, tok, pos, tables)
    with pytest.raises(NotImplementedError, match="text frontends"):
        tmodel.duet_step_paged(pools, state, tok, pos, tables,
                               torch.zeros((1,), dtype=torch.long))


@pytest.fixture(scope="module")
def paligemma_oracle():
    jcfg = jreduced(jget_config("paligemma-3b"))
    tcfg = reduced(get_config("paligemma-3b"))
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = Model(tcfg, params_from_jax(tcfg, jax.tree.map(np.asarray,
                                                            jparams)),
                   attn_kernel=True)
    forward = jax.jit(lambda toks: jmodel.forward(jparams, toks))
    return tmodel, greedy_oracle(forward, tcfg.vocab_size, SPECS)


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("cls", [DuetEngine, AsyncDuetEngine])
def test_paligemma_engines_match_jax_greedy_oracle(paligemma_oracle, cls,
                                                   paged):
    """paligemma served text-only (no patch prefix, as the reference's
    engines take it) through both engines, paged and slab, with the kernel
    hook on: the greedy tokens of the JAX ``Model.forward``."""
    tmodel, oracle = paligemma_oracle
    eng = cls(tmodel, EngineConfig(paged=paged, **KW), device="cpu")
    eng.submit([Request(rid=r, arrival=a, prompt_len=p, output_len=o)
                for r, a, p, o in SPECS])
    metrics = eng.run()
    assert metrics.summary()["num_finished"] == len(SPECS)
    assert {r.rid: list(r.output_tokens) for r in metrics.requests} == oracle
    if cls is AsyncDuetEngine:
        assert 0 < eng.dstats.host_syncs <= eng.dstats.super_iterations
