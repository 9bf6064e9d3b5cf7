"""Port parity for the model: ``repro_torch.models`` layers, parameter
layout and the three paged serving steps (prefill, decode — plain and
through the kernel hook — and the fused duet step) against the JAX
``repro.models`` on reduced qwen3-4b, with the JAX weights carried over by
``params_from_jax``. Everything runs in float32 on the CPU; logits and
pools must agree within 1e-4 (absolute and relative): the two packages
differ only in summation order."""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_configs as jlist_configs
from repro.configs import reduced as jreduced
from repro.kernels import build_duet_schedule as jbuild_duet_schedule
from repro.models import Model as JModel
from repro.models import layers as jlayers
from repro.models.params import \
    count_params_analytical as jcount_params_analytical
from repro.serving.kvcache import PagedKVCacheManager as JPagedKVCacheManager
from repro.serving.kvcache import PagePoolConfig as JPagePoolConfig
from repro.serving.kvcache import init_page_pools as jinit_page_pools
from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.kernels import build_duet_schedule
from repro_torch.kernels.ops import duet_block_q
from repro_torch.models import Model, count_params_analytical, layers
from repro_torch.models.params import layout, params_from_jax
from repro_torch.serving.kvcache import PagePoolConfig, init_page_pools

TOL = 1e-4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["qwen3-4b", "qwen3-8b", "qwen3-14b",
                                  "yi-9b", "minicpm-2b", "granite-20b",
                                  "granite-moe-3b-a800m",
                                  "deepseek-v2-lite-16b"])
def test_configs_and_param_counts_match_jax(name):
    port, ref = get_config(name), jget_config(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(reduced(port)) == \
        dataclasses.asdict(jreduced(ref))
    assert count_params_analytical(port) == jcount_params_analytical(ref)
    assert count_params_analytical(port, active_only=True) == \
        jcount_params_analytical(ref, active_only=True)


REGISTRY = ["deepseek-v2-lite-16b", "granite-20b", "granite-moe-3b-a800m",
            "minicpm-2b", "musicgen-medium", "paligemma-3b", "qwen3-14b",
            "qwen3-4b", "qwen3-8b", "xlstm-350m", "yi-9b", "zamba2-1.2b"]


@pytest.mark.parametrize("name", REGISTRY)
def test_registry_serves_only_the_qwen3_family(name):
    """The registry holds all twelve configs of the reference (the qwen3
    family, yi-9b, minicpm-2b, granite-20b, the MoE configs
    granite-moe-3b-a800m and deepseek-v2-lite-16b, the recurrent
    zamba2-1.2b and xlstm-350m, and the frontends paligemma-3b and
    musicgen-medium): no config is refused, each has a parameter layout,
    and only a name outside the registry is."""
    assert list_configs() == REGISTRY == sorted(jlist_configs())
    cfg = get_config(name)
    assert cfg.name == name
    assert count_params_analytical(cfg) == jcount_params_analytical(
        jget_config(name))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        get_config(name + "-unknown")


@pytest.fixture(scope="module")
def models():
    jcfg = jreduced(jget_config("qwen3-4b"))
    tcfg = reduced(get_config("qwen3-4b"))
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    tmodel = Model(tcfg, params_from_jax(tcfg, tree))
    # the JAX steps jitted once per shape (eager JAX compiles every op)
    jmodel = copy.copy(jmodel)
    jmodel.prefill_paged = jax.jit(
        lambda p, toks, pools, state, tbl, start_pos:
        JModel.prefill_paged(jmodel, p, toks, pools, state, tbl,
                             start_pos=start_pos))
    jmodel.decode_step_paged = jax.jit(
        lambda *a: JModel.decode_step_paged(jmodel, *a))
    return jcfg, jmodel, jparams, tcfg, tmodel


def test_params_from_jax_keeps_layouts(models):
    jcfg, jmodel, jparams, tcfg, tmodel = models
    p = tmodel.params["layers"][0]["attn"]
    D, H, G, dh = tcfg.d_model, tcfg.num_heads, tcfg.num_kv_heads, \
        tcfg.head_dim
    assert tuple(p["w_q"].shape) == (D, H, dh)
    assert tuple(p["w_o"].shape) == (H, dh, D)
    assert "q_norm" in p and "w_bogus" not in p
    np.testing.assert_array_equal(
        p["w_k"].numpy(), np.asarray(jparams["layers"][0]["attn"]["w_k"]))
    assert sum(b.numel() for b in tmodel.buffers()) == \
        count_params_analytical(tcfg)
    bad = jax.tree.map(np.asarray, jparams)
    bad["layers"][0]["attn"]["w_q"] = bad["layers"][0]["attn"]["w_q"][:1]
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tcfg, bad)
    assert set(layout(tcfg)) == set(jparams)


def test_init_params_is_seeded():
    cfg = reduced(get_config("qwen3-4b"))
    a = Model.init(cfg, seed=3, device="cpu")
    b = Model.init(cfg, seed=3, device="cpu")
    c = Model.init(cfg, seed=4, device="cpu")
    assert torch.equal(a.params["embedding"], b.params["embedding"])
    assert not torch.equal(a.params["embedding"], c.params["embedding"])
    assert a.init_state_cache(3) == [None] * cfg.num_layers


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16), np.float32)
    scale = rng.standard_normal((16,), np.float32)
    _close(layers.rms_norm(_t(x), _t(scale), 1e-6),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6), 1e-6)
    _close(layers.rope_frequencies(16, 1e6),
           jlayers.rope_frequencies(16, 1e6), 1e-6)
    pos = rng.integers(0, 3000, (2, 5)).astype(np.int32)
    _close(layers.apply_rope(_t(x), _t(pos), 1e6),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6), 1e-5)
    for act in ("silu", "gelu"):
        _close(layers.activation_fn(act)(_t(x)),
               jlayers.activation_fn(act)(jnp.asarray(x)), 1e-6)
    h = rng.standard_normal((3, 8), np.float32)
    mlp = {"w_up": rng.standard_normal((8, 12), np.float32),
           "w_gate": rng.standard_normal((8, 12), np.float32),
           "w_down": rng.standard_normal((12, 8), np.float32)}
    for keys in (("w_up", "w_gate", "w_down"), ("w_up", "w_down")):
        p = {k: mlp[k] for k in keys}
        _close(layers.gated_mlp({k: _t(v) for k, v in p.items()}, _t(h)),
               jlayers.gated_mlp({k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(h)), 1e-5)
    emb = {"embedding": rng.standard_normal((20, 8), np.float32)}
    toks = rng.integers(0, 20, (2, 3)).astype(np.int32)
    _close(layers.embed({"embedding": _t(emb["embedding"])}, _t(toks)),
           jlayers.embed({"embedding": jnp.asarray(emb["embedding"])},
                         jnp.asarray(toks)), 0)
    _close(layers.unembed({"embedding": _t(emb["embedding"])}, _t(h), 17),
           jlayers.unembed({"embedding": jnp.asarray(emb["embedding"])},
                           jnp.asarray(h), 17), 1e-5)


# ---------------------------------------------------------------------------
# paged serving steps
# ---------------------------------------------------------------------------
def _pools(jcfg, tcfg, num_pages=24, ps=8):
    mgr = JPagedKVCacheManager(JPagePoolConfig(num_pages=num_pages,
                                               page_size=ps))
    return (jinit_page_pools(jcfg, mgr.pool),
            init_page_pools(tcfg, PagePoolConfig(num_pages=num_pages,
                                                 page_size=ps)))


def _close_pools(tpools, jpools):
    for tp, jp in zip(tpools, jpools):
        for a, b in zip(tp, jp):
            _close(a, b)


def _prefilled(models, rng):
    """Both packages' pools after prefilling request A (12 tokens, pages
    1-4) and request B (9 tokens, pages 5-8)."""
    jcfg, jmodel, jparams, tcfg, tmodel = models
    jpools, tpools = _pools(jcfg, tcfg)
    state = [None] * tcfg.num_layers
    out = []
    for n, tbl in ((12, [[1, 2, 3, 4]]), (9, [[5, 6, 7, 8]])):
        toks = rng.integers(0, tcfg.vocab_size, (1, n)).astype(np.int32)
        jl, jpools, _ = jmodel.prefill_paged(
            jparams, jnp.asarray(toks), jpools, jmodel.init_state_cache(1),
            jnp.asarray(tbl, jnp.int32), start_pos=jnp.int32(0))
        tl, tpools, _ = tmodel.prefill_paged(
            _t(toks), tpools, state, _t(np.asarray(tbl, np.int32)),
            start_pos=0)
        out.append((tl, jl))
    return jpools, tpools, out


def test_prefill_paged_matches_jax(models):
    jpools, tpools, out = _prefilled(models, np.random.default_rng(1))
    for tl, jl in out:
        _close(tl, jl)
    _close_pools(tpools, jpools)


@pytest.mark.parametrize("path", ["plain", "kernel", "kernel_splitkv"])
def test_decode_step_paged_matches_jax(models, path):
    """The plain attention branch and the kernel hook (on the CPU the
    dispatcher runs the kernels' plain versions; the split threshold of 8
    tokens routes the 4-page tables to the split-KV version) against the
    JAX decode step."""
    jcfg, jmodel, jparams, tcfg, tmodel = models
    rng = np.random.default_rng(2)
    jpools, tpools, _ = _prefilled(models, rng)
    model = copy.copy(tmodel)
    model.attn_kernel = path != "plain"
    model.split_kv_threshold = 8 if path == "kernel_splitkv" else 0
    tok = rng.integers(0, tcfg.vocab_size, (2, 1)).astype(np.int32)
    pos = np.asarray([12, 9], np.int32)
    tbl = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    jl, jpools, _ = jmodel.decode_step_paged(
        jparams, jpools, jmodel.init_state_cache(2), jnp.asarray(tok),
        jnp.asarray(pos), jnp.asarray(tbl))
    tl, tpools, _ = model.decode_step_paged(
        tpools, model.init_state_cache(2), _t(tok), _t(pos), _t(tbl))
    _close(tl, jl)
    _close_pools(tpools, jpools)


def _duet_rows(rng, vocab, C=8, block_q=1):
    """Decode row of request A (pos 12) + a C-row chunk of a new request
    (pages 9-12) in the Algorithm-1 tile order, ``block_q`` rows a tile."""
    tok_dec = rng.integers(0, vocab, (1, 1)).astype(np.int32)
    chunk = rng.integers(0, vocab, (1, C)).astype(np.int32)
    row_tok = np.concatenate([tok_dec[:, 0], chunk[0]])[:, None]
    row_pos = np.concatenate([[12], np.arange(C)]).astype(np.int32)
    row_tbl = np.concatenate([[[1, 2, 3, 4]],
                              np.repeat([[9, 10, 11, 12]], C, axis=0)]
                             ).astype(np.int32)
    sched = build_duet_schedule([(0, 12)], [(1, i) for i in range(C)],
                                block_q=block_q)
    return tok_dec, chunk, row_tok, row_pos, row_tbl, sched


def test_duet_step_paged_matches_jax(models):
    """The fused duet step (duet attention over decode + chunk rows) against
    the JAX duet step, whose attention is the Pallas kernel in interpret
    mode."""
    jcfg, jmodel, jparams, tcfg, tmodel = models
    rng = np.random.default_rng(3)
    jpools, tpools, _ = _prefilled(models, rng)
    _, _, row_tok, row_pos, row_tbl, sched = _duet_rows(rng, tcfg.vocab_size)
    jsched = jbuild_duet_schedule([(0, 12)], [(1, i) for i in range(8)],
                                  block_q=1)
    np.testing.assert_array_equal(sched.row_src, jsched.row_src)
    jl, jpools, _ = jmodel.duet_step_paged(
        jparams, jpools, jmodel.init_state_cache(9), jnp.asarray(row_tok),
        jnp.asarray(row_pos), jnp.asarray(row_tbl),
        jnp.asarray(sched.row_src))
    tl, tpools, _ = tmodel.duet_step_paged(
        tpools, tmodel.init_state_cache(9), _t(row_tok), _t(row_pos),
        _t(row_tbl), _t(sched.row_src))
    _close(tl, jl)
    _close_pools(tpools, jpools)


def test_model_duet_step_matches_sequential(models):
    """Port of the kernel tests' equivalence pin: one ``duet_step_paged``
    call must reproduce the sequential ``decode_step_paged`` +
    ``prefill_paged`` pair — logits of both phases and the page pools they
    wrote. The port's pools are updated in place, so each side starts from
    its own copy."""
    _check_duet_matches_sequential(models, 1)


def _engine_block_q(cfg):
    return duet_block_q(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)


def _check_duet_matches_sequential(models, block_q, C=8):
    jcfg, jmodel, jparams, tcfg, tmodel = models
    rng = np.random.default_rng(11)
    _, pools, _ = _prefilled(models, rng)
    tok_dec, chunk, row_tok, row_pos, row_tbl, sched = _duet_rows(
        rng, tcfg.vocab_size, C, block_q)
    state = tmodel.init_state_cache(1)
    pools_seq = [tuple(t.clone() for t in p) for p in pools]
    logits_dec, pools_seq, _ = tmodel.decode_step_paged(
        pools_seq, state, _t(tok_dec), _t(np.asarray([12], np.int32)),
        _t(np.asarray([[1, 2, 3, 4]], np.int32)))
    logits_pre, pools_seq, _ = tmodel.prefill_paged(
        _t(chunk), pools_seq, state,
        _t(np.asarray([[9, 10, 11, 12]], np.int32)), start_pos=0)
    logits_duet, pools_duet, _ = tmodel.duet_step_paged(
        pools, tmodel.init_state_cache(C + 1), _t(row_tok), _t(row_pos),
        _t(row_tbl), _t(sched.row_src), block_q=block_q)
    _close(logits_duet[0], logits_dec[0], 3e-5)
    _close(logits_duet[C], logits_pre[0], 3e-5)
    for ps_seq, ps_duet in zip(pools_seq, pools_duet):
        for a, b in zip(ps_seq, ps_duet):
            _close(b, a, 3e-6)


@pytest.mark.parametrize("C", [8, 30])
def test_model_duet_step_matches_sequential_at_engine_block_q(models, C):
    """The same pin with the async engine's tiles (``ops.duet_block_q``:
    64 // rep rows, here 32 at the reduced model's rep 2): a 30-row chunk
    fills no tile, so the schedule has pad rows."""
    tcfg = models[3]
    assert _engine_block_q(tcfg) == 64 // (tcfg.num_heads //
                                           tcfg.num_kv_heads)
    _check_duet_matches_sequential(models, _engine_block_q(tcfg), C)


def test_duet_step_paged_engine_tiles_match_jax(models):
    """The port's duet step with the engine's tiles of 64 // rep rows
    against the JAX duet step with the reference's one row a tile (the
    Pallas kernel in interpret mode): the tiling is scheduling only, so
    logits and pools agree within the same fp32 tolerance."""
    jcfg, jmodel, jparams, tcfg, tmodel = models
    rng = np.random.default_rng(13)
    jpools, tpools, _ = _prefilled(models, rng)
    bq = _engine_block_q(tcfg)
    _, _, row_tok, row_pos, row_tbl, sched = _duet_rows(
        rng, tcfg.vocab_size, 8, bq)
    jsched = jbuild_duet_schedule([(0, 12)], [(1, i) for i in range(8)],
                                  block_q=1)
    assert len(sched.row_src) == 2 * bq and (sched.row_src < 0).any()
    jl, jpools, _ = jmodel.duet_step_paged(
        jparams, jpools, jmodel.init_state_cache(9), jnp.asarray(row_tok),
        jnp.asarray(row_pos), jnp.asarray(row_tbl),
        jnp.asarray(jsched.row_src))
    tl, tpools, _ = tmodel.duet_step_paged(
        tpools, tmodel.init_state_cache(9), _t(row_tok), _t(row_pos),
        _t(row_tbl), _t(sched.row_src), block_q=bq)
    _close(tl, jl)
    _close_pools(tpools, jpools)
