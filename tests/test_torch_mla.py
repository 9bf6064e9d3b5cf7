"""Port parity for MLA (DeepSeek-V2 multi-head latent attention): every
MLA function of ``repro_torch.models.attention`` against the JAX
``repro.models.attention`` on reduced deepseek-v2-lite (4 heads, latent
rank 64, rope 16, nope 32, v 64), with the JAX weights and numpy-seeded
inputs, in fp32. Outputs, latents and pools agree within 1e-4 (absolute
and relative): the two packages differ only in summation order.

Covered: the projections (latent norm, rope on q_rope and the one-head
rope key), the full-sequence prefill at 40 tokens and at 1100 (above
ATTN_BLOCK_Q: query blocks with the last one padded at position -1), the
chunked prefill into the slab, the slab decode with the up-projections
expanded and absorbed (and the port's ``active_mask``, against the
reference's decode with the inactive rows' latents restored, as its
look-ahead loop restores them), and the paged decode and prefill."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import attention as jattn
from repro.models.params import init_params as jinit_params
from repro_torch.configs import get_config, reduced
from repro_torch.models import attention as attn

TOL = 1e-4


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
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def setup():
    jcfg = jreduced(jget_config("deepseek-v2-lite-16b"))
    tcfg = reduced(get_config("deepseek-v2-lite-16b"))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.block_pattern[0] == "mla"
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))["layers"][0]["attn"]
    tp = {k: _t(v) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


def _x(rng, cfg, B, S):
    return rng.standard_normal((B, S, cfg.d_model), np.float32)


def test_mla_qkv_prefill_matches_jax(setup):
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(0)
    x = _x(rng, tcfg, 2, 12)
    pos = np.stack([np.arange(12), np.arange(5, 17)]).astype(np.int32)
    want = jattn._mla_qkv_prefill(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = attn._mla_qkv_prefill(tp, tcfg, _t(x), _t(pos))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)


@pytest.mark.parametrize("S", [40, 1100])
def test_mla_prefill_matches_jax(setup, S):
    """40 tokens in one block; 1100 tokens in query blocks of
    ATTN_BLOCK_Q = 1024, the second padded at position -1."""
    assert attn.ATTN_BLOCK_Q == jattn.ATTN_BLOCK_Q == 1024
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(S)
    B = 2 if S < 1024 else 1
    x = _x(rng, tcfg, B, S)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jo, jc = jattn.mla_prefill(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    to, tc = attn.mla_prefill(tp, tcfg, _t(x), _t(pos))
    _close(to, jo)
    _close(tc.ckv, jc.ckv)
    _close(tc.krope, jc.krope)


def _slab_prefilled(setup, rng, S_max=48):
    """Both packages' slabs after two chunks (20 + 12 tokens) of a
    two-slot prefill; the chunk outputs checked on the way."""
    jcfg, tcfg, jp, tp = setup
    B, r, rope = 2, tcfg.kv_lora_rank, tcfg.qk_rope_dim
    jcache = jattn.MLACache(ckv=jnp.zeros((B, S_max, r)),
                            krope=jnp.zeros((B, S_max, rope)))
    tcache = attn.MLACache(ckv=torch.zeros(B, S_max, r),
                           krope=torch.zeros(B, S_max, rope))
    for s0, s1 in ((0, 20), (20, 32)):
        x = _x(rng, tcfg, B, s1 - s0)
        pos = np.broadcast_to(np.arange(s0, s1, dtype=np.int32),
                              (B, s1 - s0))
        jo, jcache = jattn.mla_prefill_cached(jp, jcfg, jnp.asarray(x),
                                              jnp.asarray(pos), jcache)
        to, tcache = attn.mla_prefill_cached(tp, tcfg, _t(x), _t(pos),
                                             tcache)
        _close(to, jo)
    _close(tcache.ckv, jcache.ckv)
    _close(tcache.krope, jcache.krope)
    return jcache, tcache


def test_mla_prefill_cached_matches_jax(setup):
    _slab_prefilled(setup, np.random.default_rng(1))


@pytest.mark.parametrize("absorb", [False, True], ids=["expand", "absorb"])
def test_mla_decode_matches_jax(setup, absorb):
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(2)
    jcache, tcache = _slab_prefilled(setup, rng)
    x = _x(rng, tcfg, 2, 1)
    pos = np.asarray([32, 25], np.int32)
    jo, jcache = jattn.mla_decode(jp, jcfg, jnp.asarray(x), jcache,
                                  jnp.asarray(pos), absorb=absorb)
    to, tcache = attn.mla_decode(tp, tcfg, _t(x), tcache, _t(pos),
                                 absorb=absorb)
    _close(to, jo)
    _close(tcache.ckv, jcache.ckv)
    _close(tcache.krope, jcache.krope)


def test_mla_decode_absorb_matches_expand(setup):
    """Absorbing W_uk / W_uv is algebra only: both decode paths agree."""
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(3)
    _, tcache = _slab_prefilled(setup, rng)
    x = _x(rng, tcfg, 2, 1)
    pos = _t(np.asarray([32, 31], np.int32))
    outs = [attn.mla_decode(tp, tcfg, _t(x), attn.MLACache(
        tcache.ckv.clone(), tcache.krope.clone()), pos, absorb=a)[0]
        for a in (False, True)]
    _close(outs[1], outs[0])


def test_mla_decode_active_mask_matches_jax_freeze(setup):
    """Slot 1 inactive: the port leaves its latent entry as it was; the
    reference writes it and its look-ahead loop restores the slot's rows
    of the whole cache afterwards. The active slot's output and both
    caches agree."""
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(4)
    jcache, tcache = _slab_prefilled(setup, rng)
    x = _x(rng, tcfg, 2, 1)
    pos = np.asarray([32, 10], np.int32)      # slot 1's stale position
    active = np.asarray([True, False])
    jo, jnew = jattn.mla_decode(jp, jcfg, jnp.asarray(x), jcache,
                                jnp.asarray(pos))
    keep = jnp.asarray(active)[:, None, None]
    jnew = jattn.MLACache(*(jnp.where(keep, n, o)
                            for n, o in zip(jnew, jcache)))
    to, tcache = attn.mla_decode(tp, tcfg, _t(x), tcache, _t(pos),
                                 active_mask=_t(active))
    _close(to[0], jo[0])
    _close(tcache.ckv, jnew.ckv)
    _close(tcache.krope, jnew.krope)


def _paged_setup(tcfg, N=16, ps=4):
    r, rope = tcfg.kv_lora_rank, tcfg.qk_rope_dim
    shapes = ((N, ps, r), (N, ps, rope))
    return ([jnp.zeros(s) for s in shapes], [torch.zeros(s) for s in shapes])


@pytest.mark.parametrize("absorb", [False, True], ids=["expand", "absorb"])
def test_mla_paged_matches_jax(setup, absorb):
    """A 14-token paged prefill of request A (pages 1-4) and a 9-token one
    of request B (pages 5-7), then one paged decode step of both and of an
    inactive slot (all-zero table row, writing into the null page)."""
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(5)
    (jc, jr), (tc, tr) = _paged_setup(tcfg)
    for L, tbl in ((14, [[1, 2, 3, 4]]), (9, [[5, 6, 7, 0]])):
        x = _x(rng, tcfg, 1, L)
        pos = np.arange(L, dtype=np.int32)[None]
        tbl = np.asarray(tbl, np.int32)
        jo, (jc, jr) = jattn.mla_prefill_paged(
            jp, jcfg, jnp.asarray(x), jnp.asarray(pos), jc, jr,
            jnp.asarray(tbl))
        to, (tc, tr) = attn.mla_prefill_paged(tp, tcfg, _t(x), _t(pos), tc,
                                              tr, _t(tbl))
        _close(to, jo)
    x = _x(rng, tcfg, 3, 1)
    pos = np.asarray([14, 9, 0], np.int32)
    tbl = np.asarray([[1, 2, 3, 4], [5, 6, 7, 0], [0, 0, 0, 0]], np.int32)
    jo, (jc, jr) = jattn.mla_decode_paged(jp, jcfg, jnp.asarray(x), jc, jr,
                                          jnp.asarray(tbl), jnp.asarray(pos),
                                          absorb=absorb)
    to, (tc, tr) = attn.mla_decode_paged(tp, tcfg, _t(x), tc, tr, _t(tbl),
                                         _t(pos), absorb=absorb)
    _close(to, jo)
    _close(tc, jc)
    _close(tr, jr)
