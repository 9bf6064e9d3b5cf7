"""Port parity for Mamba2: ``repro_torch.models.ssm`` and the two layers it
builds on (``causal_conv1d``, ``group_norm``) against the JAX
``repro.models`` functions of the same names on reduced zamba2-1.2b
(d_model 256, 32 SSM heads of 16 channels, state 16, conv width 4), with
the JAX weights and numpy-seeded inputs, in fp32. Outputs and states
agree within 1e-5 (absolute and relative): the two packages differ only in
summation order.

Covered: the conv with and without a carried tail, the group norm, the
SSD prefill below one chunk (S = 40: one padded-to-itself chunk) and at
S = 300 (two chunks of 256, the second padded by 212 steps of dt = 0),
each from no cache and from a carried one (the state a first prefill
left), the engine's initial state (zeros) against no cache, and the
one-step decode."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models.params import init_params as jinit_params
from repro_torch.configs import get_config, reduced
from repro_torch.models import layers, ssm

TOL = 1e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tree(p):
    return {k: _tree(v) if isinstance(v, dict) else _t(v)
            for k, v in p.items()}


def _cache_close(got, want):
    for g, w in zip(got, want):
        _close(g, w)


@pytest.fixture(scope="module")
def setup():
    jcfg = jreduced(jget_config("zamba2-1.2b"))
    tcfg = reduced(get_config("zamba2-1.2b"))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.block_pattern[0] == "mamba2"
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))["layers"][0]["mamba"]
    prefill = jax.jit(lambda p, x, c: jssm.mamba2_prefill(p, jcfg, x, c))
    return jcfg, tcfg, jp, _tree(jp), prefill


def _x(rng, cfg, B, S):
    return rng.standard_normal((B, S, cfg.d_model), np.float32)


@pytest.mark.parametrize("with_prev", [False, True],
                         ids=["no-prev", "prev"])
@pytest.mark.parametrize("S", [1, 7])
def test_causal_conv1d_matches_jax(with_prev, S):
    rng = np.random.default_rng(S)
    B, W, C = 2, 4, 24
    x = rng.standard_normal((B, S, C), np.float32)
    w = rng.standard_normal((W, C), np.float32)
    b = rng.standard_normal((C,), np.float32)
    prev = rng.standard_normal((B, W - 1, C), np.float32) \
        if with_prev else None
    jy, jprev = jlayers.causal_conv1d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if prev is None else jnp.asarray(prev))
    ty, tprev = layers.causal_conv1d(
        _t(x), _t(w), _t(b), None if prev is None else _t(prev))
    _close(ty, jy)
    _close(tprev, jprev)
    # no bias
    jy, _ = jlayers.causal_conv1d(jnp.asarray(x), jnp.asarray(w), None)
    ty, _ = layers.causal_conv1d(_t(x), _t(w), None)
    _close(ty, jy)


@pytest.mark.parametrize("groups", [1, 4, 32])
def test_group_norm_matches_jax(groups):
    rng = np.random.default_rng(groups)
    x = 3.0 * rng.standard_normal((2, 5, 128), np.float32) + 1.0
    scale = rng.standard_normal((128,), np.float32)
    want = jlayers.group_norm(jnp.asarray(x), jnp.asarray(scale), groups,
                              eps=1e-6)
    got = layers.group_norm(_t(x), _t(scale), groups, eps=1e-6)
    _close(got, want)


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("S", [40, 300])
def test_mamba2_prefill_matches_jax(setup, S, carried):
    """One chunk (S = 40) and two with padding (S = 300), from no cache and
    from the cache a 23-token prefill left."""
    jcfg, tcfg, jp, tp, prefill = setup
    rng = np.random.default_rng(S + carried)
    x = _x(rng, tcfg, 2, S)
    jc = tc = None
    if carried:
        x0 = _x(rng, tcfg, 2, 23)
        _, jc = prefill(jp, jnp.asarray(x0), None)
        _, tc = ssm.mamba2_prefill(tp, tcfg, _t(x0))
        _cache_close(tc, jc)
        tc = ssm.MambaCache(*(_t(a) for a in jc))
    jy, jcache = prefill(jp, jnp.asarray(x), jc)
    ty, tcache = ssm.mamba2_prefill(tp, tcfg, _t(x), tc)
    _close(ty, jy)
    _cache_close(tcache, jcache)
    assert tuple(tcache.ssm.shape) == (2, tcfg.ssm_heads, tcfg.ssm_head_dim,
                                       tcfg.ssm_state)
    assert tcache.ssm.dtype == torch.float32


def test_mamba2_prefill_from_zero_state_equals_no_cache(setup):
    """The engines' initial state (zeros) gives what no cache gives."""
    jcfg, tcfg, jp, tp, prefill = setup
    rng = np.random.default_rng(3)
    x = _t(_x(rng, tcfg, 1, 30))
    C = tcfg.d_inner + 2 * tcfg.ssm_state
    zero = ssm.MambaCache(
        conv=torch.zeros(1, tcfg.ssm_conv - 1, C),
        ssm=torch.zeros(1, tcfg.ssm_heads, tcfg.ssm_head_dim,
                        tcfg.ssm_state))
    y0, c0 = ssm.mamba2_prefill(tp, tcfg, x, zero)
    y1, c1 = ssm.mamba2_prefill(tp, tcfg, x)
    torch.testing.assert_close(y0, y1, atol=0, rtol=0)
    for a, b in zip(c0, c1):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_mamba2_decode_matches_jax_and_continues_prefill(setup):
    """Four decode steps from a 37-token prefill's state against the JAX
    steps; and the port's prefill + decode against one whole prefill of
    the same 41 tokens (the recurrence and the SSD form agree)."""
    jcfg, tcfg, jp, tp, prefill = setup
    rng = np.random.default_rng(11)
    x = _x(rng, tcfg, 3, 41)
    _, jc = prefill(jp, jnp.asarray(x[:, :37]), None)
    tc = ssm.MambaCache(*(_t(a) for a in jc))
    decode = jax.jit(lambda p, x, c: jssm.mamba2_decode(p, jcfg, x, c))
    ys = []
    for t in range(37, 41):
        jy, jc = decode(jp, jnp.asarray(x[:, t:t + 1]), jc)
        ty, tc = ssm.mamba2_decode(tp, tcfg, _t(x[:, t:t + 1]), tc)
        _close(ty, jy)
        _cache_close(tc, jc)
        ys.append(ty)
    whole, wc = ssm.mamba2_prefill(tp, tcfg, _t(x))
    _close(torch.cat(ys, dim=1), whole[:, 37:])
    _cache_close(tc, wc)
