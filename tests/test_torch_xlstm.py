"""Port parity for xLSTM: ``repro_torch.models.xlstm`` (mLSTM and sLSTM)
against the JAX ``repro.models.xlstm`` functions of the same names on
reduced xlstm-350m (d_model 256, 4 heads; mLSTM inner width 512, heads of
128; sLSTM heads of 64, FFN 320), with the JAX weights and numpy-seeded
inputs, in fp32. Outputs and states agree within 1e-5 (absolute and
relative), but for the chunkwise mLSTM prefill's output and state, held
at ``MLSTM_PREFILL_TOL`` = 1e-4: the q / k / v projections over the 512-wide
inner dim already differ by 2e-6 between the two packages (summation
order), and the normaliser max(|q·n|, exp(-m)) and the group norm amplify
that; each package's fp32 output lies 3e-5 to 8e-5 from a float64 run of
the port at |y| <= 2.8, so 1e-5 is below fp32's own error there.

Covered: the stabilised chunkwise mLSTM prefill below one chunk (S = 40)
and at S = 300 (two chunks of 256, the second padded by 212 steps whose
input gate is -1e30), each from no cache and from a carried one, the
engine's initial state (zeros, m = 0) against no cache (m = -1e30), the
one-step mLSTM decode, and the sLSTM scan with and without a cache (one
step of it is its decode)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import xlstm as jxlstm
from repro.models.params import init_params as jinit_params
from repro_torch.configs import get_config, reduced
from repro_torch.models import xlstm

TOL = 1e-5
MLSTM_PREFILL_TOL = 1e-4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tree(p):
    return {k: _tree(v) if isinstance(v, dict) else _t(v)
            for k, v in p.items()}


def _cache_close(got, want, tol=TOL):
    for g, w in zip(got, want):
        _close(g, w, tol)


@pytest.fixture(scope="module")
def setup():
    jcfg = jreduced(jget_config("xlstm-350m"))
    tcfg = reduced(get_config("xlstm-350m"))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.block_pattern == ("mlstm", "slstm")
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    jm, js = jparams["layers"][0]["mlstm"], jparams["layers"][1]["slstm"]
    fns = {
        "mprefill": jax.jit(
            lambda p, x, c: jxlstm.mlstm_prefill(p, jcfg, x, c)),
        "mdecode": jax.jit(
            lambda p, x, c: jxlstm.mlstm_decode(p, jcfg, x, c)),
        "slstm": jax.jit(
            lambda p, x, c: jxlstm.slstm_forward(p, jcfg, x, c)),
    }
    return jcfg, tcfg, jm, _tree(jm), js, _tree(js), fns


def _x(rng, cfg, B, S):
    return rng.standard_normal((B, S, cfg.d_model), np.float32)


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("S", [40, 300])
def test_mlstm_prefill_matches_jax(setup, S, carried):
    jcfg, tcfg, jm, tm, js, ts, fns = setup
    rng = np.random.default_rng(S + carried)
    x = _x(rng, tcfg, 2, S)
    jc = tc = None
    if carried:
        x0 = _x(rng, tcfg, 2, 23)
        _, jc = fns["mprefill"](jm, jnp.asarray(x0), None)
        _, tc = xlstm.mlstm_prefill(tm, tcfg, _t(x0))
        _cache_close(tc, jc, MLSTM_PREFILL_TOL)
        tc = xlstm.MLSTMCache(*(_t(a) for a in jc))
    jy, jcache = fns["mprefill"](jm, jnp.asarray(x), jc)
    ty, tcache = xlstm.mlstm_prefill(tm, tcfg, _t(x), tc)
    _close(ty, jy, MLSTM_PREFILL_TOL)
    _cache_close(tcache, jcache, MLSTM_PREFILL_TOL)
    di = int(tcfg.mlstm_proj_factor * tcfg.d_model)
    dh = di // tcfg.num_heads
    assert tuple(tcache.C.shape) == (2, tcfg.num_heads, dh, dh)
    assert tcache.C.dtype == tcache.m.dtype == torch.float32


def test_mlstm_zero_state_agrees_with_no_cache(setup):
    """The engines start the state at m = 0, ``prefill`` without a cache
    at m = -1e30; the stabiliser cancels, so the outputs agree (not
    bit for bit: the two take other exponents)."""
    jcfg, tcfg, jm, tm, js, ts, fns = setup
    rng = np.random.default_rng(5)
    x = _t(_x(rng, tcfg, 1, 30))
    di = int(tcfg.mlstm_proj_factor * tcfg.d_model)
    h, dh = tcfg.num_heads, di // tcfg.num_heads
    zero = xlstm.MLSTMCache(conv=torch.zeros(1, tcfg.ssm_conv - 1, di),
                            C=torch.zeros(1, h, dh, dh),
                            n=torch.zeros(1, h, dh), m=torch.zeros(1, h))
    y0, _ = xlstm.mlstm_prefill(tm, tcfg, x, zero)
    y1, _ = xlstm.mlstm_prefill(tm, tcfg, x)
    _close(y0, y1)
    jy0, _ = fns["mprefill"](jm, jnp.asarray(x.numpy()),
                             jxlstm.MLSTMCache(*(jnp.asarray(a.numpy())
                                                 for a in zero)))
    _close(y0, jy0, MLSTM_PREFILL_TOL)


def test_mlstm_decode_matches_jax_and_continues_prefill(setup):
    """Four decode steps from a 37-token prefill's state against the JAX
    steps; and the port's prefill + decode against one whole prefill of
    the same 41 tokens."""
    jcfg, tcfg, jm, tm, js, ts, fns = setup
    rng = np.random.default_rng(11)
    x = _x(rng, tcfg, 3, 41)
    _, jc = fns["mprefill"](jm, jnp.asarray(x[:, :37]), None)
    tc = xlstm.MLSTMCache(*(_t(a) for a in jc))
    ys = []
    for t in range(37, 41):
        jy, jc = fns["mdecode"](jm, jnp.asarray(x[:, t:t + 1]), jc)
        ty, tc = xlstm.mlstm_decode(tm, tcfg, _t(x[:, t:t + 1]), tc)
        _close(ty, jy)
        _cache_close(tc, jc)
        ys.append(ty)
    whole, wc = xlstm.mlstm_prefill(tm, tcfg, _t(x))
    _close(torch.cat(ys, dim=1), whole[:, 37:])
    _cache_close(tc, wc)


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("S", [1, 40])
def test_slstm_forward_matches_jax(setup, S, carried):
    """The scan at S = 40 and one step (S = 1, the decode), from no cache
    and from the cache a 17-token scan left."""
    jcfg, tcfg, jm, tm, js, ts, fns = setup
    rng = np.random.default_rng(100 + S + carried)
    x = _x(rng, tcfg, 2, S)
    jc = tc = None
    if carried:
        x0 = _x(rng, tcfg, 2, 17)
        _, jc = fns["slstm"](js, jnp.asarray(x0), None)
        _, tc = xlstm.slstm_forward(ts, tcfg, _t(x0))
        _cache_close(tc, jc)
        tc = xlstm.SLSTMCache(*(_t(a) for a in jc))
    jy, jcache = fns["slstm"](js, jnp.asarray(x), jc)
    ty, tcache = xlstm.slstm_forward(ts, tcfg, _t(x), tc)
    _close(ty, jy)
    _cache_close(tcache, jcache)
    assert all(t.dtype == torch.float32 for t in tcache)
