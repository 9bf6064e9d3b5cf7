"""Port parity for the MoE FFN: ``repro_torch.models.moe`` against the
JAX ``repro.models.moe`` on the same numpy-seeded inputs, in fp32.

The routing must agree exactly — the same experts chosen, the same
ranks, the same kept and dropped choices — at the default capacity
factor 1.25, where the capacity binds and choices are dropped (each test
asserts that drops occur). The port dispatches in index form (add into an
(E, C, D) buffer, batched matmuls, gather) and the reference in its
default one-hot einsum form, so the FFN's output agrees within 1e-5
(absolute and relative): only the summation order differs. Covered: one
routing group, several groups with a zero-padded last one (T > 1024),
padded experts that the router masks (``num_experts_routed``) and a shared
expert."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import moe as jmoe
from repro_torch.configs import get_config, reduced
from repro_torch.models import moe

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the reduced model's ops are tiny, and with the
    suite's parallel workers sharing the cores, torch's default thread
    team per op slows these tests by an order of magnitude or more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _cfgs(name, **over):
    jcfg = dataclasses.replace(jreduced(jget_config(name)), **over)
    tcfg = dataclasses.replace(reduced(get_config(name)), **over)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _params(cfg, rng):
    """An MoE layer's weights at the reference's init scales (numpy)."""
    D, E, F = cfg.d_model, cfg.num_experts, cfg.moe_d_ff

    def w(*shape, fan_in):
        return (rng.standard_normal(shape, np.float32)
                / np.sqrt(fan_in)).astype(np.float32)
    p = {"router": w(D, E, fan_in=D), "w_gate": w(E, D, F, fan_in=D),
         "w_up": w(E, D, F, fan_in=D), "w_down": w(E, F, D, fan_in=F)}
    if cfg.num_shared_experts:
        Fs = cfg.num_shared_experts * F
        p["shared"] = {"w_gate": w(D, Fs, fan_in=D), "w_up": w(D, Fs, fan_in=D),
                       "w_down": w(Fs, D, fan_in=Fs)}
    return p


def _inputs(rng, *shape):
    """Activations with a common offset: it skews every row's router
    logits the same way, so a few experts overflow their capacity."""
    return rng.standard_normal(shape, np.float32) + np.float32(1.0)


def _torch_tree(p):
    return {k: _torch_tree(v) if isinstance(v, dict) else _t(v)
            for k, v in p.items()}


@pytest.mark.parametrize("T,E,k", [(48, 4, 2), (64, 40, 8), (200, 64, 6)])
def test_route_matches_jax_with_drops(T, E, k):
    """The one-hot form (dispatch, combine) and the index form (gates,
    slot ids, keep) of one routing group, at capacity 1.25."""
    rng = np.random.default_rng(T + E)
    logits = rng.standard_normal((T, E), np.float32) * 2.0
    logits[:, :max(1, E // 8)] += 1.0     # a favoured expert overflows
    C = moe._capacity(T, E, k, 1.25)
    assert C == jmoe._capacity(T, E, k, 1.25)
    jd, jc = jmoe.route(jnp.asarray(logits), k, C)
    td, tc = moe.route(_t(logits), k, C)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6,
                               rtol=1e-6)
    jg, js, jk = jmoe.route_indices(jnp.asarray(logits), k, C)
    tg, ts, tk = moe.route_indices(_t(logits), k, C)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6,
                               rtol=1e-6)
    assert (~tk).sum() > 0, "the capacity never bound"


@pytest.mark.parametrize("cf,tokens", [(1.0, 7), (1.25, 8), (1.25, 1024),
                                       (64.0, 3), (2.0, 5000)])
def test_capacity_matches_jax(cf, tokens):
    for E, k in ((4, 2), (40, 8), (64, 6)):
        assert moe._capacity(tokens, E, k, cf) == \
            jmoe._capacity(tokens, E, k, cf)


def _check_ffn(jcfg, tcfg, x, rng, expect_groups):
    p = _params(tcfg, rng)
    want = np.asarray(jmoe.moe_ffn(jax.tree.map(jnp.asarray, p), jcfg,
                                   jnp.asarray(x)))
    drops = []
    plain = moe.route_indices

    def spy(*a):
        g, s, keep = plain(*a)
        drops.append((keep.shape[0], int((~keep).sum())))
        return g, s, keep
    moe.route_indices = spy
    try:
        got = moe.moe_ffn(_torch_tree(p), tcfg, _t(x)).numpy()
    finally:
        moe.route_indices = plain
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    (groups, dropped), = drops
    assert groups == expect_groups
    assert dropped > 0, "the capacity never bound"
    return p


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m",
                                  "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("B,S", [(1, 40), (3, 1), (2, 96)])
def test_moe_ffn_matches_jax_with_drops(name, B, S):
    """One routing group at the default capacity: a prefill chunk (1, S),
    a decode batch (B, 1) and a (2, 96) batch; deepseek's reduced config
    adds its shared expert."""
    jcfg, tcfg = _cfgs(name)
    assert tcfg.capacity_factor == 1.25
    rng = np.random.default_rng(B * 100 + S)
    x = _inputs(rng, B, S, tcfg.d_model)
    p = _check_ffn(jcfg, tcfg, x, rng, 1)
    assert ("shared" in p) == (tcfg.num_shared_experts > 0)


def test_moe_ffn_matches_jax_over_padded_groups():
    """T = 2500 > MOE_GROUP_SIZE: three groups of 1024, the last padded
    with 572 zero rows, whose uniform router probabilities pick experts
    0..k-1 (ties to the lower index) and so take capacity from the later
    slots of the real rows."""
    assert moe.MOE_GROUP_SIZE == jmoe.MOE_GROUP_SIZE == 1024
    jcfg, tcfg = _cfgs("granite-moe-3b-a800m")
    rng = np.random.default_rng(7)
    x = _inputs(rng, 1, 2500, tcfg.d_model)
    _check_ffn(jcfg, tcfg, x, rng, 3)


def test_moe_ffn_matches_jax_with_padded_experts():
    """Six experts of which four are routable (``num_experts_routed``):
    the two padded ones sit at probability 0 and are never chosen."""
    jcfg, tcfg = _cfgs("deepseek-v2-lite-16b", num_experts=6,
                       num_experts_routed=4)
    rng = np.random.default_rng(11)
    x = _inputs(rng, 2, 40, tcfg.d_model)
    p = _check_ffn(jcfg, tcfg, x, rng, 1)
    logits = torch.einsum("td,de->te", _t(x.reshape(-1, tcfg.d_model)),
                          _t(p["router"]))
    logits[:, 4:] = -1e30
    C = moe._capacity(80, 4, tcfg.moe_top_k, tcfg.capacity_factor)
    _, sid, _ = moe.route_indices(logits, tcfg.moe_top_k, C)
    assert (sid // C).max() < 4


@pytest.mark.parametrize("T,E,k", [(64, 4, 2), (300, 40, 8)])
def test_load_balance_loss_matches_jax(T, E, k):
    rng = np.random.default_rng(T)
    logits = rng.standard_normal((T, E), np.float32)
    want = float(jmoe.load_balance_loss(jnp.asarray(logits), k))
    got = float(moe.load_balance_loss(_t(logits), k))
    assert abs(got - want) <= TOL * abs(want)
