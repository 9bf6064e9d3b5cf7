"""Port parity for training on the ``(data, model)`` grid of ranks: one
spawn of a 2 x 2 grid of gloo ranks on the CPU (``launch.mesh.run_ranks``
with ``dp=2, tp=2``; one torch thread each), fp32, reduced configs, the
weights from the JAX ``init`` through ``params_from_jax``.

Held, against the JAX package on one device (its own multi-device tests
need forced host devices, which fail in this environment):

* the gradients at TP 2 of every config with a sharded block kind (GQA,
  the MoE cut on its experts, MLA with an MoE, Mamba2 with the shared
  attention block, the vision prefix, the audio codebooks), gathered over
  the model group, leaf by leaf against ``jax.grad`` of the reference's
  ``Model.loss`` on the whole batch, at ``test_grads_match_jax``'s
  tolerance; the leaves every rank holds whole (the MoE router, MLA's
  latent projection, its norm and rope key, Mamba2's B/C projections and
  conv, the q/k norms) equal on both ranks, bit for bit;
* five train steps at DP 2, TP 2 and DP 2 x TP 2 (minicpm-2b on its WSD
  schedule; granite-moe-3b-a800m at 2 sequences of 1024 predicted tokens,
  so each data rank's tokens are one whole MoE routing group, as the
  reference's) against the reference's jitted single-device
  ``make_train_step`` on the whole batch: every step's loss, lr and grad
  norm at ``STEP_TOL``, the gathered parameters after the fifth within
  ``PARAM_TOL_LR`` of the learning rate; the data ranks' parameters equal;
* a checkpoint written at DP 2 x TP 2 (the gathered tree, by global rank
  0) loads into the reference bit-exact, and back into each rank's
  slices;
* ``unshard_params(shard_params(tree)) == tree`` for every registered
  config at TP 2 and 4.

The rank body is a module-level function the spawned ranks import, so
this module imports neither ``jax`` nor ``repro`` at its top.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.core.device import DeviceContext
from repro_torch.data import data_iterator, shard_batch
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import Model, init_params, params_from_jax, trainable
from repro_torch.models.params import (_leaves, _map, cut_dims,
                                       gather_params, shard_params,
                                       unshard_params)
from repro_torch.training import (AdamWConfig, init_adamw, load_checkpoint,
                                  make_train_step, save_checkpoint)
from repro_torch.training.train_loop import batch_to

DP, TP = 2, 2
# tests/test_torch_training.py's tolerances
LOSS_TOL = 1e-5             # relative to the loss
GRAD_TOL = 2e-5             # relative to the leaf's largest |gradient|
RECURRENT_GRAD_TOL = 1e-4   # the chunkwise recurrent blocks, 300 tokens
STEP_TOL = 1e-5             # losses, lr and grad norms of 5 train steps
PARAM_TOL_LR = 0.1          # parameters after 5 steps, a share of lr
# every config with a sharded block kind at TP 2
GRAD_NAMES = ("qwen3-4b", "minicpm-2b", "granite-moe-3b-a800m",
              "deepseek-v2-lite-16b", "zamba2-1.2b", "paligemma-3b",
              "musicgen-medium")
RECURRENT = ("zamba2-1.2b",)
# five-step runs: config -> (batch, sequence length); granite-moe's 2 x
# 1024 predicted tokens are one routing group (MOE_GROUP_SIZE) a sequence
STEP_SHAPES = {"minicpm-2b": (4, 16), "granite-moe-3b-a800m": (2, 1025)}
STEP_NAMES = tuple(STEP_SHAPES)
LAYOUTS = ("dp", "tp", "dpxtp")
STEPS, LR = 5, 1e-3
CKPT_NAME = "minicpm-2b"


def _cfg(name):
    return reduced(get_config(name))


def _seq(cfg):
    """tests/test_torch_training.py's sequence lengths."""
    if cfg.name.split("-reduced")[0] in RECURRENT:
        return 300
    return cfg.num_prefix_tokens + 16 if cfg.frontend == "vision" else 16


def _opt(cfg):
    return AdamWConfig(lr=LR, schedule=cfg.lr_schedule, warmup_steps=2,
                       total_steps=STEPS)


def _numpy(tree):
    return {path: t.detach().numpy().copy() for path, t in _leaves(tree)}


# ---------------------------------------------------------------------------
# what one rank computes
# ---------------------------------------------------------------------------
def _grads(rank, name, tree, batch):
    """TP 2 loss and gradients of ``name`` on the model group: (loss, the
    gathered gradient tree, the whole leaves' gradients as this rank
    holds them)."""
    cfg = _cfg(name)
    ctx = rank.context(cfg)
    model = Model(cfg, trainable(ctx.place_params(params_from_jax(cfg,
                                                                  tree))),
                  ctx=ctx, remat=True)
    loss = model.loss(batch_to(batch, torch.device("cpu")))
    leaves = list(_leaves(model.param_tree()))
    got = dict(zip((p for p, _ in leaves), torch.autograd.grad(
        loss, [t for _, t in leaves])))
    grads = _map(lambda path, _: got[path], model.param_tree())
    dims = cut_dims(cfg, TP)
    whole = {p: g.numpy().copy() for p, g in got.items() if dims[p] is None}
    return float(loss.detach()), _numpy(gather_params(grads, ctx)), whole


def _train(rank, name, tree, layout, ckpt=None):
    """Five steps of ``name`` on ``layout``: DP 2 over this rank's data
    group, TP 2 over its model group, or both. Returns the steps' metrics,
    the gathered parameters and, with ``ckpt``, whether the checkpoint
    reloads into this rank's slices bit for bit."""
    cfg = _cfg(name)
    tp = layout != "dp"
    ctx = rank.context(cfg) if tp else DeviceContext(cfg, "cpu")
    model = Model(cfg, trainable(ctx.place_params(params_from_jax(cfg,
                                                                  tree))),
                  ctx=ctx, remat=True)
    step = make_train_step(model, _opt(cfg), data_group=(
        None if layout == "tp" else rank.data_group))
    params = model.param_tree()
    state = init_adamw(params)
    B, S = STEP_SHAPES[name]
    data = data_iterator(cfg, S, B, seed=0)
    rows = []
    for _ in range(STEPS):
        params, state, m = step(params, state, next(data))
        rows.append({k: float(v) for k, v in m.items()})
    out = {"rows": rows, "params": _numpy(gather_params(params, ctx))}
    if ckpt is not None:
        save_checkpoint(ckpt, params, state, STEPS, ctx=ctx)
        p, s, n = load_checkpoint(ckpt, params, state, ctx=ctx)
        out["reloads"] = n == STEPS and all(
            torch.equal(a, b) for (_, a), (_, b) in zip(
                _leaves([p, s.mu, s.nu]), _leaves([params, state.mu,
                                                   state.nu])))
    return out


def grid_body(rank, trees, batches, ckpt):
    """One rank of the 2 x 2 grid: the TP 2 gradients (model group d takes
    every other config), then the five-step runs: TP 2 (model group d runs
    STEP_NAMES[d]), DP 2 (data group m runs STEP_NAMES[m]) and DP 2 x TP 2
    (every rank runs both)."""
    torch.set_num_threads(1)
    res = {}
    for name in GRAD_NAMES[rank.data_rank::DP]:
        res[("grads", name)] = _grads(rank, name, trees[name],
                                      batches[name])
    res[("tp", STEP_NAMES[rank.data_rank])] = _train(
        rank, STEP_NAMES[rank.data_rank], trees[STEP_NAMES[rank.data_rank]],
        "tp")
    res[("dp", STEP_NAMES[rank.model_rank])] = _train(
        rank, STEP_NAMES[rank.model_rank],
        trees[STEP_NAMES[rank.model_rank]], "dp")
    for name in STEP_NAMES:
        res[("dpxtp", name)] = _train(rank, name, trees[name], "dpxtp",
                                      ckpt if name == CKPT_NAME else None)
    return res


# ---------------------------------------------------------------------------
# the fixture: the reference's gradients and steps, and the grid
# ---------------------------------------------------------------------------
def _jax_setup(name):
    import jax
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import Model as JModel
    jcfg = jreduced(jget_config(name))
    jmodel = JModel(jcfg)
    return jcfg, jmodel, jmodel.init(jax.random.PRNGKey(0))


def _jax_grads(name):
    """(batch, JAX loss, JAX gradients) on test_torch_training's batch."""
    import jax
    import jax.numpy as jnp
    from repro.data import data_iterator as jdata_iterator
    jcfg, jmodel, jparams = _jax_setup(name)
    batch = next(jdata_iterator(jcfg, _seq(jcfg), 2, seed=1))
    loss, grads = jax.jit(jax.value_and_grad(jmodel.loss))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return batch, float(loss), dict(_leaves(jax.tree.map(np.asarray,
                                                         grads)))


def _jax_steps(name):
    """The reference's five jitted single-device steps on the whole
    batches: (metrics rows, final parameters, final params and state as
    checkpoint templates)."""
    import jax
    import jax.numpy as jnp
    from repro.data import data_iterator as jdata_iterator
    from repro.training import optimizer as jopt
    from repro.training import train_loop as jtrain_loop
    jcfg, jmodel, jparams = _jax_setup(name)
    tcfg = _cfg(name)
    kw = dict(lr=LR, schedule=tcfg.lr_schedule, warmup_steps=2,
              total_steps=STEPS)
    step = jax.jit(jtrain_loop.make_train_step(jmodel,
                                               jopt.AdamWConfig(**kw)))
    state = jopt.init_adamw(jparams)
    B, S = STEP_SHAPES[name]
    data = jdata_iterator(jcfg, S, B, 0)
    rows = []
    params = jparams
    for _ in range(STEPS):
        params, state, m = step(params, state, {
            k: jnp.asarray(v) for k, v in next(data).items()})
        rows.append({k: float(m[k]) for k in ("loss", "lr", "grad_norm")})
    return rows, dict(_leaves(jax.tree.map(np.asarray, params))), \
        (params, state)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    import jax
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trees, batches, jgrads, jsteps = {}, {}, {}, {}
    for name in sorted(set(GRAD_NAMES) | set(STEP_NAMES)):
        _, _, jparams = _jax_setup(name)
        trees[name] = jax.tree.map(np.asarray, jparams)
    for name in GRAD_NAMES:
        batches[name], *jgrads[name] = _jax_grads(name)
    for name in STEP_NAMES:
        jsteps[name] = _jax_steps(name)
    ckpt = str(tmp_path_factory.mktemp("grid") / "tp2.npz")
    ranks = run_ranks(grid_body, TP, dp=DP, device="cpu",
                      args=(trees, batches, ckpt))
    torch.set_num_threads(n)
    return dict(ranks=ranks, jgrads=jgrads, jsteps=jsteps, ckpt=ckpt)


def _owner(key):
    """The global rank whose result a check reads: model rank 0 of the
    group that ran ``key``."""
    what, name = key
    if what == "grads":
        return GRAD_NAMES.index(name) % DP * TP
    if what == "tp":
        return STEP_NAMES.index(name) * TP
    if what == "dp":
        return STEP_NAMES.index(name)
    return 0


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", GRAD_NAMES)
def test_tp2_gradients_match_jax(grid, name):
    """Every gathered TP 2 gradient leaf against ``jax.grad`` on the whole
    batch; no leaf without its gradient; the whole leaves' gradients equal
    on both ranks of the model group, bit for bit."""
    g = _owner(("grads", name))
    loss, got, whole = grid["ranks"][g][("grads", name)]
    _, _, whole1 = grid["ranks"][g + 1][("grads", name)]
    jloss, want = grid["jgrads"][name]
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_TOL)
    tol = RECURRENT_GRAD_TOL if name in RECURRENT else GRAD_TOL
    assert set(got) == set(want)
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        scale = max(np.abs(w).max(), 1e-12)
        err = np.abs(got[path] - w).max()
        assert err <= tol * scale, (path, err, scale)
    assert whole and set(whole) == set(whole1)
    for path, w in whole.items():
        assert np.array_equal(w, whole1[path]), path


@pytest.mark.parametrize("name", STEP_NAMES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_grid_train_steps_match_reference(grid, layout, name):
    """Five steps on the layout against the reference's single-device
    steps on the whole batch; every rank of the run holds the same
    parameters (the data ranks' updates agree, the model ranks' gathers
    agree)."""
    key = (layout, name)
    g = _owner(key)
    got = grid["ranks"][g][key]
    rows, want, _ = grid["jsteps"][name]
    for mine, ref in zip(got["rows"], rows):
        for k in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(mine[k], ref[k], rtol=STEP_TOL)
    for path, w in want.items():
        np.testing.assert_allclose(got["params"][path], w,
                                   atol=PARAM_TOL_LR * LR, rtol=0)
    peers = [r for r in range(DP * TP) if key in grid["ranks"][r]]
    assert len(peers) == {"dp": DP, "tp": TP, "dpxtp": DP * TP}[layout]
    for r in peers:
        other = grid["ranks"][r][key]
        assert other["rows"] == got["rows"]
        for path, w in got["params"].items():
            assert np.array_equal(other["params"][path], w), (r, path)


def test_grid_checkpoint_loads_into_the_reference_bit_exact(grid):
    """The DP 2 x TP 2 checkpoint holds the whole tree (global rank 0
    wrote the gathered slices): the reference's loader returns the ranks'
    gathered weights and its step bit for bit, and every rank reloads its
    own slices and moments exactly."""
    import jax
    from repro.training import checkpoint as jcheckpoint
    _, _, (jparams, jstate) = grid["jsteps"][CKPT_NAME]
    p, s, step = jcheckpoint.load_checkpoint(grid["ckpt"], jparams, jstate)
    assert step == STEPS and int(s.step) == STEPS
    mine = grid["ranks"][0][("dpxtp", CKPT_NAME)]
    got = dict(_leaves(jax.tree.map(np.asarray, p)))
    assert set(got) == set(mine["params"])
    for path, w in mine["params"].items():
        assert got[path].dtype == w.dtype
        assert np.array_equal(got[path], w), path
    assert all(r[("dpxtp", CKPT_NAME)]["reloads"] for r in grid["ranks"])


# ---------------------------------------------------------------------------
# host-side pieces (no ranks)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _tree(name):
    cfg = _cfg(name)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", list_configs())
def test_unshard_inverts_shard(name, tp):
    """The ranks' slices concatenate back to the full tree, padded vocab
    rows and experts included (granite-moe's 4 experts at tp 4, one a
    rank; its 3-expert variant padded to 4)."""
    cfg, tree = _tree(name)
    if name == "granite-moe-3b-a800m" and tp == 4:
        from repro_torch.models.params import tp_adjusted_config
        cfg = tp_adjusted_config(dataclasses.replace(cfg, num_experts=3),
                                 tp, pad_experts=True)
        assert cfg.num_experts == 4 and cfg.num_experts_routed == 3
        tree = init_params(cfg, torch.Generator().manual_seed(0))
    parts = [shard_params(tree, cfg, tp, r) for r in range(tp)]
    whole = unshard_params(parts, cfg, tp)
    dims = cut_dims(cfg, tp)
    assert any(d is not None for d in dims.values())
    flat = dict(_leaves(tree))
    for path, t in _leaves(whole):
        assert torch.equal(t, flat[path]), path
        if dims[path] is not None:
            assert dict(_leaves(parts[1]))[path].shape[dims[path]] * tp \
                == t.shape[dims[path]]


def test_shard_batch_takes_the_data_ranks_rows():
    cfg = _cfg("paligemma-3b")
    batch = next(data_iterator(cfg, cfg.num_prefix_tokens + 8, 4, seed=0))
    parts = [shard_batch(batch, d, 2) for d in range(2)]
    for k, v in batch.items():
        assert np.array_equal(np.concatenate([p[k] for p in parts]), v)
        assert len(parts[1][k]) == 2
    with pytest.raises(ValueError, match="does not split over 3"):
        shard_batch(batch, 0, 3)
