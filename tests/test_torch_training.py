"""Port parity for the training path: ``cross_entropy``, ``Model.loss``
and its gradients by autograd, the AdamW update and its schedules, the
train step, the data pipeline, checkpoints and the train CLI, each against
the JAX package (``repro.models``, ``repro.training``, ``repro.data``) on
the same inputs, in fp32 on the CPU.

Every registered config, reduced as the reference reduces it, trains with
the reference's weights carried over by ``params_from_jax``: the loss and
every gradient leaf are held to ``jax.value_and_grad(Model.loss)``. The
two packages differ only in summation order (about 1e-6 of a leaf's
largest gradient); the recurrent configs run 300 tokens, past one
256-step chunk of the chunkwise Mamba2 / mLSTM prefill, whose forward the
port already holds at 1e-4, and get that looser bound on their gradients.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.data import data_iterator as jdata_iterator
from repro.models import Model as JModel
from repro.models import layers as jlayers
from repro.training import checkpoint as jcheckpoint
from repro.training import optimizer as jopt
from repro.training import train_loop as jtrain_loop
from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.data import data_iterator
from repro_torch.launch import train as train_cli
from repro_torch.models import Model, layers, params_from_jax, trainable
from repro_torch.models.params import _leaves
from repro_torch.training import (AdamWConfig, adamw_update, init_adamw,
                                  load_checkpoint, make_train_step,
                                  save_checkpoint, schedule_fn, train)
from repro_torch.training.optimizer import global_norm
from repro_torch.training.train_loop import batch_to

NAMES = list_configs()
RECURRENT = ("zamba2-1.2b", "xlstm-350m")
LOSS_TOL = 1e-5             # relative to the loss
GRAD_TOL = 2e-5             # relative to the leaf's largest |gradient|
RECURRENT_GRAD_TOL = 1e-4   # the chunkwise recurrent blocks, 300 tokens
OPT_TOL = 1e-6              # one AdamW update, fp32
STEP_TOL = 1e-5             # losses, lr and grad norms of 5 train steps
# parameters after 5 train steps, as a share of the learning rate (the
# most one step moves an entry): Adam's m / sqrt(v) has no scale, so an
# entry whose gradient is as small as the rounding noise of its leaf
# (about 1e-6 of the leaf's largest) moves by another fraction of lr in
# each package; 6.4e-5 at lr 1e-3 on 10 of 590k entries here
PARAM_TOL_LR = 0.1


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
    return torch.from_numpy(np.array(x))


def _jcfg_tcfg(name):
    return jreduced(jget_config(name)), reduced(get_config(name))


def _seq(cfg):
    if cfg.name.split("-reduced")[0] in RECURRENT:
        return 300
    return cfg.num_prefix_tokens + 16 if cfg.frontend == "vision" else 16


@functools.lru_cache(maxsize=None)
def _loss_and_grads(name):
    """(JAX loss, port loss, {path: (JAX grad, port grad)}) for one config
    on one batch of the data pipeline."""
    jcfg, tcfg = _jcfg_tcfg(name)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    batch = next(jdata_iterator(jcfg, _seq(jcfg), 2, seed=1))
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    model = Model(tcfg, trainable(params_from_jax(
        tcfg, jax.tree.map(np.asarray, jparams))))
    loss = model.loss(batch_to(batch, torch.device("cpu")))
    leaves = list(_leaves(model.param_tree()))
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    jflat = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    return float(jloss), float(loss.detach()), {
        path: (jflat[path], g.numpy()) for (path, _), g in zip(leaves, grads)}


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,vocab", [((2, 7), 50), ((2, 4, 5), 64)])
def test_cross_entropy_matches_jax(shape, vocab):
    """Mean of logsumexp minus the gold logit, fp32, over any leading
    dims; bf16 logits are upcast first; pad columns at the dtype's minimum
    add nothing."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal(shape + (vocab,)).astype(np.float32) * 3
    logits[..., vocab - 3:] = np.finfo(np.float32).min
    labels = rng.integers(0, vocab - 3, shape).astype(np.int32)
    want = float(jlayers.cross_entropy(jnp.asarray(logits),
                                       jnp.asarray(labels), vocab - 3))
    got = layers.cross_entropy(_t(logits), _t(labels), vocab - 3)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    half = layers.cross_entropy(_t(logits).to(torch.bfloat16), _t(labels),
                                vocab - 3)
    assert half.dtype == torch.float32


@pytest.mark.parametrize("name", NAMES)
def test_loss_matches_jax(name):
    """``Model.loss`` on a data-pipeline batch against the JAX
    ``Model.loss`` on the same weights: causal LM for text, the mean over
    the codebooks for audio, the text suffix after the patch prefix for
    vision."""
    jloss, loss, _ = _loss_and_grads(name)
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_grads_match_jax(name):
    """Every gradient leaf by autograd against ``jax.grad``: every block
    kind's plain prefill path (GQA, the MoE in index form, MLA, Mamba2's
    SSD, the chunkwise mLSTM, the sLSTM scan), the audio codebook tables
    and heads, the tied embedding. No leaf is left without a gradient."""
    tol = RECURRENT_GRAD_TOL if name in RECURRENT else GRAD_TOL
    _, _, grads = _loss_and_grads(name)
    assert grads
    for path, (want, got) in grads.items():
        scale = max(np.abs(want).max(), 1e-12)
        err = np.abs(got - want).max()
        assert err <= tol * scale, (path, err, scale)


def test_remat_gives_the_same_gradients():
    """``remat`` checkpoints each block: the backward recomputes its
    activations and gets the same gradients, bit for bit."""
    cfg = reduced(get_config("qwen3-4b"))
    batch = batch_to(next(data_iterator(cfg, 16, 2, seed=0)),
                     torch.device("cpu"))
    out = []
    for remat in (False, True):
        model = Model.init(cfg, seed=0, device="cpu", requires_grad=True,
                           remat=remat)
        leaves = [t for _, t in _leaves(model.param_tree())]
        out.append(torch.autograd.grad(model.loss(batch), leaves))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_training_forward_writes_no_cache():
    """The training forward leaves the serving state alone: a recurrent
    config's slab cache and the weights are unchanged by a loss and its
    backward."""
    cfg = reduced(get_config("zamba2-1.2b"))
    model = Model.init(cfg, seed=0, device="cpu", requires_grad=True)
    cache = model.init_cache(2, 32)
    before = [t.clone() for c in cache for t in c]
    weights = [t.detach().clone() for _, t in _leaves(model.param_tree())]
    batch = batch_to(next(data_iterator(cfg, 16, 2, seed=0)),
                     torch.device("cpu"))
    model.loss(batch).backward()
    assert all(torch.equal(a, t) for a, t in
               zip(before, (t for c in cache for t in c)))
    assert all(torch.equal(a, t) for a, (_, t) in
               zip(weights, _leaves(model.param_tree())))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_schedule_matches_jax(schedule):
    """The learning rate at every step of a 100-step run (warmup 10; WSD's
    stable phase to step 90, then the ``0.5 ** (10 t)`` tail), within
    1e-6 of itself and 1e-6 of the peak: cosine's ``1 + cos(pi t)`` near
    its end cancels, and there the two packages' fp32 cos differ by an
    ulp (3e-11 here)."""
    kw = dict(lr=1e-3, schedule=schedule, warmup_steps=10, total_steps=100)
    steps = np.arange(100, dtype=np.int32)
    want = np.asarray(jopt.schedule_fn(jopt.AdamWConfig(**kw))(
        jnp.asarray(steps)))
    got = schedule_fn(AdamWConfig(**kw))(_t(steps)).numpy()
    atol = 1e-6 * kw["lr"]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol)
    for s in (0, 9, 10, 89, 90, 95, 99):
        one = schedule_fn(AdamWConfig(**kw))(s)
        np.testing.assert_allclose(float(one), want[s], rtol=1e-6,
                                   atol=atol)


def _tree(rng, scale=1.0):
    return {"a": (rng.standard_normal((4, 3)) * scale).astype(np.float32),
            "layers": [{"w": (rng.standard_normal((5,)) * scale)
                        .astype(np.float32)},
                       {"w": (rng.standard_normal((2, 2)) * scale)
                        .astype(np.float32)}]}


def _torch_tree(tree):
    return jax.tree.map(lambda x: _t(x), tree)


def test_adamw_update_matches_jax():
    """One update with the global-norm clip active (gradient norm about
    20 against a clip of 1): parameters, both moments, the step, the grad
    norm and the learning rate, after a first update with a small gradient
    so that the moments are not zero."""
    rng = np.random.default_rng(0)
    params, g1, g2 = _tree(rng), _tree(rng, 0.01), _tree(rng, 5.0)
    kw = dict(lr=1e-2, schedule="cosine", warmup_steps=2, total_steps=10)
    jcfg, tcfg = jopt.AdamWConfig(**kw), AdamWConfig(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init_adamw(jp)
    tp = _torch_tree(params)
    tstate = init_adamw(tp)
    for g in (g1, g2):
        jp, jstate, jm = jopt.adamw_update(
            jcfg, jax.tree.map(jnp.asarray, g), jstate, jp)
        tp, tstate, tm = adamw_update(tcfg, _torch_tree(g), tstate, tp)
    assert float(jm["grad_norm"]) > 10 * tcfg.grad_clip
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=OPT_TOL)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                               rtol=OPT_TOL)
    assert int(tstate.step) == int(jstate.step) == 2
    for mine, ref in ((tp, jp), (tstate.mu, jstate.mu),
                      (tstate.nu, jstate.nu)):
        ref = dict(_leaves(jax.tree.map(np.asarray, ref)))
        for path, t in _leaves(mine):
            np.testing.assert_allclose(t.numpy(), ref[path], rtol=OPT_TOL,
                                       atol=OPT_TOL)
    np.testing.assert_allclose(
        float(global_norm(_torch_tree(g2))),
        float(jopt.global_norm(jax.tree.map(jnp.asarray, g2))), rtol=1e-6)


@pytest.mark.parametrize("name", ["minicpm-2b", "paligemma-3b"])
def test_train_steps_match_jax(name):
    """Five ``make_train_step`` steps against the reference's jitted
    steps on the same weights and batches: every step's loss, lr and grad
    norm, and every parameter after the fifth, within a tenth of the
    learning rate (see PARAM_TOL_LR) (minicpm on its WSD schedule,
    decaying in the last step; paligemma's vision batches on cosine)."""
    jcfg, tcfg = _jcfg_tcfg(name)
    kw = dict(lr=1e-3, schedule=tcfg.lr_schedule, warmup_steps=2,
              total_steps=5)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = Model(tcfg, trainable(params_from_jax(
        tcfg, jax.tree.map(np.asarray, jparams))))
    jstep = jax.jit(jtrain_loop.make_train_step(jmodel,
                                                jopt.AdamWConfig(**kw)))
    step = make_train_step(model, AdamWConfig(**kw))
    jstate = jopt.init_adamw(jparams)
    params = model.param_tree()
    state = init_adamw(params)
    seq = _seq(tcfg)
    jdata, data = jdata_iterator(jcfg, seq, 2, 0), data_iterator(tcfg, seq,
                                                                 2, 0)
    for _ in range(5):
        jparams, jstate, jm = jstep(
            jparams, jstate, {k: jnp.asarray(v)
                              for k, v in next(jdata).items()})
        params, state, m = step(params, state, next(data))
        for key in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=STEP_TOL)
    want = dict(_leaves(jax.tree.map(np.asarray, jparams)))
    for path, t in _leaves(params):
        np.testing.assert_allclose(t.detach().numpy(), want[path],
                                   atol=PARAM_TOL_LR * kw["lr"], rtol=0)
    assert int(state.step) == 5


def test_train_loop_logs_and_checkpoints(tmp_path):
    """``train``: the reference's log line every ``log_every`` steps and at
    the last, the history of those steps, and a checkpoint every
    ``checkpoint_every`` steps holding the weights and state it returns."""
    cfg = reduced(get_config("qwen3-4b"))
    model = Model.init(cfg, seed=0, device="cpu", requires_grad=True)
    lines, path = [], str(tmp_path / "ck.npz")
    params, state, history = train(
        model, model.param_tree(), data_iterator(cfg, 16, 2, seed=0),
        AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4), 4,
        log_every=2, checkpoint_path=path, checkpoint_every=2,
        log_fn=lines.append)
    assert [step for step, _ in history] == [0, 2, 3]
    assert len(lines) == 3 and lines[0].startswith("step     0 loss ")
    assert " lr " in lines[0] and " gnorm " in lines[0]
    p, s, step = load_checkpoint(path, params, state)
    assert step == 4 and int(s.step) == 4
    for (_, a), (_, b) in zip(_leaves(p), _leaves(params)):
        assert torch.equal(a, b)


def test_train_step_refuses_foreign_or_frozen_params():
    cfg = reduced(get_config("qwen3-4b"))
    frozen = Model.init(cfg, seed=0, device="cpu")
    batch = next(data_iterator(cfg, 8, 1, 0))
    params = frozen.param_tree()
    with pytest.raises(ValueError, match="require grad"):
        make_train_step(frozen, AdamWConfig())(params, init_adamw(params),
                                               batch)
    other = Model.init(cfg, seed=1, device="cpu", requires_grad=True)
    with pytest.raises(ValueError, match="own weights"):
        make_train_step(frozen, AdamWConfig())(
            other.param_tree(), init_adamw(params), batch)


# ---------------------------------------------------------------------------
# data, checkpoints, CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["qwen3-4b", "musicgen-medium",
                                  "paligemma-3b"])
def test_data_iterator_matches_jax(name):
    """Text, audio and vision batches from the same seed equal the
    reference's bit for bit (keys, dtypes, values), three batches in."""
    jcfg, tcfg = _jcfg_tcfg(name)
    seq = tcfg.num_prefix_tokens + 24
    ref, mine = jdata_iterator(jcfg, seq, 3, seed=7), data_iterator(
        tcfg, seq, 3, seed=7)
    for _ in range(3):
        a, b = next(ref), next(mine)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_crosses_packages(writer, tmp_path):
    """A checkpoint of (params, AdamW state, step) written by either
    package loads into the other's templates with every leaf equal:
    the reference's flat keys (``params/...``, ``opt/.mu/...``,
    ``opt/.step``, ``meta/step``)."""
    jcfg, tcfg = _jcfg_tcfg("musicgen-medium")
    jparams = JModel(jcfg).init(jax.random.PRNGKey(3))
    jstate = jopt.init_adamw(jparams)
    jstate = jstate._replace(
        step=jnp.asarray(4, jnp.int32),
        mu=jax.tree.map(lambda x: x * 0.5, jparams),
        nu=jax.tree.map(lambda x: x * x, jparams))
    model = Model(tcfg, trainable(params_from_jax(
        tcfg, jax.tree.map(np.asarray, jparams))))
    params = model.param_tree()
    state = init_adamw(params)
    state = state._replace(step=torch.tensor(4, dtype=torch.int32))
    for mine, ref in ((state.mu, jstate.mu), (state.nu, jstate.nu)):
        ref = dict(_leaves(jax.tree.map(np.asarray, ref)))
        for path, t in _leaves(mine):
            t.copy_(_t(ref[path]))
    path = str(tmp_path / "ck.npz")
    if writer == "port":
        save_checkpoint(path, params, state, step=4)
        p, s, step = jcheckpoint.load_checkpoint(path, jparams, jstate)
        got_p, got_s = (jax.tree.map(np.asarray, x) for x in (p, s))
        want_p = dict(_leaves(jax.tree.map(np.asarray, jparams)))
        want_s = jax.tree.map(np.asarray, jstate)
        for path_, leaf in _leaves(got_p):
            np.testing.assert_array_equal(leaf, want_p[path_])
        for a, b in zip(jax.tree.leaves(got_s), jax.tree.leaves(want_s)):
            np.testing.assert_array_equal(a, b)
    else:
        jcheckpoint.save_checkpoint(path, jparams, jstate, step=4)
        p, s, step = load_checkpoint(path, params, state)
        want = dict(_leaves(jax.tree.map(np.asarray, jparams)))
        for path_, t in _leaves(p):
            assert t.requires_grad
            np.testing.assert_array_equal(t.detach().numpy(), want[path_])
        for mine, ref in ((s.mu, jstate.mu), (s.nu, jstate.nu)):
            ref = dict(_leaves(jax.tree.map(np.asarray, ref)))
            for path_, t in _leaves(mine):
                np.testing.assert_array_equal(t.numpy(), ref[path_])
        assert int(s.step) == 4
    assert step == 4


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_bf16_checkpoint_crosses_packages(writer, tmp_path):
    """A bf16 weight tree (the serving dtype on the card) crosses too.
    The reference writes bf16 leaves as ml_dtypes arrays, which ``np.load``
    gives back as numpy void ``|V2``: the port reads their bit patterns, so
    reference -> port is bit-exact. The port writes bf16 as fp32, and the
    reference's loader, which does not cast, returns those fp32 leaves
    (holding the bf16 values exactly) into its bf16 template."""
    jcfg, tcfg = _jcfg_tcfg("qwen3-4b")
    jparams = jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                           JModel(jcfg).init(jax.random.PRNGKey(5)))
    fp32 = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)),
                        jparams)
    want = dict(_leaves(fp32))
    template = Model(tcfg, params_from_jax(tcfg, fp32)).to(
        torch.bfloat16).param_tree()
    params = dict(_leaves(template))
    path = str(tmp_path / "ck.npz")
    if writer == "port":
        save_checkpoint(path, template, step=2)
        assert np.load(path)["params/final_norm"].dtype == np.float32
        p, _, step = jcheckpoint.load_checkpoint(path, jparams)
        for path_, leaf in _leaves(jax.tree.map(np.asarray, p)):
            assert leaf.dtype == np.float32
            np.testing.assert_array_equal(leaf, want[path_])
    else:
        jcheckpoint.save_checkpoint(path, jparams, step=2)
        assert np.load(path)["params/final_norm"].dtype == np.dtype("V2")
        p, _, step = load_checkpoint(path, template)
        for path_, t in _leaves(p):
            assert t.dtype == torch.bfloat16
            assert torch.equal(t.view(torch.int16),
                               params[path_].view(torch.int16))
    assert step == 2


def test_checkpoint_round_trip_without_opt_state(tmp_path):
    cfg = reduced(get_config("qwen3-4b"))
    model = Model.init(cfg, seed=2, device="cpu")
    path = str(tmp_path / "sub" / "ck.npz")
    assert save_checkpoint(path, model.param_tree(), step=9) == path
    p, s, step = load_checkpoint(path, model.param_tree())
    assert s is None and step == 9
    for (_, a), (_, b) in zip(_leaves(p), _leaves(model.param_tree())):
        assert torch.equal(a, b)


def test_train_cli_loss_falls(capsys):
    """``python -m repro_torch.launch.train --reduced --device cpu``: a
    few steps on minicpm's WSD schedule, the reference's log line, and the
    loss falls."""
    losses = train_cli.main(["--arch", "minicpm-2b", "--reduced",
                             "--device", "cpu", "--steps", "6", "--batch",
                             "2", "--seq", "32"])
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("step    0 loss ") and " lr " in out[0]
    assert out[-1].startswith("step    5 loss ")


def test_train_cli_refuses_parallel_and_missing_card():
    """The refusals that remain: a batch the data ranks do not divide, and
    a missing card (never a quiet move to the CPU, on one device or on a
    grid). A 2 x 2 grid on the CPU trains, and its loss falls."""
    with pytest.raises(SystemExit, match="does not split over --data 2"):
        train_cli.main(["--reduced", "--device", "cpu", "--data", "2",
                        "--batch", "3"])
    if not torch.cuda.is_available():
        for grid in ([], ["--data", "2", "--model", "2"]):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                train_cli.main(["--reduced", "--steps", "1", *grid])
    losses = train_cli.main(["--arch", "minicpm-2b", "--reduced", "--device",
                             "cpu", "--data", "2", "--model", "2", "--steps",
                             "6", "--batch", "2", "--seq", "32"])
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_configs_keep_the_reference_schedules():
    """The schedule each config trains on is the reference's: WSD for
    minicpm-2b, cosine for the rest."""
    for name in NAMES:
        assert get_config(name).lr_schedule == \
            jget_config(name).lr_schedule
    assert get_config("minicpm-2b").lr_schedule == "wsd"
    assert dataclasses.asdict(AdamWConfig()) == \
        dataclasses.asdict(jopt.AdamWConfig())
