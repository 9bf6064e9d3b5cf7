"""Port parity for the dry run (``repro_torch.launch.dryrun``) and what it
is built from: ``configs.shapes``, ``models.params.abstract_params``,
``models.transformer.cache_specs`` / ``cache_pspecs`` and the production
grid's helpers in ``launch.mesh``, held to the reference's
(``repro.configs.shapes``, ``repro.launch.dryrun`` and the functions it
calls).

* Shapes, parameter trees and cache trees equal the reference's leaf for
  leaf (shape and dtype) at full width; the cache's partition specs equal
  the reference's ``PartitionSpec`` entries, and one rank's argument bytes
  the reference's specs' count, for every assigned arch x shape x
  production grid (the reference's spec functions are given a stand-in
  whose ``shape`` is the grid's dict: they read nothing else).
* ``lower_one`` runs each entry point of reduced configs on a (pod 2,
  data 2, model 2) grid: the reference's record keys, FLOPs counted, one
  forward's all-reduces = ``collectives_per_iteration() + 1``; at tp 1 its
  FLOPs (matmul-class ops) lie in [0.75, 1.0] of XLA's
  ``cost_analysis()["flops"]`` for the reference's same step.
* In one subprocess with 8 forced host devices (as
  ``tests/test_dryrun_small.py``), XLA's ``argument_size_in_bytes`` of the
  reference's decode lowering on the (2, 2, 2) mesh equals the port's
  count, and the reference CLI's option strings equal the port's.
"""
import ast
import dataclasses
import inspect
import json
import math
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.configs import input_specs as jinput_specs
from repro.configs import reduced as jreduced
from repro.configs.base import ASSIGNED_ARCHS as J_ASSIGNED_ARCHS
from repro.configs.shapes import SHAPES as J_SHAPES
from repro.configs.shapes import InputShape as JInputShape
from repro.models.params import abstract_params as jabstract_params
from repro.models.params import param_specs as jparam_specs
from repro.models.params import tp_adjusted_config as jtp_adjusted_config
from repro.models.transformer import Model as JModel
from repro.models.transformer import cache_pspecs as jcache_pspecs
from repro.models.transformer import cache_specs as jcache_specs
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro.training.optimizer import init_adamw as jinit_adamw
from repro.training.train_loop import make_train_step as jmake_train_step
from repro_torch.configs import (SHAPES, InputShape, get_config, get_shape,
                                 input_specs, list_configs, reduced)
from repro_torch.configs.base import ASSIGNED_ARCHS, GQA_KINDS, MLA_KINDS
from repro_torch.core.device import DeviceContext
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (Grid, batch_split, data_axes,
                                     make_production_mesh,
                                     split_duet_submeshes)
from repro_torch.models.params import abstract_params, tp_adjusted_config
from repro_torch.models.attention import MLACache
from repro_torch.models.transformer import (cache_pspecs, cache_seq_axes,
                                            cache_specs, shard_cache,
                                            unshard_cache)

REPO = os.path.join(os.path.dirname(__file__), "..")
GRIDS = {"16x16": {"data": 16, "model": 16},
         "2x16x16": {"pod": 2, "data": 16, "model": 16}}
# lower_one on reduced configs: the archs, the (pod, data, model) grid and a
# small shape of each kind (batches split over pod x data)
LOWER_ARCHS = ("qwen3-4b", "deepseek-v2-lite-16b", "zamba2-1.2b",
               "xlstm-350m", "paligemma-3b", "musicgen-medium")
SMALL_GRID = Grid(("pod", "data", "model"), (2, 2, 2))
SMALL = {"decode": InputShape("small_decode", 64, 4, "decode"),
         "prefill": InputShape("small_prefill", 32, 4, "prefill"),
         "train": InputShape("small_train", 32, 4, "train")}
# XLA's argument bytes on the (2, 2, 2) mesh: these archs' decode
XLA_ARCHS = ("qwen3-4b", "deepseek-v2-lite-16b", "zamba2-1.2b")
FLOPS_RANGE = (0.75, 1.0)

XLA_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import jax
    import jax.numpy as jnp
    jax.devices()      # the backend is up with 8 devices before the import
    from repro.launch import dryrun      # (which sets its own XLA_FLAGS)
    from repro.configs import get_config, reduced
    from repro.configs.shapes import InputShape
    from repro.models.params import (abstract_params, param_shardings,
                                     tp_adjusted_config)
    from repro.models.transformer import Model

    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
    shape = InputShape("small_decode", 64, 4, "decode")
    out = {"options": [s for a in dryrun.build_parser()._actions
                       for s in a.option_strings], "args": {}}
    for arch in ARCHS:
        cfg = tp_adjusted_config(reduced(get_config(arch)), 2)
        model = Model(cfg)
        specs = dryrun.input_specs(cfg, shape)
        in_sh = dryrun.batch_shardings(cfg, shape, mesh, specs)

        def step(p, c, t, q):
            return model.decode_step(p, c, t, q)
        compiled = jax.jit(step, in_shardings=(
            param_shardings(cfg, mesh), in_sh["cache"], in_sh["token"],
            in_sh["pos"])).lower(abstract_params(cfg, jnp.bfloat16),
                                 specs["cache"], specs["token"],
                                 specs["pos"]).compile()
        out["args"][arch] = \\
            compiled.memory_analysis().argument_size_in_bytes

    # each device's shard of reduced deepseek's whole MLA latents, placed
    # by the reference's cache_pspecs: its global rank's index
    import numpy as np
    from jax.sharding import NamedSharding
    from repro.models.transformer import cache_pspecs
    cfg = reduced(get_config("deepseek-v2-lite-16b"))
    devs = mesh.devices
    out["mla_shards"] = {}
    for batch in MLA_BATCHES:
        got = out["mla_shards"][str(batch)] = {}
        for layer, entry in enumerate(cache_pspecs(cfg, mesh, batch)):
            for leaf, spec in enumerate(entry):
                whole = mla_leaf(cfg, batch, layer, leaf)
                arr = jax.device_put(whole, NamedSharding(mesh, spec))
                idx = got[f"{layer}/{leaf}"] = {}
                for sh in arr.addressable_shards:
                    assert (np.asarray(sh.data) == whole[sh.index]).all()
                    r = int(np.ravel_multi_index(
                        np.argwhere(devs == sh.device)[0], devs.shape))
                    idx[str(r)] = [list(s.indices(n))[:2] for s, n in
                                   zip(sh.index, whole.shape)]
    print("RESULT " + json.dumps(out))
""")


def _mla_leaf(cfg, batch, layer, leaf):
    """A whole MLA latent leaf (ckv or krope) of MLA_LEN positions, drawn
    from a seed of its own: the same bits in the XLA subprocess."""
    import numpy as np
    width = cfg.kv_lora_rank if leaf == 0 else cfg.qk_rope_dim
    rng = np.random.default_rng([batch, layer, leaf])
    return rng.standard_normal((batch, MLA_LEN, width)).astype(np.float32)


# the batches of the MLA shard case: cut over (pod, data), and batch 1,
# whose latents are cut over (pod, data, model)
MLA_BATCHES, MLA_LEN = (4, 1), 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread a test: under the suite's parallel workers sharing
    the cores, torch's default thread team per op slows the fake runs by
    an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def xla_run():
    """The reference's lowering in a subprocess with 8 forced host devices,
    started when the module's first test starts so it runs beside them."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c",
         f"ARCHS = {list(XLA_ARCHS)!r}\nMLA_BATCHES = {MLA_BATCHES!r}\n"
         f"MLA_LEN = {MLA_LEN}\n" + inspect.getsource(_mla_leaf).replace(
             "def _mla_leaf", "def mla_leaf") + XLA_SCRIPT],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _xla_result(proc) -> dict:
    """The subprocess's result, read once and kept on ``proc``."""
    if not hasattr(proc, "result"):
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        line = [ln for ln in out.splitlines()
                if ln.startswith("RESULT ")][0]
        proc.result = json.loads(line[len("RESULT "):])
    return proc.result


def _tdtype(jdt) -> torch.dtype:
    return getattr(torch, jnp.dtype(jdt).name)


def _jleaves(tree):
    return jax.tree.leaves(tree)


def _same_leaves(got, want):
    """Port meta tensors against the reference's ShapeDtypeStructs, in
    order: shapes and dtypes."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape)
        assert g.dtype == _tdtype(w.dtype)


def _tleaves(tree):
    return torch.utils._pytree.tree_leaves(tree)


# ---------------------------------------------------------------- shapes
def test_shapes_equal_reference():
    assert list(SHAPES) == list(J_SHAPES)
    for name, s in SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(J_SHAPES[name])
        assert get_shape(name) is s
    assert ASSIGNED_ARCHS == J_ASSIGNED_ARCHS


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_input_specs(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name, shape in SHAPES.items():
        for kv, jkv in ((None, None),
                        (torch.float8_e4m3fn, jnp.float8_e4m3fn)):
            got = input_specs(cfg, shape, kv_dtype=kv)
            want = jinput_specs(jcfg, J_SHAPES[name], kv_dtype=jkv)
            assert list(got) == list(want), (name, kv)
            for key in want:
                if key == "cache":
                    assert [type(c).__name__ for c in got[key]] == \
                        [type(c).__name__ for c in want[key]]
                _same_leaves(_tleaves(got[key]), _jleaves(want[key]))


# ------------------------------------------------------------ parameters
@pytest.mark.parametrize("arch", list_configs())
def test_abstract_params(arch):
    got = abstract_params(get_config(arch))
    want = jabstract_params(jget_config(arch), jnp.bfloat16)
    from repro_torch.models.params import _leaves
    leaves = [t for _, t in _leaves(got)]
    _same_leaves(leaves, _jleaves(want))
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    assert nbytes == sum(int(np.prod(w.shape)) * w.dtype.itemsize
                         for w in _jleaves(want))
    f32 = abstract_params(get_config(arch), torch.float32)
    assert {t.dtype for _, t in _leaves(f32)} == {torch.float32}


# ----------------------------------------------------------------- cache
@pytest.mark.parametrize("arch", list_configs())
def test_cache_specs(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for sliding in (False, True):
        for B, S in ((128, 32_768), (1, 524_288)):
            got = cache_specs(cfg, B, S, sliding=sliding)
            want = jcache_specs(jcfg, B, S, jnp.bfloat16, sliding=sliding)
            assert [type(c).__name__ for c in got] == \
                [type(c).__name__ for c in want]
            _same_leaves(_tleaves(got), _jleaves(want))


def _shard_bytes(shape, itemsize, spec, grid: dict) -> int:
    n = 1
    for size, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if entry is None else \
            (entry,) if isinstance(entry, str) else entry
        n *= -(-size // int(np.prod([grid[a] for a in axes])))
    return n * itemsize


def _ref_argument_bytes(jcfg, shape, grid: dict, kv_dtype=None) -> int:
    """One device's argument bytes from the reference's own trees and
    specs, as its ``lower_one`` passes them to ``jax.jit`` (``jcfg``
    already adjusted to the grid's ``model`` size)."""
    stand = SimpleNamespace(shape=grid)
    params = jabstract_params(jcfg, jnp.bfloat16)
    pspecs = jax.tree.leaves(jparam_specs(jcfg, stand),
                             is_leaf=lambda x: isinstance(x, P))
    leaves = [(x, s) for x, s in zip(_jleaves(params), pspecs)]
    if shape.kind == "train":
        opt = jax.eval_shape(jinit_adamw, params)
        leaves += [(x, s) for tree in (opt.mu, opt.nu)
                   for x, s in zip(_jleaves(tree), pspecs)]
        leaves.append((opt.step, P()))
    specs = jinput_specs(jcfg, shape, kv_dtype=kv_dtype)
    dp = tuple(a for a in ("pod", "data") if a in grid)
    for name, spec in specs.items():
        if name == "cache":
            cspecs = jax.tree.leaves(
                jcache_pspecs(jcfg, stand, shape.global_batch,
                              sliding=shape.sliding),
                is_leaf=lambda x: isinstance(x, P))
            leaves += list(zip(_jleaves(spec), cspecs))
        else:
            # the reference's batch_shardings (launch/dryrun.py:83)
            leaves.append((spec, P(dp if shape.global_batch > 1 else None,
                                   *([None] * (len(spec.shape) - 1)))))
    return sum(_shard_bytes(x.shape, x.dtype.itemsize, s, grid)
               for x, s in leaves)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_cache_pspecs_and_argument_bytes(arch):
    for gname, gshape in GRIDS.items():
        stand = SimpleNamespace(shape=gshape)
        grid = Grid(tuple(gshape), tuple(gshape.values()))
        tp = gshape["model"]
        cfg = tp_adjusted_config(get_config(arch), tp)
        jcfg = jtp_adjusted_config(jget_config(arch), tp)
        for name, shape in SHAPES.items():
            for B in (shape.global_batch, 1, 8):
                got = cache_pspecs(cfg, grid, B, sliding=shape.sliding)
                want = jcache_pspecs(jcfg, stand, B, sliding=shape.sliding)
                assert [type(c).__name__ for c in got] == \
                    [type(c).__name__ for c in want]
                for g, w in zip(got, want):
                    for gs, ws in zip(g, w):
                        assert gs == tuple(ws), (gname, name, B)
            assert dryrun.argument_bytes(cfg, shape, grid) == \
                _ref_argument_bytes(jcfg, J_SHAPES[name], gshape), \
                (gname, name)


# ------------------------------------------------------------- lower_one
def _ref_record_keys():
    """The keys of the reference's record and error record, read from its
    source (importing it would force 512 host devices)."""
    tree = ast.parse(open(os.path.join(
        REPO, "src", "repro", "launch", "dryrun.py")).read())
    keys = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and getattr(node.targets[0], "id", None) in ("record", "rec"):
            keys.append({k.value for k in node.value.keys})
    record, error = sorted(keys, key=len, reverse=True)
    return record, error


def _decode_gathers(cfg, shape, ctx) -> int:
    """The all-gathers of a decode step on SMALL_GRID where its caches'
    sequence is cut: the combine of each attention layer, and the query
    gather of each MLA layer whose heads are cut."""
    axes = cache_seq_axes(cfg, SMALL_GRID, shape.global_batch)
    if shape.kind != "decode" or \
            math.prod(SMALL_GRID.shape[a] for a in axes) == 1:
        return 0
    return sum(1 + (k in MLA_KINDS and ctx.sharded("heads"))
               for k in cfg.block_pattern if k in GQA_KINDS + MLA_KINDS)


@pytest.mark.parametrize("kind", list(SMALL))
@pytest.mark.parametrize("arch", LOWER_ARCHS)
def test_lower_one_small_grid(arch, kind):
    cfg = tp_adjusted_config(reduced(get_config(arch)), 2)
    rec = dryrun.lower_one(arch, SMALL[kind], grid=SMALL_GRID,
                           cfg=reduced(get_config(arch)), verbose=False)
    ref_keys, _ = _ref_record_keys()
    assert set(rec) == ref_keys | {"rank_memory"}
    assert rec["mesh"] == "2x2x2" and rec["num_devices"] == 8
    assert rec["entry"] == kind and rec["flops"] > 0
    assert rec["bytes_accessed"] > 0
    assert rec["memory"]["argument_size_in_bytes"] == \
        dryrun.argument_bytes(cfg, SMALL[kind], SMALL_GRID)
    assert rec["memory"]["temp_size_in_bytes"] is None
    rank = rec["rank_memory"]
    assert rank["peak_bytes"] >= rank["entry_bytes"] > 0
    assert rank["temp_bytes"] == rank["peak_bytes"] - rank["entry_bytes"]
    coll = rec["collectives"]
    assert coll["total"] == sum(coll[c] for c in dryrun.COLLECTIVES)
    ctx = DeviceContext(cfg, torch.device("cpu"), tp=2)
    if kind != "train":      # one forward
        assert coll["all-reduce"] > 0
        assert coll["count"] == ctx.collectives_per_iteration() + 1 + \
            _decode_gathers(cfg, SMALL[kind], ctx)
    else:                    # + the gradient mean over the data ranks
        assert coll["count"] > ctx.collectives_per_iteration() + 1


@pytest.mark.parametrize("arch", ("qwen3-4b", "deepseek-v2-lite-16b"))
def test_lower_one_kv_f8_absorbed(arch):
    """--kv-f8 (an fp8 cache, read back at the compute dtype as the
    reference's) and --mla-absorb run; the argument bytes are the
    reference's with its f8 cache."""
    shape = SMALL["decode"]
    rec = dryrun.lower_one(arch, shape, grid=SMALL_GRID,
                           cfg=reduced(get_config(arch)), kv_f8=True,
                           mla_absorb=True, verbose=False)
    assert rec["kv_f8"] and rec["mla_absorb"] and rec["flops"] > 0
    jcfg = jtp_adjusted_config(jreduced(jget_config(arch)), 2)
    jshape = JInputShape(shape.name, shape.seq_len, shape.global_batch,
                         shape.kind)
    assert rec["memory"]["argument_size_in_bytes"] == _ref_argument_bytes(
        jcfg, jshape, SMALL_GRID.shape, kv_dtype=jnp.float8_e4m3fn)


def _ref_flops(arch: str, shape: InputShape) -> float:
    """XLA's FLOPs for the reference's step at tp 1, one device."""
    jcfg = jreduced(jget_config(arch))
    params = jabstract_params(jcfg, jnp.bfloat16)
    jshape = JInputShape(shape.name, shape.seq_len, shape.global_batch,
                         shape.kind, shape.sliding)
    specs = jinput_specs(jcfg, jshape)
    if shape.kind == "decode":
        model = JModel(jcfg)
        lowered = jax.jit(model.decode_step).lower(
            params, specs["cache"], specs["token"], specs["pos"])
    elif shape.kind == "prefill":
        model = JModel(jcfg)
        lowered = jax.jit(lambda p, s: model.prefill(p, **s)).lower(
            params, specs)
    else:
        model = JModel(jcfg, remat=True)
        lowered = jax.jit(jmake_train_step(model, JAdamWConfig())).lower(
            params, jax.eval_shape(jinit_adamw, params), specs)
    cost = lowered.compile().cost_analysis()
    if isinstance(cost, list):
        cost = cost[0]
    return cost["flops"]


@pytest.mark.parametrize("arch,kind", [(a, "decode") for a in LOWER_ARCHS]
                         + [(a, "prefill") for a in LOWER_ARCHS]
                         + [("qwen3-4b", "train")])
def test_flops_against_xla(arch, kind):
    shape = SMALL[kind]
    rec = dryrun.lower_one(arch, shape, grid=Grid(("data", "model"), (1, 1)),
                           cfg=reduced(get_config(arch)), verbose=False)
    assert rec["collectives"]["count"] == 0
    ratio = rec["flops"] / _ref_flops(arch, shape)
    assert FLOPS_RANGE[0] <= ratio <= FLOPS_RANGE[1], ratio


def test_argument_bytes_and_options_against_reference(xla_run):
    got = _xla_result(xla_run)
    for arch in XLA_ARCHS:
        cfg = tp_adjusted_config(reduced(get_config(arch)), 2)
        assert dryrun.argument_bytes(cfg, SMALL["decode"], SMALL_GRID) == \
            got["args"][arch], arch
    assert [s for a in dryrun.build_parser()._actions
            for s in a.option_strings] == got["options"]


def test_shard_cache_cuts_mla_latents_as_xla_places_them(xla_run):
    """Each rank's ``shard_cache`` slice of reduced deepseek's MLA latents
    is its device's shard of ``jax.device_put(whole, NamedSharding(mesh,
    spec))`` on the (2, 2, 2) mesh, spec the reference's
    ``cache_pspecs``'; ``unshard_cache`` joins them back."""
    got = _xla_result(xla_run)["mla_shards"]
    cfg = reduced(get_config("deepseek-v2-lite-16b"))
    for batch in MLA_BATCHES:
        whole = [MLACache(*(torch.from_numpy(_mla_leaf(cfg, batch, i, j))
                            for j in range(2)))
                 for i in range(cfg.num_layers)]
        shards = [shard_cache(whole, cfg, SMALL_GRID, batch, r)
                  for r in range(SMALL_GRID.size)]
        for r, shard in enumerate(shards):
            for i, entry in enumerate(shard):
                for j, t in enumerate(entry):
                    idx = got[str(batch)][f"{i}/{j}"][str(r)]
                    want = whole[i][j][tuple(slice(a, b) for a, b in idx)]
                    assert torch.equal(t, want), (batch, r, i, j)
        # the sequence cut 2 (batch 4) or 8 (batch 1) ways
        assert shards[0][0].ckv.shape[1] == MLA_LEN // (2 if batch > 1
                                                        else 8)
        back = unshard_cache(shards, cfg, SMALL_GRID, batch)
        assert all(torch.equal(a, b) for ca, cb in zip(back, whole)
                   for a, b in zip(ca, cb))


# ------------------------------------------------------------ CLI, grid
def test_cli_writes_one_record(tmp_path):
    out = tmp_path / "dry.jsonl"
    assert dryrun.main(["--arch", "xlstm-350m", "--shape", "decode_32k",
                        "--out", str(out)]) == 0
    recs = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert len(recs) == 1
    assert (recs[0]["arch"], recs[0]["shape"], recs[0]["mesh"]) == \
        ("xlstm-350m", "decode_32k", "16x16")
    jcfg = jtp_adjusted_config(jget_config("xlstm-350m"), 16)
    assert recs[0]["memory"]["argument_size_in_bytes"] == \
        _ref_argument_bytes(jcfg, J_SHAPES["decode_32k"], GRIDS["16x16"])


def test_cli_error_record(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no")
    monkeypatch.setattr(dryrun, "lower_one", boom)
    out = tmp_path / "dry.jsonl"
    assert dryrun.main(["--arch", "qwen3-4b", "--shape", "decode_32k",
                        "--out", str(out)]) == 1
    rec = json.loads(out.read_text())
    assert set(rec) == _ref_record_keys()[1]
    assert rec["error"] == "RuntimeError: no"


def test_production_grid_helpers():
    g, mp = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert g.shape == {"data": 16, "model": 16} and g.size == 256
    assert mp.shape == {"pod": 2, "data": 16, "model": 16} and mp.size == 512
    assert data_axes(g) == ("data",) and data_axes(mp) == ("pod", "data")
    assert data_axes(Grid(("model",), (4,))) == ()


@pytest.mark.parametrize("sizes,batch,axes,rows", [
    ((16, 16), 128, ("data",), 8), ((2, 16, 16), 128, ("pod", "data"), 4),
    ((2, 16, 16), 1, (), 1), ((16, 16), 24, (), 24), ((2, 2, 2), 4,
                                                     ("pod", "data"), 1)])
def test_batch_split_owns_the_batch_rule(sizes, batch, axes, rows):
    """One rule cuts the batch: the rank's rows, the cache's batch entry
    and the inputs' batch entry all follow ``batch_split``."""
    names = ("pod", "data", "model")[-len(sizes):]
    grid = Grid(names, sizes)
    assert batch_split(grid, batch) == (axes, rows)
    entry = None if not axes else axes[0] if len(axes) == 1 else axes
    cfg = get_config("qwen3-4b")
    k = cache_pspecs(cfg, grid, batch)[0].k
    assert k[0] == entry
    shape = InputShape("s", 64, batch, "decode")
    sh = dryrun.batch_shardings(cfg, shape, grid,
                                input_specs(cfg, shape))
    assert sh["token"][0] == (axes or None)


def test_split_duet_submeshes():
    grid = Grid(("data", "model"), (2, 4))
    pre, dec = split_duet_submeshes(grid, 1)
    # global rank d * 4 + m: the last model column of each data row decodes
    np.testing.assert_array_equal(pre, [[0, 1, 2], [4, 5, 6]])
    np.testing.assert_array_equal(dec, [[3], [7]])
    pre, dec = split_duet_submeshes(make_production_mesh(multi_pod=True), 4)
    assert pre.shape == (2, 16, 12) and dec.shape == (2, 16, 4)
    assert sorted(np.concatenate([pre.ravel(), dec.ravel()])) == \
        list(range(512))
    assert dec[1, 3, 0] == 1 * 256 + 3 * 16 + 12
    for bad in (0, 4):
        with pytest.raises(ValueError, match="decode_chips"):
            split_duet_submeshes(grid, bad)
    with pytest.raises(ValueError, match="'model' axis"):
        split_duet_submeshes(Grid(("data",), (4,)), 1)
