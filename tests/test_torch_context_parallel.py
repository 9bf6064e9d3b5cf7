"""Port parity for context-parallel decode: a rank of a sequence group
holds its span of a GQA cache's sequence (or sliding ring), as the
reference's ``cache_pspecs`` places it, attends over it and the group's
``(out, lse)`` partials are combined (``DeviceContext.combine_partials``).

Held, on the CPU, fp32:

* (i)   the plain span-and-combine path of ``gqa_decode`` and the kernel
        path's plain version (``gqa_decode_kernel``) split into 1, 2 and 4
        spans against the whole-cache ``gqa_decode``, full cache and
        wrapped ring, with rows whose positions fall before, inside and
        past a span and an inactive row; the spans run as threads that
        meet in the combine (the collective itself runs in (iii)-(iv));
* (ii)  ``duet_attention``'s plain version with ``return_lse`` against
        ``kernels/ref.py``'s oracle, at a decode shape with a key offset
        and at granite-20b's block-role rep 48;
* (iii) two gloo ranks at TP 2, reduced paligemma-3b (one KV head, so
        the sequence is cut over ``model``): four ``decode_step``s, the
        kernel path's plain version and the plain path, from the JAX
        ``Model.prefill`` cache cut by ``shard_cache``, against the JAX
        ``Model.decode_step`` on the whole cache (one row's positions in
        rank 0's span only), both ranks' logits bitwise equal;
* (iv)  two gloo ranks at (data 2, model 1), reduced qwen3-4b at batch 1
        with its sliding window of 64, the ring wrapped (positions past
        2 x 64), against the JAX sliding ``decode_step``;
* (v)   ``shard_cache`` / ``unshard_cache`` round trip, the shards'
        shapes against the reference's specs and ``init_cache`` under the
        rank's context, for every assigned arch (MLA raises);
* (vi)  ``lower_one``'s decode records on a (data 2, model 16) grid for
        every assigned arch at full width (cut in depth):
        ``rank_memory.entry_bytes`` equals the spec's arguments but for
        Mamba2's conv tail (the rank's channels) and MLA's whole latents.

The rank bodies are module-level functions the spawned ranks import, so
this module imports neither ``jax`` nor ``repro`` at its top.
"""
import dataclasses
import math
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ASSIGNED_ARCHS, MLA_KINDS
from repro_torch.configs.shapes import SHAPES
from repro_torch.core.device import DeviceContext
from repro_torch.kernels.duet_attention import (duet_attention,
                                                duet_attention_plain)
from repro_torch.kernels.ref import duet_attention_lse_ref
from repro_torch.launch.dryrun import _shard_bytes, lower_one
from repro_torch.launch.mesh import Grid, run_ranks
from repro_torch.models import Model, params_from_jax
from repro_torch.models import attention as attn_mod
from repro_torch.models.params import tp_adjusted_config
from repro_torch.models.transformer import (cache_pspecs, cache_seq_axes,
                                            cache_specs, shard_cache,
                                            unshard_cache)

# the JAX decode_step on the whole cache against the port's on its spans
LOGIT_TOL = 1e-5            # x max |logit|, fp32
ATTN_TOL = 1e-5             # the attention output and lse, fp32
DECODE_STEPS = 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (i) the span split and the combine, spans as threads
# ---------------------------------------------------------------------------
class _ThreadGroup:
    """A sequence group of threads: each rank's combine waits for every
    rank's partial and combines them as ``DeviceContext.combine_partials``
    combines a gathered tensor."""

    def __init__(self, n):
        self.n = n
        self.slots = [None] * n
        self.barrier = threading.Barrier(n)

    def context(self, cfg, r):
        ctx = DeviceContext(cfg, torch.device("cpu"), seq=self.n, seq_rank=r)

        def combine(out, lse):
            packed = torch.cat([out.float(), lse.float()[..., None]], -1)
            self.slots[r] = packed
            self.barrier.wait()
            gathered = torch.stack(self.slots)
            self.barrier.wait()
            from repro_torch.kernels.ops import lse_combine
            m = gathered[..., -1]
            return lse_combine(m, torch.ones_like(m), gathered[..., :-1],
                               dim=0)
        ctx.combine_partials = combine
        return ctx


def _attn_case():
    cfg = reduced(get_config("qwen3-4b"))
    model = Model.init(cfg, seed=3, device="cpu")
    return cfg, model.params["layers"][0]["attn"]


# (the sliding ring has no kernel path, as in the reference)
@pytest.mark.parametrize("sliding,kernel", [(False, False), (False, True),
                                            (True, False)],
                         ids=["full-plain", "full-kernel", "ring-plain"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_spans_combine_to_the_whole_cache(n, sliding, kernel):
    cfg, p = _attn_case()
    rng = np.random.default_rng(40 + n)
    B, W = 5, 32
    G, Dh = cfg.num_kv_heads, cfg.head_dim
    # rows before, inside and past a span; the ring's positions wrapped
    pos = np.array([3, 12, 20, 31, 9]) if not sliding else \
        np.array([5, 40, 70, 100, 37])
    active = torch.tensor([True, True, True, True, False])
    k = torch.from_numpy(rng.standard_normal((B, W, G, Dh), np.float32))
    v = torch.from_numpy(rng.standard_normal((B, W, G, Dh), np.float32))
    x = torch.from_numpy(rng.standard_normal((B, 1, cfg.d_model),
                                             np.float32))
    pos_t = torch.from_numpy(pos).to(torch.int32)
    whole = attn_mod.AttnCache(k.clone(), v.clone())
    with torch.no_grad():
        want, _ = attn_mod.gqa_decode(p, cfg, x, whole, pos_t,
                                      sliding=sliding, active_mask=active)
    group = _ThreadGroup(n)
    span = W // n
    caches = [attn_mod.AttnCache(k[:, r * span:(r + 1) * span].clone(),
                                 v[:, r * span:(r + 1) * span].clone())
              for r in range(n)]
    outs = [None] * n

    def run(r):
        ctx = group.context(cfg, r)
        with torch.no_grad():
            if kernel:
                outs[r], _ = attn_mod.gqa_decode_kernel(
                    p, cfg, x, caches[r], pos_t, active_mask=active,
                    ctx=ctx)
            else:
                outs[r], _ = attn_mod.gqa_decode(
                    p, cfg, x, caches[r], pos_t, sliding=sliding,
                    active_mask=active, ctx=ctx)
    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    scale = want.abs().max().item()
    for r in range(n):
        assert torch.equal(outs[r], outs[0])
        assert (outs[r] - want).abs().max().item() <= ATTN_TOL * scale
    # the cache: the owner rank wrote each active row's new K/V
    assert torch.equal(torch.cat([c.k for c in caches], 1), whole.k)
    assert torch.equal(torch.cat([c.v for c in caches], 1), whole.v)


def test_span_that_does_not_divide_raises():
    cfg, _ = _attn_case()
    ctx = DeviceContext(cfg, torch.device("cpu"), seq=3, seq_rank=1)
    with pytest.raises(ValueError, match="does not split"):
        ctx.seq_span(32)
    assert ctx.seq_span(33) == (11, 11)
    model = Model.init(cfg, device="cpu", ctx=ctx)
    with pytest.raises(ValueError, match="does not split"):
        model.init_cache(2, 32)
    assert model.init_cache(2, 33)[0].k.shape[1] == 11


def test_combine_is_the_identity_at_one_rank():
    cfg, _ = _attn_case()
    ctx = DeviceContext(cfg, torch.device("cpu"))
    out = torch.randn(3, 4, 8)
    assert ctx.combine_partials(out, torch.zeros(3, 4)) is out


# ---------------------------------------------------------------------------
# (ii) duet_attention's plain version with the log-sum-exp
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("H,G,Dh", [(32, 8, 128), (48, 1, 128)],
                         ids=["decode-core", "block-role-rep48"])
def test_duet_attention_plain_lse_matches_oracle(H, G, Dh):
    rng = np.random.default_rng(H)
    B, S, base = 8, 256, 128
    q = torch.from_numpy(rng.standard_normal((B, H, Dh), np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, G, Dh), np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, G, Dh), np.float32))
    # global positions against a span starting at key ``base``: before
    # it (dead), inside it, past it (sees all of it)
    glob = np.array([5, 127, 128, 200, 300, 383, 384, 1000])
    row_pos = torch.from_numpy(glob - base).to(torch.int32)[:, None]
    slot = torch.arange(B, dtype=torch.int32)
    out, lse = duet_attention(q, row_pos, slot, k, v, block_q=1,
                              return_lse=True)
    plain, plain_lse = duet_attention_plain(q, row_pos, slot, k, v,
                                            block_q=1, return_lse=True)
    assert torch.equal(out, plain) and torch.equal(lse, plain_lse)
    assert torch.equal(duet_attention(q, row_pos, slot, k, v, block_q=1),
                       out)
    want, want_lse = duet_attention_lse_ref(q, slot, row_pos[:, 0], k, v)
    live = row_pos[:, 0] >= 0
    assert lse.shape == (B, H) and lse.dtype == torch.float32
    assert torch.isneginf(lse[~live]).all()
    assert (out[~live] == 0).all()
    assert torch.allclose(out[live], want[live], atol=ATTN_TOL,
                          rtol=ATTN_TOL)
    assert torch.allclose(lse[live], want_lse[live], atol=ATTN_TOL,
                          rtol=ATTN_TOL)
    assert torch.isneginf(want_lse[~live]).all()


# ---------------------------------------------------------------------------
# (iii), (iv): ranks over gloo against the JAX decode_step
# ---------------------------------------------------------------------------
def _cp_rank(rank, cfg, tree, grid_sizes, batch, shards, steps, sliding):
    """One rank: ``decode_step`` ``len(steps)`` times from its shard, with
    the kernel hook on (its plain version here) and off. Returns the
    logits of each path, stacked, and the sequence group's size."""
    torch.set_num_threads(1)
    grid = Grid(("data", "model"), grid_sizes)
    ctx = rank.context(cfg, seq_axes=cache_seq_axes(cfg, grid, batch))
    local = ctx.place_params(params_from_jax(cfg, tree))
    out = {"seq": ctx.seq}
    for kernel in (True, False):
        if kernel and sliding:
            continue
        model = Model(cfg, local, ctx=ctx, attn_kernel=kernel)
        cache = [type(c)(*(torch.from_numpy(t.copy()) for t in c))
                 for c in shards[rank.rank]]
        logits = []
        with torch.no_grad():
            for tok, pos in steps:
                lg, cache = model.decode_step(
                    cache, torch.from_numpy(tok), torch.from_numpy(pos),
                    sliding=sliding)
                logits.append(lg.numpy())
        out["kernel" if kernel else "plain"] = np.stack(logits)
        out["gathers"] = ctx.seq_gathers
    return out


def _jax_decode(jmodel, jparams, slab, steps, sliding):
    import jax.numpy as jnp
    want = []
    for tok, pos in steps:
        lg, slab = jmodel.decode_step(jparams, slab, jnp.asarray(tok),
                                      jnp.asarray(pos), sliding=sliding)
        want.append(np.asarray(lg))
    return np.stack(want)


def _np_cache(slab):
    return [type(c)(*(np.asarray(t) for t in c)) for c in slab]


def _to_torch(cache):
    return [attn_mod.AttnCache(*(torch.from_numpy(np.array(t)) for t in c))
            for c in cache]


def _shards(cfg, cache, grid, batch, sliding):
    whole = _to_torch(cache)
    out = []
    for r in range(grid.size):
        sh = shard_cache(whole, cfg, grid, batch, r, sliding=sliding)
        out.append([type(c)(*(t.numpy() for t in c)) for c in sh])
    assert all(torch.equal(a, b) for ca, cb in zip(
        unshard_cache([_to_torch(s) for s in out], cfg, grid, batch,
                      sliding=sliding), whole) for a, b in zip(ca, cb))
    return out


def _held(got, want, vocab):
    got, want = got[..., :vocab], want[..., :vocab]
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert np.isfinite(got).all() and err <= LOGIT_TOL * scale, (err, scale)


def test_tp2_sequence_over_model_matches_jax():
    """(iii) reduced paligemma-3b (KV 1) at TP 2: the sequence is cut over
    ``model``, 32 keys a rank; row 1's positions lie in rank 0's span."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import Model as JModel
    jcfg = jreduced(jget_config("paligemma-3b"))
    cfg = reduced(get_config("paligemma-3b"))
    assert cfg.num_kv_heads == 1
    grid, B, S, P = Grid(("data", "model"), (1, 2)), 2, 64, 40
    assert cache_seq_axes(cfg, grid, B) == ("model",)
    jm = JModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(25)
    toks = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    slab = jm.init_cache(B, S)
    _, slab = jm.prefill(jparams, jnp.asarray(toks), cache=slab)
    steps = [(rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32),
              np.array([P + i, 10 + i], np.int32))
             for i in range(DECODE_STEPS)]
    shards = _shards(cfg, _np_cache(slab), grid, B, False)
    want = _jax_decode(jm, jparams, slab, steps, False)
    tree = jax.tree.map(np.asarray, jparams)
    ranks = run_ranks(_cp_rank, 2, device="cpu",
                      args=(cfg, tree, (1, 2), B, shards, steps, False))
    for path in ("kernel", "plain"):
        for res in ranks:
            assert res["seq"] == 2
            assert np.array_equal(res[path], ranks[0][path])
            _held(res[path], want, cfg.vocab_size)
    # one all-gather a GQA layer a step
    assert ranks[0]["gathers"] == 2 * DECODE_STEPS * cfg.num_layers


def test_data_axis_wrapped_ring_matches_jax():
    """(iv) reduced qwen3-4b at (data 2, model 1), batch 1, sliding window
    64: the ring is cut over ``data`` into spans of 32, after 130 tokens
    (wrapped twice)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import Model as JModel
    jcfg = jreduced(jget_config("qwen3-4b"))
    cfg = reduced(get_config("qwen3-4b"))
    Wn = cfg.sliding_window
    grid, B, P = Grid(("data", "model"), (2, 1)), 1, 2 * 64 + 2
    assert Wn == 64 and cache_seq_axes(cfg, grid, B) == ("data",)
    jm = JModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(26)
    toks = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    ring = jm.init_cache(B, 1 << 19, sliding=True)
    assert ring[0].k.shape[1] == Wn
    for s0 in range(0, P, Wn):
        _, ring = jm.prefill(jparams, jnp.asarray(toks[:, s0:s0 + Wn]),
                             cache=ring, start_pos=s0, sliding=True)
    steps = [(rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32),
              np.array([P + i], np.int32)) for i in range(DECODE_STEPS)]
    shards = _shards(cfg, _np_cache(ring), grid, B, True)
    want = _jax_decode(jm, jparams, ring, steps, True)
    tree = jax.tree.map(np.asarray, jparams)
    ranks = run_ranks(_cp_rank, 1, dp=2, device="cpu",
                      args=(cfg, tree, (2, 1), B, shards, steps, True))
    for res in ranks:
        assert res["seq"] == 2
        assert np.array_equal(res["plain"], ranks[0]["plain"])
        _held(res["plain"], want, cfg.vocab_size)


# ---------------------------------------------------------------------------
# (v) shard_cache / unshard_cache
# ---------------------------------------------------------------------------
V_GRID = Grid(("data", "model"), (2, 4))


@pytest.mark.parametrize("batch", [4, 1], ids=["batch-cut", "batch-1"])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_shard_cache_round_trip_and_shapes(arch, batch):
    cfg = reduced(get_config(arch), num_layers=2 if arch != "zamba2-1.2b"
                  else 4)
    if arch == "granite-20b":        # one KV head: cut over model too
        assert cfg.num_kv_heads == 1
    S = 64
    rng = np.random.default_rng(5)
    whole = [type(c)(*(torch.from_numpy(rng.standard_normal(
        t.shape).astype(np.float32)) for t in c))
        for c in cache_specs(cfg, batch, S, torch.float32)]
    cut = any(k in MLA_KINDS for k in cfg.block_pattern)
    if cut:
        with pytest.raises(NotImplementedError, match="not yet ported"):
            shard_cache(whole, cfg, V_GRID, batch, 0)
        return
    specs = cache_pspecs(cfg, V_GRID, batch)
    shards = [shard_cache(whole, cfg, V_GRID, batch, r)
              for r in range(V_GRID.size)]
    back = unshard_cache(shards, cfg, V_GRID, batch)
    for cw, cb in zip(whole, back):
        for a, b in zip(cw, cb):
            assert torch.equal(a, b)
    for r in (0, 5):
        d, m = divmod(r, 4)
        ctx = DeviceContext(cfg, torch.device("cpu"), tp=4, rank=m,
                            **_seq_kw(cfg, batch, d, m))
        built = Model.init(cfg, device="cpu", ctx=ctx).init_cache(
            shards[r][0][0].shape[0], S)
        for kind, sh, sp, w, b in zip(cfg.block_pattern, shards[r], specs,
                                      whole, built):
            for i, (t, s, wt, bt) in enumerate(zip(sh, sp, w, b)):
                assert t.shape == bt.shape, (kind, i)
                if kind == "mamba2" and i == 0:
                    continue       # the rank's conv channels (not whole)
                assert t.numel() * t.element_size() == \
                    _shard_bytes(wt, s, V_GRID.shape), (kind, i)


def _seq_kw(cfg, batch, d, m):
    axes = cache_seq_axes(cfg, V_GRID, batch)
    on_model, on_data = "model" in axes, any(a != "model" for a in axes)
    n = (2 if on_data else 1) * (4 if on_model else 1)
    r = (d if on_data else 0) * (4 if on_model else 1) + \
        (m if on_model else 0)
    return {"seq": n, "seq_rank": r}


# ---------------------------------------------------------------------------
# (vi) the dry run's decode records on the CP layout
# ---------------------------------------------------------------------------
VI_GRID = Grid(("data", "model"), (2, 16))
# each arch at full width, cut to its first layers (every block kind)
VI_LAYERS = {"zamba2-1.2b": 6, "xlstm-350m": 4}


def _cut(arch):
    full = get_config(arch)
    n = VI_LAYERS.get(arch, 2)
    return dataclasses.replace(full, num_layers=n,
                               block_pattern=full.block_pattern[:n])


def _conv_excess(cfg, shape, grid):
    """The bytes of the reference's whole Mamba2 conv tails that the
    port's rank does not hold (it keeps its own x channels)."""
    from repro_torch.launch.mesh import batch_split
    tp = grid.shape["model"]
    rows = batch_split(grid, shape.global_batch)[1]
    n = sum(k == "mamba2" for k in cfg.block_pattern)
    if not n or cfg.d_inner % tp:
        return 0
    return n * rows * (cfg.ssm_conv - 1) * (cfg.d_inner - cfg.d_inner // tp) \
        * 2


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_dryrun_decode_rank_holds_the_spec_layout(arch, shape):
    cfg = _cut(arch)
    rec = lower_one(arch, shape, grid=VI_GRID, cfg=cfg, verbose=False)
    rank, args = rec["rank_memory"], rec["memory"]["argument_size_in_bytes"]
    # the dry run's config: KV heads repeated where that shards them
    axes = cache_seq_axes(tp_adjusted_config(cfg, VI_GRID.shape["model"]),
                          VI_GRID, SHAPES[shape].global_batch)
    n_attn = sum(k not in MLA_KINDS and k in ("attn", "attn_moe",
                                              "shared_attn")
                 for k in cfg.block_pattern)
    seq = math.prod(VI_GRID.shape[a] for a in axes)
    if any(k in MLA_KINDS for k in cfg.block_pattern):
        # MLA latents keep their whole sequence (not yet ported)
        assert rank["whole_sequence"] == sorted(
            set(k for k in cfg.block_pattern if k in MLA_KINDS))
        assert rank["entry_bytes"] > args
        return
    assert rank["whole_sequence"] == []
    assert rank["entry_bytes"] == args - _conv_excess(
        cfg, SHAPES[shape], VI_GRID)
    # one all-gather a GQA layer where the sequence is cut
    gathers = n_attn if seq > 1 and n_attn else 0
    assert (rec["collectives"]["all-gather"] > 0) == bool(gathers)
