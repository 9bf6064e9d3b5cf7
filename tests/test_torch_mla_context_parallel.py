"""Port parity for context-parallel MLA decode: a rank holds its span of
every MLA latent cache's sequence, as the reference's ``cache_pspecs``
places it (over ``model`` always, over the data axes too at batch 1), and
``mla_decode`` gathers every head's absorbed query over the model group
(``DeviceContext.gather_heads``), attends over its span in the latent
space and combines the sequence group's partials
(``DeviceContext.combine_partials``).

Held, on the CPU, fp32, on reduced deepseek-v2-lite-16b (4 heads, latent
rank 64, layers ``mla`` and ``mla_moe``):

* (i)   ``mla_decode`` on spans against the whole latents, both
        ``absorb`` values, on (data, model) grids of threads that meet in
        the query gather, the combine and the out-projection's sum: rows
        before, inside and past a span and an inactive row; the owner
        rank's latent writes;
* (ii)  two gloo ranks at (data 1, model 2), batch 2: four
        ``decode_step``s from the JAX ``Model.prefill`` cache cut by
        ``shard_cache``, against the JAX ``Model(mla_absorb=...)
        .decode_step`` on the whole cache, both flags (one row's
        positions in rank 0's span only);
* (iii) four gloo ranks at (data 2, model 2), batch 1: the sequence group
        is the world, the query gather runs over ``model`` only; rank 3's
        span holds no key of the row;
* a chunked ``prefill`` into a cut MLA cache raises, and so does
  ``cache_seq_axes`` for a config whose GQA and MLA caches would need two
  sequence groups.

In (ii) and (iii) every rank's logits are bitwise equal and each step
makes two all-gathers an MLA layer. The rank bodies are module-level
functions the spawned ranks import, so this module imports neither
``jax`` nor ``repro`` at its top.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import MLA_KINDS
from repro_torch.core.device import DeviceContext
from repro_torch.kernels.ops import lse_combine
from repro_torch.launch.mesh import Grid, run_ranks
from repro_torch.models import Model, params_from_jax
from repro_torch.models import attention as attn_mod
from repro_torch.models.transformer import (cache_seq_axes, shard_cache,
                                            unshard_cache)

# the JAX decode_step on the whole cache against the port's on its spans
LOGIT_TOL = 1e-5            # x max |logit|, fp32
ATTN_TOL = 1e-5             # x max |out|: the attention output, fp32
DECODE_STEPS = 4
ARCH = "deepseek-v2-lite-16b"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    cfg = reduced(get_config(ARCH))
    assert cfg.block_pattern == ("mla", "mla_moe") and cfg.num_heads == 4
    return cfg


# ---------------------------------------------------------------------------
# (i) spans on a grid of threads
# ---------------------------------------------------------------------------
class _ThreadGrid:
    """A (dp, tp) grid of threads whose sequence group is every rank
    (global rank d * tp + m, as ``launch.mesh``): each rank's context
    meets the others in the query gather (its model peers), the combine
    (every rank) and the out-projection's sum (its model peers), each
    done as the collective does it."""

    def __init__(self, dp, tp):
        self.dp, self.tp, self.n = dp, tp, dp * tp
        self.slots = [None] * self.n
        self.barrier = threading.Barrier(self.n)

    def _exchange(self, r, t):
        self.slots[r] = t
        self.barrier.wait()
        got = list(self.slots)
        self.barrier.wait()
        return got

    def context(self, cfg, r):
        d, m = divmod(r, self.tp)
        peers = range(d * self.tp, (d + 1) * self.tp)
        ctx = DeviceContext(cfg, torch.device("cpu"), tp=self.tp, rank=m,
                            seq=self.n, seq_rank=r)

        def gather_heads(x, dim):
            if not ctx.sharded("heads"):
                return x
            got = self._exchange(r, x)
            ctx.seq_gathers += 1
            return torch.cat([got[p] for p in peers], dim=dim)

        def combine(out, lse):
            packed = torch.cat([out.float(), lse.float()[..., None]], -1)
            gathered = torch.stack(self._exchange(r, packed))
            ctx.seq_gathers += 1
            mx = gathered[..., -1]
            return lse_combine(mx, torch.ones_like(mx), gathered[..., :-1],
                               dim=0)

        def reduce(x):
            got = self._exchange(r, x)
            return torch.stack([got[p] for p in peers]).sum(0)
        ctx.gather_heads = gather_heads
        ctx.combine_partials = combine
        ctx.reduce_from_model = reduce
        return ctx


@pytest.mark.parametrize("absorb", [False, True], ids=["expand", "absorb"])
@pytest.mark.parametrize("dp,tp", [(2, 1), (4, 1), (1, 2), (2, 2)],
                         ids=["data2", "data4", "model2", "data2-model2"])
def test_spans_combine_to_the_whole_latents(dp, tp, absorb):
    cfg = _cfg()
    whole_p = Model.init(cfg, seed=3, device="cpu") \
        .params["layers"][0]["attn"]
    rng = np.random.default_rng(60 + 10 * dp + tp)
    B, S, n = 5, 32, dp * tp
    pos = torch.tensor([3, 12, 20, 31, 9], dtype=torch.int32)
    active = torch.tensor([True, True, True, True, False])
    ckv = torch.from_numpy(rng.standard_normal((B, S, cfg.kv_lora_rank),
                                               np.float32))
    krope = torch.from_numpy(rng.standard_normal((B, S, cfg.qk_rope_dim),
                                                 np.float32))
    x = torch.from_numpy(rng.standard_normal((B, 1, cfg.d_model),
                                             np.float32))
    whole = attn_mod.MLACache(ckv.clone(), krope.clone())
    with torch.no_grad():
        want, _ = attn_mod.mla_decode(whole_p, cfg, x, whole, pos,
                                      absorb=absorb, active_mask=active)
    grid = _ThreadGrid(dp, tp)
    span = S // n
    caches = [attn_mod.MLACache(ckv[:, r * span:(r + 1) * span].clone(),
                                krope[:, r * span:(r + 1) * span].clone())
              for r in range(n)]
    ctxs = [grid.context(cfg, r) for r in range(n)]
    params = [Model.init(cfg, seed=3, ctx=c).params["layers"][0]["attn"]
              for c in ctxs]
    outs, errors = [None] * n, []

    def run(r):
        try:
            with torch.no_grad():
                outs[r], _ = attn_mod.mla_decode(
                    params[r], cfg, x, caches[r], pos, absorb=absorb,
                    active_mask=active, ctx=ctxs[r])
        except BaseException as e:       # noqa: BLE001 (re-raised below)
            errors.append(e)
            grid.barrier.abort()
    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    scale = want.abs().max().item()
    for r in range(n):
        assert torch.equal(outs[r], outs[0])
        assert (outs[r] - want).abs().max().item() <= ATTN_TOL * scale
        # a query gather (heads cut) and a combine
        assert ctxs[r].seq_gathers == (2 if tp > 1 else 1)
    # the owner rank wrote each active row's latents, nobody the others'
    assert torch.equal(torch.cat([c.ckv for c in caches], 1), whole.ckv)
    assert torch.equal(torch.cat([c.krope for c in caches], 1),
                       whole.krope)


def test_gather_heads_is_the_identity_where_heads_are_whole():
    cfg = _cfg()
    x = torch.randn(2, 1, 4, 8)
    assert DeviceContext(cfg, torch.device("cpu")).gather_heads(x, 2) is x
    # 4 heads do not divide 3 ranks: every rank holds them all
    ctx = DeviceContext(cfg, torch.device("cpu"), tp=3, rank=1)
    assert ctx.gather_heads(x, 2) is x and ctx.seq_gathers == 0


def test_prefill_into_a_cut_mla_cache_raises():
    cfg = _cfg()
    ctx = DeviceContext(cfg, torch.device("cpu"), seq=2, seq_rank=1)
    model = Model.init(cfg, ctx=ctx)
    cache = model.init_cache(2, 32)
    assert cache[0].ckv.shape == (2, 16, cfg.kv_lora_rank)
    assert cache[1].krope.shape == (2, 16, cfg.qk_rope_dim)
    # MLA never slides: its span is of max_len under ``sliding`` too
    assert model.init_cache(2, 32, sliding=True)[0].ckv.shape[1] == 16
    tokens = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="sequence-sharded"):
        model.prefill(tokens, cache=cache, start_pos=0)


def test_two_sequence_groups_raise():
    """GQA KV heads that divide the model axis keep their sequence whole
    at batch 2, while MLA's latents are cut over ``model``: no registered
    config mixes the two, and a rank would need two groups."""
    grid = Grid(("data", "model"), (1, 2))
    mixed = dataclasses.replace(_cfg(), block_pattern=("attn", "mla"))
    with pytest.raises(ValueError, match="one sequence group"):
        cache_seq_axes(mixed, grid, 2)


# ---------------------------------------------------------------------------
# (ii), (iii): gloo ranks against the JAX decode_step
# ---------------------------------------------------------------------------
def _mla_rank(rank, cfg, tree, grid_sizes, batch, shards, steps):
    """One rank: ``decode_step`` ``len(steps)`` times from its shard for
    each ``mla_absorb``. Returns each flag's logits, stacked, its
    all-gathers, and the sequence group's size."""
    torch.set_num_threads(1)
    grid = Grid(("data", "model"), grid_sizes)
    ctx = rank.context(cfg, seq_axes=cache_seq_axes(cfg, grid, batch))
    local = ctx.place_params(params_from_jax(cfg, tree))
    out = {"seq": ctx.seq}
    for absorb in (False, True):
        model = Model(cfg, local, ctx=ctx, mla_absorb=absorb)
        cache = [type(c)(*(torch.from_numpy(t.copy()) for t in c))
                 for c in shards[rank.rank]]
        g0, logits = ctx.seq_gathers, []
        with torch.no_grad():
            for tok, pos in steps:
                lg, cache = model.decode_step(
                    cache, torch.from_numpy(tok), torch.from_numpy(pos))
                logits.append(lg.numpy())
        out[absorb] = np.stack(logits)
        out[("gathers", absorb)] = ctx.seq_gathers - g0
    return out


def _to_torch(cache):
    return [attn_mod.MLACache(*(torch.from_numpy(np.array(t)) for t in c))
            for c in cache]


def _run_against_jax(grid, batch, positions, seed):
    """The JAX prefill's whole cache cut by ``shard_cache``, decoded on
    the grid's gloo ranks and by the JAX model with each flag."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import Model as JModel
    cfg = _cfg()
    jcfg = jreduced(jget_config(ARCH))
    S, P = 64, 40
    jm = {a: JModel(jcfg, mla_absorb=a) for a in (False, True)}
    jparams = jm[False].init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, P)).astype(np.int32)
    _, slab = jm[False].prefill(jparams, jnp.asarray(toks),
                                cache=jm[False].init_cache(batch, S))
    steps = [(rng.integers(0, cfg.vocab_size, (batch, 1)).astype(np.int32),
              np.asarray(positions, np.int32) + i)
             for i in range(DECODE_STEPS)]
    whole = _to_torch(slab)
    shards = [shard_cache(whole, cfg, grid, batch, r)
              for r in range(grid.size)]
    back = unshard_cache(shards, cfg, grid, batch)
    assert all(torch.equal(a, b) for ca, cb in zip(back, whole)
               for a, b in zip(ca, cb))
    want = {}
    for absorb in (False, True):
        c, lg = slab, []
        for tok, pos in steps:
            out, c = jm[absorb].decode_step(jparams, c, jnp.asarray(tok),
                                            jnp.asarray(pos))
            lg.append(np.asarray(out))
        want[absorb] = np.stack(lg)
    tree = jax.tree.map(np.asarray, jparams)
    np_shards = [[type(c)(*(t.numpy() for t in c)) for c in sh]
                 for sh in shards]
    tp = grid.shape["model"]
    ranks = run_ranks(_mla_rank, tp, dp=grid.size // tp, device="cpu",
                      args=(cfg, tree, grid.sizes, batch, np_shards, steps))
    n_mla = sum(k in MLA_KINDS for k in cfg.block_pattern)
    for absorb in (False, True):
        V = cfg.vocab_size
        ref = want[absorb][..., :V]
        scale = np.abs(ref).max()
        for res in ranks:
            assert res["seq"] == grid.size
            assert np.array_equal(res[absorb], ranks[0][absorb])
            got = res[absorb][..., :V]
            err = np.abs(got - ref).max()
            assert np.isfinite(got).all() and err <= LOGIT_TOL * scale, \
                (absorb, err, scale)
            # the query gather and the combine, an MLA layer a step
            assert res[("gathers", absorb)] == 2 * n_mla * DECODE_STEPS


def test_tp2_latents_over_model_match_jax():
    """(ii) (data 1, model 2), batch 2: spans of 32; row 1's positions lie
    in rank 0's span only, row 0's in rank 1's."""
    grid = Grid(("data", "model"), (1, 2))
    assert cache_seq_axes(_cfg(), grid, 2) == ("model",)
    _run_against_jax(grid, 2, [40, 10], seed=0)


def test_data2_model2_batch1_latents_over_the_world_match_jax():
    """(iii) (data 2, model 2), batch 1: the sequence is cut over data and
    model (spans of 16, data major), the query gather over model; rank 3's
    span (48..63) holds none of the row's keys."""
    grid = Grid(("data", "model"), (2, 2))
    assert cache_seq_axes(_cfg(), grid, 1) == ("data", "model")
    _run_against_jax(grid, 1, [40], seed=1)
