"""The block role of paged_decode and of the slab duet_attention: the
host's choices and the warpgroup block's walk, on the CPU.

A CTA holding more than 16 (row, head) pairs of a KV group takes the
"block" role. paged_decode's, in bf16 at Dh 64, 128 or 256 over tables of
at least ``ops.PAGED_WG_MIN_KEYS`` keys, runs the warpgroup block of
``csrc/wg_block.cuh`` (wgmma, TMA page copies on an mbarrier ring,
clusters of up to 16 where they give at most 64 CTAs, else of up to 8;
``paged_decode.paged_engine``, ``ops.cluster_cap``); every other block
role, the slab duet_attention's among them, runs prefill_core.cuh's block
in clusters of up to 8. Here:

* the host's choice of role, block, cluster size and grid for every
  registered config's head shape at several batches and table or slab
  widths, made from shapes alone (meta tensors: a device read would
  raise), and granite-20b's batches of 1-8 on clusters of 16 up to 64
  CTAs, else of 8, with the card's cluster residency;
* the tiles of whole pages the block walks (``ops.block_tile_keys``);
* the block's walk in plain PyTorch (``paged_decode_block_plain``): its
  spans at any cluster size from 1 to 16 (split-KV launches clusters of
  any split count up to 8), its rank-order combine, and, in fp32 at rep
  48 and 96, against the JAX package's ``paged_decode`` and
  ``paged_decode_splitkv`` in interpret mode within 1e-5.

Inputs come from seeded numpy generators and feed both packages.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_decode import paged_decode as jpaged_decode
from repro.kernels.paged_decode import \
    paged_decode_splitkv as jpaged_decode_splitkv
from repro_torch.configs import get_config, list_configs
from repro_torch.kernels import ops
from repro_torch.kernels.paged_decode import paged_decode_block_plain

paged_mod = importlib.import_module("repro_torch.kernels.paged_decode")
slab_mod = importlib.import_module("repro_torch.kernels.duet_attention")
TOL = 1e-5
# clusters of C CTAs of the warpgroup block (bf16, Dh 128) an H100 80GB
# HBM3 holds at once, as cudaOccupancyMaxActiveClusters reports them (two
# CTAs an SM; clusters of 16 pack into 14 of the card's GPC slots); the
# same table answers for every kernel here
CARD_CLUSTERS = {1: 264, 2: 132, 4: 66, 8: 28, 16: 14}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread, restored after the module: the suite's parallel
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card(monkeypatch):
    """The wrappers' occupancy queries answered from CARD_CLUSTERS, with no
    card; the calls are recorded."""
    calls = []

    def occupancy(device, dtype, Dh, rows, *rest, stream=0):
        calls.append((dtype, Dh, rows) + rest)
        return CARD_CLUSTERS[rest[-1]], 0, 0
    monkeypatch.setattr(paged_mod, "occupancy", occupancy)
    monkeypatch.setattr(slab_mod, "occupancy", occupancy)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    return calls


def _gqa_configs():
    out = []
    for name in list_configs():
        cfg = get_config(name)
        if cfg.num_kv_heads and cfg.num_heads % cfg.num_kv_heads == 0:
            out.append(name)
    return out


@pytest.mark.parametrize("name", _gqa_configs())
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_host_picks_block_and_grid_from_shapes(card, name, dtype):
    """Role, block, cluster size and grid of paged_decode for a config's
    head shape at tables of 16..512 pages of 16 and batches of 1, 8 and
    32, from meta tensors (no value to read): the role follows rep, the
    block dtype, Dh and the table's keys, C is a power of two under the
    block's cap (16 only on the warpgroup block where it gives at most 64
    CTAs) and the table's width, and the grid fits the card's residency
    unless C is 1."""
    cfg = get_config(name)
    H, G, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rep = H // G
    assert ops.cta_role(rep) == ("block" if rep > 16 else "decode")
    hb, hpc = ops.head_split(rep, 1)
    for P in (16, 64, 128, 256, 512):
        engine = paged_mod.paged_engine(dtype, Dh, 16 * P)
        assert engine == ("warpgroup" if dtype == torch.bfloat16
                          and Dh in (64, 128, 256)
                          and 16 * P >= ops.PAGED_WG_MIN_KEYS else "mma")
        for B in (1, 8, 32):
            cap = ops.cluster_cap(rep, engine, B * G * hb)
            assert cap == (16 if rep > 16 and engine == "warpgroup"
                           and B * G * hb * 16 <= 64 else 8)
            q = torch.empty((B, H, Dh), dtype=dtype, device="meta")
            kp = torch.empty((1, 16, G, Dh), dtype=dtype, device="meta")
            tables = torch.empty((B, P), dtype=torch.int32, device="meta")
            C = paged_mod.cluster_for(q, kp, tables)
            assert C & (C - 1) == 0 and 1 <= C <= min(cap, P)
            assert C == 1 or B * G * hb * C <= C * CARD_CLUSTERS[C]
    assert card and all(c[2] == rep and c[3] in (16, 64, 128, 256, 512)
                        for c in card)


@pytest.mark.parametrize("name", _gqa_configs())
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_slab_host_picks_block_and_grid_from_shapes(card, name, dtype):
    """The slab duet_attention's cluster size for a config's head shape,
    decode tiles (block_q 1) and prefill tiles (block_q 16), slabs of
    1024..8192 keys, from meta tensors: every role, the block role too,
    runs a block of the portable cluster cap (prefill_core.cuh's or the
    decode core), so C is a power of two up to ops.CLUSTER_MAX and the
    slab's 64-key units, and the grid fits the card's residency unless C
    is 1; the occupancy asked for is the role's rows at that C."""
    cfg = get_config(name)
    H, G, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    for bq in (1, 16):
        hb, hpc = ops.head_split(H // G, bq)
        for S in (1024, 4096, 8192):
            for T in (1, 8, 32):
                q = torch.empty((T * bq, H, Dh), dtype=dtype, device="meta")
                tiles = torch.empty((T,), dtype=torch.int32, device="meta")
                ks = torch.empty((1, S, G, Dh), dtype=dtype, device="meta")
                del card[:]
                C = slab_mod.cluster_for(q, tiles, ks, bq)
                assert C & (C - 1) == 0
                assert 1 <= C <= min(ops.CLUSTER_MAX, S // 64)
                assert C == 1 or T * G * hb * C <= C * CARD_CLUSTERS[C]
                assert card and all(c[:3] == (dtype, Dh, bq * hpc)
                                    and c[-1] <= ops.CLUSTER_MAX
                                    for c in card)


@pytest.mark.parametrize("B", [1, 2, 4, 8])
def test_granite_20b_batch_8_fills_the_card(card, B):
    """granite-20b's MQA (48 heads on one KV head, Dh 128) at batches of
    1-8: over tables of 2048 keys and more the bf16 block role runs the
    warpgroup block in clusters of 16 up to a batch of 4 (at most 64
    CTAs), and at a batch of 8 in clusters of 8, 64 CTAs (clusters of 16,
    128 CTAs, read slower there: block_role_sweep.py); over 1024 keys, and
    in fp32, prefill_core's block in clusters of 8."""
    cfg = get_config("granite-20b")
    H, G, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    wide = 16 if B <= 4 else 8
    for dtype, P, want in ((torch.bfloat16, 128, wide),
                           (torch.bfloat16, 256, wide),
                           (torch.bfloat16, 512, wide),
                           (torch.bfloat16, 64, 8),
                           (torch.float32, 512, 8)):
        q = torch.empty((B, H, Dh), dtype=dtype, device="meta")
        kp = torch.empty((1, 16, G, Dh), dtype=dtype, device="meta")
        tables = torch.empty((B, P), dtype=torch.int32, device="meta")
        assert paged_mod.cluster_for(q, kp, tables) == want
    assert B * G * wide == (16 * B if B <= 4 else 64)


@pytest.mark.parametrize("ps,want", [
    (16, (64, 16, 16)), (12, (48, 12, 16)), (8, (64, 8, 8)),
    (32, (64, 32, 32)), (64, (64, 64, 64)), (1, (8, 1, 8)),
    (20, (40, 20, 24)), (100, (50, 50, 64)), (1024, (64, 64, 64)),
    (96, (48, 48, 64)),
])
def test_block_tile_keys(ps, want):
    """A tile of the warpgroup block: whole pages at slots of the page size
    rounded up to 8 rows (every box on a 1024-byte swizzle atom), or one
    box of the largest divisor up to 64 of a longer page."""
    tk, bh, slot = ops.block_tile_keys(ps)
    assert (tk, bh, slot) == want
    assert tk % bh == 0 and tk // bh * slot <= 64
    assert slot % 8 == 0 and bh <= slot
    assert ps % bh == 0 or ps < 64


def _pool(rng, B, H, G, Dh, ps, P):
    N = B * P + 1
    q, kp, vp = (rng.standard_normal(s, np.float32) for s in
                 ((B, H, Dh), (N, ps, G, Dh), (N, ps, G, Dh)))
    tables = (1 + rng.permutation(N - 1)[:B * P]).reshape(B, P).astype(
        np.int32)
    return q, kp, vp, tables


@pytest.mark.parametrize("cluster", [3, 5, 6, 7, 16])
@pytest.mark.parametrize("ps", [16, 12])
def test_paged_walk_spans_tiles_and_rank_order(monkeypatch, ps, cluster):
    """The paged walk at 3, 5, 6, 7 (split-KV's split counts that are not
    powers of two) and 16 ranks: rank r walks span r of the request's live
    pages (ops.cluster_spans), in tiles of ops.block_tile_keys keys from
    the span's first key, and the partials of all the cluster's ranks
    combine in rank order."""
    rng = np.random.default_rng(5)
    q, kp, vp, tables = _pool(rng, 2, 48, 1, 32, ps, 24)
    lengths = np.asarray([5, 250], np.int32)
    seen, order = [], []
    online, combine = paged_mod.online_tiles, paged_mod.rank_combine

    def record(qt, lim, chunks, *rest):
        seen.append([(int(c[0]), int(c[-1]) + 1) for c in chunks])
        return online(qt, lim, chunks, *rest)

    def record_combine(m, l, acc):
        order.append(m.shape[0])
        return combine(m, l, acc)
    monkeypatch.setattr(paged_mod, "online_tiles", record)
    monkeypatch.setattr(paged_mod, "rank_combine", record_combine)
    paged_decode_block_plain(*(torch.from_numpy(a) for a in (q, kp, vp)),
                             torch.from_numpy(tables),
                             torch.from_numpy(lengths), cluster=cluster)
    tk = ops.block_tile_keys(ps)[0]
    want = []
    for n in lengths:
        live = -(-int(n) // ps)
        for p0, p1 in ops.cluster_spans(live, cluster):
            k0, k1 = p0 * ps, min(p1 * ps, int(n))
            want.append([(s, min(s + tk, k1)) for s in range(k0, k1, tk)])
    assert seen == want and order == [cluster, cluster]


@pytest.mark.parametrize("H", [48, 96], ids=["rep48", "rep96"])
@pytest.mark.parametrize("ps", [8, 12])
def test_paged_walk_matches_jax(H, ps):
    """The paged walk in fp32 at rep 48 and 96 (two head blocks on the
    card) against the JAX paged_decode (16 ranks) and paged_decode_splitkv
    at 3 and 7 splits (the split count's ranks, as the card launches
    split-KV) in interpret
    mode, contexts 1, 17 and 64 of 8 pages' capacity."""
    rng = np.random.default_rng(7)
    q, kp, vp, tables = _pool(rng, 3, H, 1, 32, ps, 8)
    lengths = np.asarray([1, 17, 64], np.int32)
    tq, tk, tv, tt, tl = (torch.from_numpy(a)
                          for a in (q, kp, vp, tables, lengths))
    jargs = tuple(jnp.asarray(a) for a in (q, kp, vp, tables, lengths))
    for cluster, want in (
            (16, jpaged_decode(*jargs, interpret=True)),
            (3, jpaged_decode_splitkv(*jargs, num_splits=3,
                                      interpret=True)),
            (7, jpaged_decode_splitkv(*jargs, num_splits=7,
                                      interpret=True))):
        got = paged_decode_block_plain(tq, tk, tv, tt, tl, cluster=cluster)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=TOL, rtol=TOL)
