"""Every GQA head shape the Pallas kernels take, on the CPU: the plain
versions of the port's five kernels against the JAX package (the Pallas
kernels in interpret mode, or ``repro.kernels.ref``) at rep 3, 5 and 48
(MQA), rep 1 at Dh 64 and rep 8 at Dh 256; the tile schedules the CUDA
kernels run (``flash_prefill_tiled_plain``,
``duet_attention_paged_tiled_plain``) at the same shapes; and the host's
choice of each CTA's role and head blocks, which the card's occupancy
query and cluster size follow.

Inputs come from seeded numpy generators and feed both packages; bf16
cases round the same float32 values in both. Tolerances are the kernel
tests' ``TOL`` (float32 2e-5, bfloat16 2e-2); the paged duet tile
schedule is held to its plain version at ``tests/test_torch_duet.py``'s
(atol, rtol) pairs."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.duet_attention import duet_attention as jduet_attention
from repro.kernels.duet_attention import \
    duet_attention_paged as jduet_attention_paged
from repro.kernels.flash_prefill import flash_prefill as jflash_prefill
from repro.kernels.paged_decode import paged_decode as jpaged_decode
from repro_torch.kernels import ops
from repro_torch.kernels.duet_attention import (
    duet_attention, duet_attention_paged, duet_attention_paged_tiled_plain,
    duet_tile_plan, slab_role)
from repro_torch.kernels.flash_prefill import (flash_prefill_plain,
                                               flash_prefill_tiled_plain)
from repro_torch.kernels.paged_decode import (paged_decode,
                                              paged_decode_cluster_plain,
                                              paged_decode_splitkv)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DUET_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (5e-3, 1e-2)}
# (H, G, Dh): rep 3 (granite-moe), rep 5 (qwen3-14b), rep 48 (granite-20b,
# MQA), rep 1 at Dh 64 (minicpm-2b), rep 8 at Dh 256
HEADS = [(6, 2, 32), (10, 2, 32), (48, 1, 32), (4, 4, 64), (8, 1, 256)]
IDS = ["rep3", "rep5", "rep48", "rep1-Dh64", "rep8-Dh256"]

paged_decode_ref = jax.jit(jref.paged_decode_ref)
# the kernel modules (the package binds their wrappers under the same names)
duet_mod = importlib.import_module("repro_torch.kernels.duet_attention")
pd_mod = importlib.import_module("repro_torch.kernels.paged_decode")


def _both(arr, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(arr, jd), torch.from_numpy(arr).to(td)


def _close(got_t, want_j, dtype):
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_j, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,G,Dh", HEADS, ids=IDS)
def test_paged_decode_plain_versions_match_jax(H, G, Dh, dtype):
    """paged_decode's plain version against the Pallas kernel (interpret
    mode), and split-KV's and the cluster's span split against the
    gathered-chain oracle, contexts 1, 17 and 64."""
    rng = np.random.default_rng(0)
    B, N, ps, P = 3, 32, 8, 8
    q, kp, vp = (rng.standard_normal(s, np.float32) for s in
                 ((B, H, Dh), (N, ps, G, Dh), (N, ps, G, Dh)))
    tables = (1 + rng.permutation(N - 1)[:B * P]).reshape(B, P).astype(
        np.int32)
    lengths = np.asarray([1, 17, 64], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, kp, vp))
    jt, tt = jnp.asarray(tables), torch.from_numpy(tables)
    jl, tl = jnp.asarray(lengths), torch.from_numpy(lengths)
    _close(paged_decode(tq, tk, tv, tt, tl),
           jpaged_decode(jq, jk, jv, jt, jl, interpret=True), dtype)
    want = paged_decode_ref(jq, jk, jv, jt, jl)
    _close(paged_decode_splitkv(tq, tk, tv, tt, tl, num_splits=3), want,
           dtype)
    _close(paged_decode_cluster_plain(tq, tk, tv, tt, tl, cluster=4), want,
           dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,G,Dh", HEADS, ids=IDS)
def test_flash_prefill_plain_versions_match_jax(H, G, Dh, dtype):
    """flash_prefill's plain version and its tile schedule (blocks of
    64 // rep positions; 63 of 64 rows at rep 3, 60 at rep 5, one position
    at rep 48) against the Pallas kernel in interpret mode on a chunk at
    position 32 with a kv_len cut, and against the reference oracle on a
    ragged shape."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal(s, np.float32) for s in
               ((1, 32, H, Dh), (1, 64, G, Dh), (1, 64, G, Dh)))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    want = jflash_prefill(jq, jk, jv, q_offset=32, kv_len=50, block_q=16,
                          block_k=32, interpret=True)
    for fn in (flash_prefill_plain, flash_prefill_tiled_plain):
        _close(fn(tq, tk, tv, q_offset=32, kv_len=50), want, dtype)
    # ragged: 23 queries at 40 over 70 keys
    q2 = rng.standard_normal((1, 23, H, Dh), np.float32)
    (jq2, tq2) = _both(q2, dtype)
    want = jref.flash_prefill_ref(jq2, jk[:, :63], jv[:, :63], q_offset=40)
    _close(flash_prefill_tiled_plain(tq2, tk[:, :63], tv[:, :63],
                                     q_offset=40), want, dtype)


def _duet_rows():
    """Decode rows with contexts 1, 17 and 128 beside a 20-row chunk at
    position 30 (slots 0-2 decode, slot 3 the chunk)."""
    return [(0, 0), (1, 16), (2, 127)], [(3, 30 + i) for i in range(20)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,G,Dh", HEADS, ids=IDS)
def test_duet_paged_plain_versions_match_pallas(H, G, Dh, dtype):
    """duet_attention_paged's plain version at the engine's tiles
    (ops.duet_block_q: 21, 12, 1, 64 and 8 positions) against the Pallas
    kernel in interpret mode at the same block_q, and the kernel's tile
    schedule (roles, spans of C = 2, rank-order combine) against the plain
    version, on the unpacked rows."""
    bq = ops.duet_block_q(H, G, Dh)
    rng = np.random.default_rng(2)
    N, ps, P = 40, 16, 8
    kp, vp = (rng.standard_normal((N, ps, G, Dh), np.float32)
              for _ in range(2))
    tables = (1 + rng.permutation(N - 1)[:4 * P]).reshape(4, P).astype(
        np.int32)
    drows, prows = _duet_rows()
    n = len(drows) + len(prows)
    src_q = rng.standard_normal((n, H, Dh), np.float32)
    sched = ops.build_duet_schedule(drows, prows, block_q=bq)
    (jk, tk), (jv, tv), (jq, tq) = (_both(a, dtype) for a in (kp, vp, src_q))
    row_pos = torch.from_numpy(sched.row_pos)[:, None]
    tile_slot = torch.from_numpy(sched.tile_slot)
    args = (ops.pack_duet_queries(sched, tq), row_pos, tile_slot, tk, tv,
            torch.from_numpy(tables))
    got = duet_attention_paged(*args, block_q=bq)
    want = jduet_attention_paged(
        jops.pack_duet_queries(sched, jq), jnp.asarray(sched.row_pos)[:, None],
        jnp.asarray(sched.tile_slot), jk, jv, jnp.asarray(tables),
        block_q=bq, interpret=True)
    _close(ops.unpack_duet_output(sched, got, n),
           jops.unpack_duet_output(sched, want, n), dtype)
    tiled = duet_attention_paged_tiled_plain(*args, block_q=bq, cluster=2)
    torch.testing.assert_close(tiled.float(), got.float(),
                               atol=DUET_TOL[dtype][0],
                               rtol=DUET_TOL[dtype][1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bq", [1, 8])
@pytest.mark.parametrize("H,G,Dh", HEADS, ids=IDS)
def test_slab_duet_plain_matches_pallas(H, G, Dh, bq, dtype):
    """The slab duet_attention's plain version against the Pallas kernel in
    interpret mode: the slab decode's one-row tiles and tiles of 8 rows
    (bq * rep up to 384 pairs, the block role with head blocks on the
    card)."""
    rng = np.random.default_rng(3)
    Ns, S = 4, 128
    ks, vs = (rng.standard_normal((Ns, S, G, Dh), np.float32)
              for _ in range(2))
    drows, prows = _duet_rows()
    n = len(drows) + len(prows)
    src_q = rng.standard_normal((n, H, Dh), np.float32)
    sched = ops.build_duet_schedule(drows, prows, block_q=bq)
    (jk, tk), (jv, tv), (jq, tq) = (_both(a, dtype) for a in (ks, vs, src_q))
    got = duet_attention(ops.pack_duet_queries(sched, tq),
                         torch.from_numpy(sched.row_pos)[:, None],
                         torch.from_numpy(sched.tile_slot), tk, tv,
                         block_q=bq, block_k=128)
    want = jduet_attention(jops.pack_duet_queries(sched, jq),
                           jnp.asarray(sched.row_pos)[:, None],
                           jnp.asarray(sched.tile_slot), jk, jv, block_q=bq,
                           block_k=128, interpret=True)
    _close(ops.unpack_duet_output(sched, got, n),
           jops.unpack_duet_output(sched, want, n), dtype)


# ---------------------------------------------------------------------------
# roles and head blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rep,bq,want", [
    (4, 16, (1, 4)), (5, 12, (1, 5)), (3, 21, (1, 3)), (48, 1, (1, 48)),
    (1, 64, (1, 1)), (8, 8, (1, 8)), (96, 1, (2, 48)), (128, 1, (2, 64)),
    (65, 8, (9, 8)), (2, 64, (2, 1)), (48, 8, (6, 8)),
])
def test_head_split(rep, bq, want):
    """Head blocks of a tile: one at every config's engine tiles; above 64
    (row, head) pairs, balanced blocks of at most 64 // bq heads that
    together hold every head once."""
    hb, hpc = ops.head_split(rep, bq)
    assert (hb, hpc) == want
    assert bq * hpc <= 64 or hpc == 1
    assert (hb - 1) * hpc < rep <= hb * hpc


@pytest.mark.parametrize("name,H,G,decode,slab", [
    ("qwen3-4b", 32, 8, "decode", "decode"),
    ("qwen3-14b", 40, 8, "decode", "decode"),
    ("yi-9b", 32, 4, "decode", "decode"),
    ("minicpm-2b", 36, 36, "decode", "decode"),
    ("granite-20b", 48, 1, "block", "block"),
    ("rep 16", 16, 1, "decode", "decode"),
    ("rep 17", 17, 1, "block", "block"),
])
def test_decode_kernel_roles(name, H, G, decode, slab):
    """The role paged_decode's and the slab decode's (block_q 1) CTAs take
    for each config's heads: the decode core up to 16 query heads a group,
    the tensor-core block above (granite-20b's 48)."""
    assert ops.cta_role(H // G) == decode
    assert slab_role(1, H // G) == slab


def test_cluster_sizing_prices_the_role_launched(monkeypatch):
    """cluster_for / paged_cluster_for ask the card's occupancy of the role
    they launch (rows = rep for paged_decode, block_q x heads of a head
    block for the slab kernel) and size C for the grid they launch:
    B x G x head blocks CTAs a cluster rank."""
    pd = pd_mod
    asked = []

    def fake_occ(dev, dtype, Dh, rows, *rest):
        asked.append(rows)
        return (264 // rest[-1], 0, 0)   # 264 CTAs at once, any C
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(pd, "occupancy", fake_occ)
    monkeypatch.setattr(duet_mod, "occupancy", fake_occ)
    monkeypatch.setattr(duet_mod, "paged_occupancy", fake_occ)
    kp = torch.zeros((2, 16, 1, 128))
    tables = torch.zeros((8, 128), dtype=torch.int32)
    # granite-20b decode: 8 requests x 1 group, block role (rows 48): C = 8
    assert pd.cluster_for(torch.zeros((8, 48, 128)), kp, tables) == 8
    assert asked[-1] == 48
    # rep 128 at B = 17: two head blocks, 34 clusters: 34 x 8 > 264 CTAs
    assert pd.cluster_for(torch.zeros((17, 128, 128)), kp, tables) == 4
    # the slab decode at granite's heads: block_q 1, 48 rows a CTA
    ks = torch.zeros((8, 1024, 1, 128))
    tiles = torch.zeros((8,), dtype=torch.int32)
    assert duet_mod.cluster_for(torch.zeros((8, 48, 128)), tiles, ks, 1) == 8
    assert asked[-1] == 48
    # the paged duet at rep 96, one row a tile: T x 2 head blocks, 40
    # clusters of 20 tiles: 40 x 8 > 264 CTAs
    tiles = torch.zeros((20,), dtype=torch.int32)
    assert duet_mod.paged_cluster_for(torch.zeros((20, 96, 64)), tiles, kp,
                                      tables) == 4
    assert duet_mod.paged_cluster_for(torch.zeros((10, 96, 64)),
                                      tiles[:10], kp, tables) == 8


def test_granite_duet_tiles_all_take_the_block_role():
    """At granite-20b's rep 48 the engine's duet tiles hold one position
    each (48 pairs): decode rows and every chunk position take the prefill
    role, one position a tile."""
    bq = ops.duet_block_q(48, 1, 128)
    assert bq == 1
    sched = ops.build_duet_schedule([(b, 100 * b) for b in range(8)],
                                    [(8, 512 + i) for i in range(256)],
                                    block_q=bq)
    plan = duet_tile_plan(torch.from_numpy(sched.row_pos),
                          torch.from_numpy(sched.tile_slot), block_q=bq,
                          rep=48)
    assert len(plan) == 264
    assert {p[0] for p in plan} == {"prefill"}
    assert {p[1] for p in plan} == {1}
