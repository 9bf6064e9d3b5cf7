"""Port parity for the paged duet kernel's tiles: the tiles of up to 64
(row, head) pairs the engine now hands ``duet_attention_paged`` (a decode
row per tile beside tiles of 64 // rep chunk positions), and the kernel's
decomposition in plain PyTorch (``duet_attention_paged_tiled_plain``: the
role of each tile, the cluster's spans of 64-key units gathered through
the page table, the rank-order combine), which the CUDA kernel cannot be
run to show here.

Inputs come from a seeded numpy generator; bf16 cases round the same
float32 values in both versions. Tolerances (atol, rtol): float32 2e-5,
bfloat16 (5e-3, 1e-2), the limit ``chip_smoke.py`` holds the kernel to
(the output's bf16 ulp, and P rounded to bf16 before P V)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.duet_attention import \
    duet_attention_paged as jax_duet_attention_paged
from repro_torch.kernels import ops
from repro_torch.kernels.duet_attention import (
    duet_attention_paged, duet_attention_paged_plain,
    duet_attention_paged_tiled_plain, duet_tile_plan)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (5e-3, 1e-2)}
EDGE_ROWS = [(0, 0), (1, 15), (2, 16), (3, 2047)]   # contexts 1, 16, 17, 2048


def _case(seed, H, G, Dh, ps, P, decode_rows, prefill_rows, bq, dtype,
          pad_tile=False):
    """Pools, tables and the packed tile layout of ``build_duet_schedule``
    (plus, with ``pad_tile``, one tile of pad rows on a -1 slot)."""
    rng = np.random.default_rng(seed)
    rows = decode_rows + prefill_rows
    nslot = max(s for s, _ in rows) + 1
    N = nslot * P + 1
    kp = torch.from_numpy(rng.standard_normal((N, ps, G, Dh), np.float32))
    vp = torch.from_numpy(rng.standard_normal((N, ps, G, Dh), np.float32))
    tables = torch.from_numpy(
        (1 + rng.permutation(N - 1)[:nslot * P]).reshape(nslot, P)
        .astype(np.int32))
    sched = ops.build_duet_schedule(decode_rows, prefill_rows, block_q=bq)
    src_q = torch.from_numpy(rng.standard_normal((len(rows), H, Dh),
                                                 np.float32))
    q = ops.pack_duet_queries(sched, src_q)
    row_pos = torch.from_numpy(sched.row_pos)
    tile_slot = torch.from_numpy(sched.tile_slot)
    if pad_tile:
        q = torch.cat([q, torch.ones(bq, H, Dh)])
        row_pos = torch.cat([row_pos, torch.full((bq,), -1, dtype=torch.int32)])
        tile_slot = torch.cat([tile_slot, torch.tensor([-1], dtype=torch.int32)])
    td = DTYPES[dtype]
    return (q.to(td), row_pos[:, None], tile_slot, kp.to(td), vp.to(td),
            tables), sched, src_q


@pytest.mark.parametrize("bq,H,G", [(16, 8, 2), (8, 8, 1)])
def test_plain_matches_jax_interpret_kernel_at_engine_block_q(bq, H, G):
    """The port's plain version at the engine's tiles (block_q = 64 // rep:
    16 at rep 4, 8 at rep 8) against the Pallas kernel in interpret mode at
    the same block_q, on the live rows."""
    assert bq == ops.duet_block_q(H, G, 64)
    args, sched, src_q = _case(
        21, H, G, 64, 16, 8, [(0, 100), (1, 57), (2, 127)],
        [(3, 64 + i) for i in range(20)], bq, "float32")
    n = len(src_q)
    got = ops.unpack_duet_output(
        sched, duet_attention_paged(*args, block_q=bq), n)
    jq = jops.pack_duet_queries(sched, jnp.asarray(src_q.numpy()))
    want = jax_duet_attention_paged(
        jq, jnp.asarray(sched.row_pos)[:, None],
        jnp.asarray(sched.tile_slot), *(jnp.asarray(a.numpy())
                                        for a in args[3:]),
        block_q=bq, interpret=True)
    want = jops.unpack_duet_output(sched, want, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL["float32"][0], rtol=TOL["float32"][1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,G,Dh,ps,C,chunk,start", [
    (8, 2, 64, 16, 1, 20, 64),     # 20 rows: a prefill tile + a 4-row tile
    (8, 2, 64, 8, 2, 1, 64),       # a one-row chunk
    (8, 2, 128, 32, 8, 20, 0),     # a chunk at position 0; empty spans
    (16, 2, 64, 16, 8, 20, 100),   # rep 8: tiles of 8 positions
    (32, 8, 128, 16, 2, 20, 0),    # qwen3-4b's heads
])
def test_tiled_plain_matches_plain(H, G, Dh, ps, C, chunk, start, dtype):
    """The kernel's decomposition (roles, C spans of 64-key units walked in
    64-key tiles, rank-order combine) against the gathered-chain
    oracle: decode rows with contexts 1, 16, 17 and 2048, a chunk, and a
    pad tile, at the engine's block_q."""
    bq = ops.duet_block_q(H, G, Dh)
    args, sched, _ = _case(
        22, H, G, Dh, ps, 2048 // ps, EDGE_ROWS,
        [(4, start + i) for i in range(chunk)], bq, dtype, pad_tile=True)
    want = duet_attention_paged_plain(*args, block_q=bq)
    got = duet_attention_paged_tiled_plain(*args, block_q=bq, cluster=C)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype][0],
                               rtol=TOL[dtype][1])
    # pad rows and the pad tile come out as zeros in both
    pad = args[1][:, 0] < 0
    assert int(pad.sum()) >= bq
    assert torch.count_nonzero(got[pad]) == 0


@pytest.mark.parametrize("C", [1, 2, 8])
def test_tiled_plain_at_block_q_1_matches_plain(C):
    """One row a tile (the reference's layout) through the same
    decomposition: every tile takes the decode role."""
    args, sched, _ = _case(23, 8, 2, 64, 16, 128, EDGE_ROWS,
                           [(4, 30 + i) for i in range(5)], 1, "float32")
    assert {r for r, _, _ in duet_tile_plan(args[1], args[2], block_q=1,
                                            rep=4)} == {"decode"}
    torch.testing.assert_close(
        duet_attention_paged_tiled_plain(*args, block_q=1, cluster=C),
        duet_attention_paged_plain(*args, block_q=1),
        atol=TOL["float32"][0], rtol=TOL["float32"][1])


@pytest.mark.parametrize("H,G,Dh,chunk,want", [
    # qwen3-4b at the engine's shape: 8 decode tiles, 16 chunk tiles
    (32, 8, 128, 256, ["decode"] * 8 + ["prefill"] * 16),
    # a 20-row chunk at rep 4: one full tile, then 4 rows (16 pairs)
    (32, 8, 128, 20, ["decode"] * 8 + ["prefill", "decode"]),
    # rep 8, 20 rows: tiles of 8, 8 and 4 positions (64, 64, 32 pairs)
    (64, 8, 128, 20, ["decode"] * 8 + ["prefill"] * 3),
    # Dh 256 (the prefill block keeps Q in shared memory there): tiles of
    # 16 and 4 positions, as at Dh 128
    (32, 8, 256, 20, ["decode"] * 8 + ["prefill", "decode"]),
    # qwen3-14b's rep 5: tiles of 12 and 8 positions (60 and 40 pairs)
    (40, 8, 128, 20, ["decode"] * 8 + ["prefill"] * 2),
    # granite-20b's rep 48: one position a tile, decode rows too, all on
    # the prefill block
    (48, 1, 128, 20, ["prefill"] * 8 + ["prefill"] * 20),
    # minicpm-2b's rep 1: tiles of 64 positions, decode rows of 1 pair
    (36, 36, 64, 100, ["decode"] * 8 + ["prefill", "prefill"]),
])
def test_engine_schedule_roles(H, G, Dh, chunk, want):
    """The roles the kernel picks for the async engine's schedule (B = 8
    decode rows, one chunk, block_q = ops.duet_block_q): each decode row is
    a tile of its own on the decode core, the chunk's tiles of 64 // rep
    positions run on the prefill block; the rows of each tile, and the
    keys (its largest position + 1) it walks."""
    bq = ops.duet_block_q(H, G, Dh)
    B = 8
    sched = ops.build_duet_schedule([(b, 100 * b) for b in range(B)],
                                    [(B, 512 + i) for i in range(chunk)],
                                    block_q=bq)
    plan = duet_tile_plan(torch.from_numpy(sched.row_pos),
                          torch.from_numpy(sched.tile_slot), block_q=bq,
                          rep=H // G)
    decode = [p for p, s in zip(plan, sched.tile_slot) if s < B]
    prefill = [p for p, s in zip(plan, sched.tile_slot) if s == B]
    assert sorted(p[0] for p in plan) == sorted(want)
    assert [(n, k) for _, n, k in decode] == [(1, 100 * b + 1)
                                              for b in range(B)]
    sizes = [min(bq, chunk - i) for i in range(0, chunk, bq)]
    assert [n for _, n, _ in prefill] == sizes
    assert [k for _, _, k in prefill] == [512 + i + n for i, n in
                                          zip(range(0, chunk, bq), sizes)]


@pytest.mark.parametrize("H,G,Dh,want", [
    (32, 8, 128, 16), (32, 8, 64, 16), (64, 8, 128, 8), (40, 8, 128, 12),
    (32, 32, 128, 64), (32, 1, 128, 2), (128, 1, 128, 1), (32, 8, 256, 16),
    (4, 2, 64, 32), (48, 1, 128, 1), (32, 4, 128, 8), (36, 36, 64, 64),
    (24, 8, 64, 21),
])
def test_duet_block_q(H, G, Dh, want):
    """Chunk positions of one engine tile: 64 (row, head) pairs at most at
    every head dim, at least one position."""
    bq = ops.duet_block_q(H, G, Dh)
    assert bq == want
    assert bq * (H // G) <= 64 or bq == 1
