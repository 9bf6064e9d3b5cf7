"""Port parity for the kernel modules: the plain PyTorch versions of
``paged_decode``, ``paged_decode_splitkv`` and ``duet_attention_paged``
(what the CUDA kernels are held to on the card) against the JAX package's
oracles in ``repro.kernels.ref`` on the sweeps of ``tests/test_kernels.py``,
plus one small case each against the Pallas kernel in interpret mode, and
the host-side schedule helpers against their JAX namesakes. The cluster
decode kernels' key split is pinned here too: the host's choice of the
cluster size C and of the spans, and the span-split algorithm in plain
PyTorch against the same oracles.

Inputs come from a seeded numpy generator and feed both packages; bf16
cases round the same float32 values in both. Tolerances are the kernel
tests' ``TOL`` (float32 2e-5, bfloat16 2e-2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.duet_attention import \
    duet_attention_paged as jax_duet_attention_paged
from repro.kernels.paged_decode import paged_decode as jax_paged_decode
from repro.kernels.paged_decode import \
    paged_decode_splitkv as jax_paged_decode_splitkv
from repro_torch.kernels import ops, ref
from repro_torch.kernels.duet_attention import (duet_attention_paged,
                                                duet_attention_paged_plain)
from repro_torch.kernels.paged_decode import (paged_decode,
                                              paged_decode_cluster_plain,
                                              paged_decode_splitkv,
                                              paged_decode_splitkv_plain)

# jitted once per shape: eager JAX compiles every op anew for each shape
paged_decode_ref = jax.jit(jref.paged_decode_ref)
duet_attention_paged_ref = jax.jit(jref.duet_attention_paged_ref)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _both(arr, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(arr, jd), torch.from_numpy(arr).to(td)


def _close(got_t, want_j, dtype):
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_j, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _decode_case(seed, B, H, G, Dh, N, ps, P, dtype, lens=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Dh), np.float32)
    kp = rng.standard_normal((N, ps, G, Dh), np.float32)
    vp = rng.standard_normal((N, ps, G, Dh), np.float32)
    tables = rng.integers(1, N, (B, P)).astype(np.int32)
    if lens is None:
        lens = rng.integers(1, P * ps + 1, (B,))
    lengths = np.asarray(lens, np.int32)
    jx = [*_both(q, dtype)[:1], *_both(kp, dtype)[:1], *_both(vp, dtype)[:1],
          jnp.asarray(tables), jnp.asarray(lengths)]
    tx = [_both(q, dtype)[1], _both(kp, dtype)[1], _both(vp, dtype)[1],
          torch.from_numpy(tables), torch.from_numpy(lengths)]
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,G,Dh,N,ps,P", [
    (2, 4, 2, 64, 16, 16, 4),
    (3, 8, 1, 128, 32, 16, 6),        # MQA
    (2, 4, 4, 64, 16, 8, 5),          # MHA
])
def test_paged_decode_plain_matches_jax_oracle(B, H, G, Dh, N, ps, P, dtype):
    jx, tx = _decode_case(0, B, H, G, Dh, N, ps, P, dtype)
    _close(paged_decode(*tx), paged_decode_ref(*jx), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,G,Dh,N,ps,P,S,lens", [
    (2, 4, 2, 64, 16, 16, 4, 2, None),       # even page split
    (2, 4, 2, 64, 16, 16, 5, 2, None),       # odd page count -> padded split
    (3, 8, 1, 128, 32, 16, 6, 3, None),      # MQA, rep = H
    (2, 8, 2, 64, 16, 8, 6, 4, None),        # GQA rep > 1
    (2, 4, 2, 64, 16, 8, 1, 4, None),        # single-page chain (S clamps)
    (2, 4, 2, 64, 16, 8, 4, 2, (16, 32)),    # length exactly at split edge
    (2, 4, 2, 64, 16, 8, 4, 4, (1, 31)),     # odd lengths, dead splits
])
def test_paged_decode_splitkv_plain_matches_jax_oracle(B, H, G, Dh, N, ps, P,
                                                       S, lens, dtype):
    """The plain split-KV algorithm (partials with the dead-split guard,
    LSE combine) against the gathered-chain oracle."""
    jx, tx = _decode_case(1, B, H, G, Dh, N, ps, P, dtype, lens)
    got = paged_decode_splitkv(*tx, num_splits=S)
    _close(got, paged_decode_ref(*jx), dtype)


def _duet_case(seed, bq, dtype):
    N, ps, G, H, Dh, P = 24, 16, 2, 4, 64, 8
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((N, ps, G, Dh), np.float32)
    vp = rng.standard_normal((N, ps, G, Dh), np.float32)
    tables = rng.integers(1, N, (4, P)).astype(np.int32)
    decode_rows = [(0, 100), (1, 57), (2, 127)]
    prefill_rows = [(3, 64 + i) for i in range(20)]
    src_q = rng.standard_normal((len(decode_rows) + len(prefill_rows), H,
                                 Dh), np.float32)
    sched = ops.build_duet_schedule(decode_rows, prefill_rows, block_q=bq)
    rows = decode_rows + prefill_rows
    return kp, vp, tables, sched, src_q, rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bq", [1, 4])
def test_duet_attention_paged_plain_matches_jax_oracle(bq, dtype):
    """Tile-layout duet attention (decode tiles interleaved with prefill
    tiles, pad rows for bq > 1) against the gathered-slab oracle, compared
    on the unpacked rows."""
    kp, vp, tables, sched, src_q, rows = _duet_case(3, bq, dtype)
    jkp, tkp = _both(kp, dtype)
    jvp, tvp = _both(vp, dtype)
    jq, tq = _both(src_q, dtype)
    q = ops.pack_duet_queries(sched, tq)
    out = duet_attention_paged(q, torch.from_numpy(sched.row_pos)[:, None],
                               torch.from_numpy(sched.tile_slot), tkp, tvp,
                               torch.from_numpy(tables), block_q=bq)
    got = ops.unpack_duet_output(sched, out, len(rows))
    want = duet_attention_paged_ref(
        jq, jnp.asarray([r[0] for r in rows]),
        jnp.asarray([r[1] for r in rows]), jkp, jvp, jnp.asarray(tables))
    _close(got, want, dtype)


def test_duet_plain_pad_rows_are_zero():
    """Pad rows (bq > 1) and pad tiles come out as zeros, like the
    oracle's masked rows."""
    kp, vp, tables, sched, src_q, rows = _duet_case(4, 4, "float32")
    q = ops.pack_duet_queries(sched, torch.from_numpy(src_q))
    tile_slot = np.concatenate([sched.tile_slot, [-1]]).astype(np.int32)
    row_pos = np.concatenate([sched.row_pos, [-1] * 4]).astype(np.int32)
    out = duet_attention_paged_plain(
        torch.cat([q, torch.ones(4, *q.shape[1:])]),
        torch.from_numpy(row_pos)[:, None], torch.from_numpy(tile_slot),
        torch.from_numpy(kp), torch.from_numpy(vp), torch.from_numpy(tables),
        block_q=4)
    pad = torch.from_numpy(row_pos < 0)
    assert int(pad.sum()) > 4
    assert torch.count_nonzero(out[pad]) == 0


def test_paged_decode_matches_jax_interpret_kernel():
    jx, tx = _decode_case(7, 2, 4, 2, 64, 16, 8, 3, "float32")
    _close(paged_decode(*tx), jax_paged_decode(*jx, interpret=True),
           "float32")


def test_paged_decode_splitkv_matches_jax_interpret_kernel():
    jx, tx = _decode_case(8, 2, 4, 2, 64, 16, 8, 4, "float32", (1, 29))
    _close(paged_decode_splitkv_plain(*tx, num_splits=2),
           jax_paged_decode_splitkv(*jx, num_splits=2, interpret=True),
           "float32")


def test_duet_attention_paged_matches_jax_interpret_kernel():
    kp, vp, tables, sched, src_q, rows = _duet_case(9, 1, "float32")
    tq = ops.pack_duet_queries(sched, torch.from_numpy(src_q))
    jq = jops.pack_duet_queries(sched, jnp.asarray(src_q))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    got = duet_attention_paged(tq, torch.from_numpy(sched.row_pos)[:, None],
                               torch.from_numpy(sched.tile_slot),
                               torch.from_numpy(kp), torch.from_numpy(vp),
                               torch.from_numpy(tables), block_q=1)
    want = jax_duet_attention_paged(
        jq, jnp.asarray(sched.row_pos)[:, None], jnp.asarray(sched.tile_slot),
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables), block_q=1,
        interpret=True)
    # bq = 1 leaves no pad rows, so every row is comparable
    _close(got, want, "float32")
    _close(ops.unpack_duet_output(sched, got, len(rows)),
           jops.unpack_duet_output(sched, want, len(rows)), "float32")


@pytest.mark.parametrize("oracle", ["paged_decode", "duet_paged"])
def test_port_oracles_match_jax_oracles(oracle):
    """``repro_torch.kernels.ref`` against ``repro.kernels.ref``."""
    if oracle == "paged_decode":
        jx, tx = _decode_case(11, 3, 8, 2, 64, 20, 8, 5, "float32")
        _close(ref.paged_decode_ref(*tx), paged_decode_ref(*jx),
               "float32")
        return
    kp, vp, tables, sched, src_q, rows = _duet_case(12, 1, "float32")
    slots = np.asarray([r[0] for r in rows] + [-1], np.int32)
    pos = np.asarray([r[1] for r in rows] + [5], np.int32)
    q = np.concatenate([src_q, src_q[:1]])
    got = ref.duet_attention_paged_ref(
        torch.from_numpy(q), torch.from_numpy(slots), torch.from_numpy(pos),
        torch.from_numpy(kp), torch.from_numpy(vp), torch.from_numpy(tables))
    want = duet_attention_paged_ref(
        jnp.asarray(q), jnp.asarray(slots), jnp.asarray(pos),
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables))
    _close(got, want, "float32")


@pytest.mark.parametrize("bq,share", [(1, 0.25), (4, 0.1), (8, 0.7)])
def test_build_duet_schedule_matches_jax(bq, share):
    rng = np.random.default_rng(bq)
    decode_rows = [(int(s), int(p)) for s, p in
                   zip(rng.permutation(6), rng.integers(0, 300, 6))]
    prefill_rows = [(6, 40 + i) for i in range(37)]
    a = ops.build_duet_schedule(decode_rows, prefill_rows, block_q=bq,
                                decode_share=share)
    b = jops.build_duet_schedule(decode_rows, prefill_rows, block_q=bq,
                                 decode_share=share)
    for f in ("tile_slot", "row_slot", "row_pos", "row_src"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.num_decode_tiles, a.num_prefill_tiles) == \
        (b.num_decode_tiles, b.num_prefill_tiles)


def test_num_splits_for_and_constants_match_jax():
    for pages in (1, 2, 5, 6, 64, 128):
        for ps in (8, 16):
            for thr in (None, 0, 1, 16, 48, 100, 256, 12800):
                assert ops.num_splits_for(pages, ps, thr) == \
                    jops.num_splits_for(pages, ps, thr)
    assert (ops.NEG_INF, ops.DENOM_EPS, ops.MASKED_M_THRESHOLD) == \
        (jops.NEG_INF, jops.DENOM_EPS, jops.MASKED_M_THRESHOLD)
    for dh in (64, 80, 128):
        assert ops.default_sm_scale(dh) == jops.default_sm_scale(dh)


def test_gqa_layout_helpers_match_jax():
    x = np.random.default_rng(2).standard_normal((3, 8, 16), np.float32)
    np.testing.assert_array_equal(
        ops.gqa_split_heads(torch.from_numpy(x), 2).numpy(),
        np.asarray(jops.gqa_split_heads(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(
        ops.gqa_repeat_kv(torch.from_numpy(x), 3).numpy(),
        np.asarray(jops.gqa_repeat_kv(jnp.asarray(x), 3)))
    y = ops.gqa_split_heads(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(ops.gqa_merge_heads(y).numpy(), x)


def test_auto_dispatch_picks_split_above_threshold():
    """``paged_decode_auto`` on a CPU tensor runs the plain versions: the
    split variant above the threshold, and both agree."""
    jx, tx = _decode_case(13, 2, 4, 2, 64, 40, 8, 16, "float32")
    plain = ops.paged_decode_auto(*tx, split_threshold=0)
    split = ops.paged_decode_auto(*tx, split_threshold=32)
    assert ops.num_splits_for(16, 8, 32) == 4
    _close(split, paged_decode_ref(*jx), "float32")
    torch.testing.assert_close(split, plain, atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# the cluster decode kernels' key split (csrc/decode_core.cuh)
# ---------------------------------------------------------------------------
def _holds(C):
    """CTAs of clusters of C a card runs at once: 2 per SM on 132 SMs,
    240 once clusters of 4 or 8 must share a GPC (the bf16 kernels' shape
    on an H100)."""
    return 264 if C <= 2 else 240


@pytest.mark.parametrize("ctas,max_units,want", [
    (64, 128, 2),       # B=8, G=8: 128 CTAs; 256 would need two waves
    (8, 128, 8),        # B=1: C stops at 8
    (32, 128, 4),
    (256, 128, 1),      # B=32, G=8: B·G already fills the card
    (1000, 128, 1),
    (132, 128, 2),      # 264 CTAs: exactly one wave
    (8, 5, 4),          # capped at the longest row's units
    (8, 3, 2),
    (64, 1, 1),
    (64, 0, 1),
])
def test_cluster_size(ctas, max_units, want):
    assert ops.cluster_size(ctas, max_units, _holds) == want


def test_cluster_size_is_the_largest_power_of_two_in_one_wave():
    for ctas in range(1, 700, 3):
        for units in (*range(0, 20), 64, 128):
            C = ops.cluster_size(ctas, units, _holds)
            assert C in (1, 2, 4, 8)
            assert C <= max(1, units)
            assert C == 1 or ctas * C <= _holds(C)     # one wave
            if ctas * 2 > _holds(2):                   # B·G fills the card
                assert C == 1
            # largest: doubling C would pass a cap or a second wave
            assert (2 * C > min(ops.CLUSTER_MAX, units)
                    or ctas * 2 * C > _holds(2 * C))


@pytest.mark.parametrize("C", [1, 2, 4, 8])
def test_cluster_spans_cover_every_live_unit_once(C):
    for n in range(70):
        spans = ops.cluster_spans(n, C)
        assert len(spans) == C
        assert all(0 <= a <= e <= n for a, e in spans)   # none past the end
        # contiguous, in rank order, every unit exactly once
        assert [u for a, e in spans for u in range(a, e)] == list(range(n))
        if n < C:                        # short rows leave ranks empty
            assert sum(a == e for a, e in spans) >= C - n


@pytest.mark.parametrize("C", [1, 2, 4, 8])
@pytest.mark.parametrize("unit,P", [(8, 12), (16, 9), (ops.SPLIT_KEYS, 16)])
def test_cluster_spans_cover_every_live_key_once(C, unit, P):
    """Keys as the kernels walk them: rank r takes keys [a * unit,
    min(e * unit, length)) of its span (a, e) of the row's ceil(length /
    unit) live units — pages of ``unit`` tokens, or the slab's 64-key
    units."""
    for length in range(0, P * unit + 1):
        live = min(P, -(-length // unit))
        keys = [k for a, e in ops.cluster_spans(live, C)
                for k in range(a * unit, min(e * unit, length))]
        assert keys == list(range(length))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [1, 2, 4, 8])
@pytest.mark.parametrize("B,H,G,Dh,N,ps,P,lens", [
    (2, 4, 2, 64, 16, 16, 4, None),
    (3, 8, 1, 128, 32, 16, 6, None),            # MQA
    (2, 4, 4, 64, 16, 8, 5, None),              # MHA
    (4, 4, 2, 64, 24, 16, 4, (1, 16, 17, 64)),  # 1 token, a page, a page
    (4, 8, 2, 64, 48, 8, 9, (1, 16, 17, 72)),   # + 1, the full table
])
def test_paged_decode_cluster_plain_matches_jax_oracle(B, H, G, Dh, N, ps, P,
                                                       lens, C, dtype):
    """The span split of the cluster kernel (each request's live pages in
    C spans, dead spans weighing 0, LSE combine in rank order) against the
    gathered-chain oracle."""
    jx, tx = _decode_case(14, B, H, G, Dh, N, ps, P, dtype, lens)
    got = paged_decode_cluster_plain(*tx, cluster=C)
    _close(got, paged_decode_ref(*jx), dtype)


@pytest.mark.parametrize("C,lens", [(2, None), (8, (1, 17))])
def test_paged_decode_cluster_plain_matches_jax_interpret_kernel(C, lens):
    jx, tx = _decode_case(15, 2, 4, 2, 64, 16, 8, 4, "float32", lens)
    _close(paged_decode_cluster_plain(*tx, cluster=C),
           jax_paged_decode(*jx, interpret=True), "float32")
