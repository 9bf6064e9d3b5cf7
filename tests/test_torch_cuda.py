"""The port on the card: each CUDA kernel against its plain PyTorch version
on the kernel tests' shapes, and both engines, paged and slab, on a
reduced qwen3-4b through the kernels. Needs an NVIDIA card (and nvcc, to
build the kernels); every test skips without CUDA. On the card, without the JAX
package's test configuration:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import (build_duet_schedule, launch_counts,
                                 pack_duet_queries, unpack_duet_output)
from repro_torch.kernels.duet_attention import (duet_attention,
                                                duet_attention_paged,
                                                duet_attention_paged_plain,
                                                duet_attention_plain)
from repro_torch.kernels.flash_prefill import (flash_prefill,
                                               flash_prefill_plain)
from repro_torch.kernels.paged_decode import (paged_decode,
                                              paged_decode_cluster_plain,
                                              paged_decode_plain,
                                              paged_decode_splitkv,
                                              paged_decode_splitkv_plain)
from repro_torch.models import Model
from repro_torch.serving import (AsyncDuetEngine, DuetEngine, EngineConfig,
                                 Request)

pytestmark = pytest.mark.cuda
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the paged duet kernel at the engine's tiles, (atol, rtol): the limit
# chip_smoke.py holds it to (the output's bf16 ulp, P rounded to bf16)
DUET_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (5e-3, 1e-2)}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda")


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        dev, DTYPES[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,G,Dh,N,ps,P,S,lens", [
    (2, 4, 2, 64, 16, 16, 4, 1, None),
    (3, 8, 1, 128, 32, 16, 6, 3, None),      # MQA
    (2, 4, 4, 64, 16, 8, 5, 2, None),        # MHA, padded split
    (2, 4, 2, 64, 16, 8, 4, 4, (1, 31)),     # odd lengths, dead splits
    (8, 32, 8, 128, 600, 16, 64, 4, None),   # qwen3-4b heads
    # cluster edges: B=1 (C = 8), B=32 (C = 1 or 2); lengths 1, 16, 17,
    # 2048
    (1, 32, 8, 128, 200, 16, 128, 4, (2048,)),
    (1, 32, 8, 128, 200, 16, 128, 4, (1,)),
    (4, 32, 8, 128, 600, 16, 128, 4, (1, 16, 17, 2048)),
    (32, 32, 8, 128, 4200, 16, 128, 4, (1, 16, 17, 2048) * 8),
    (4, 8, 2, 64, 64, 16, 128, 2, (1, 16, 17, 2048)),      # Dh 64
    (4, 8, 4, 256, 64, 16, 128, 2, (1, 16, 17, 2048)),     # Dh 256
    (2, 8, 2, 256, 32, 16, 8, 2, (17, 128)),               # Dh 256, rep 4
    # split-KV at S = 8 (the cap): a one-token request beside a full one
    (2, 32, 8, 128, 300, 16, 128, 8, (1, 2048)),
    (4, 32, 8, 128, 600, 16, 128, 8, (1, 16, 17, 300)),
])
def test_paged_decode_kernels_match_plain(dev, B, H, G, Dh, N, ps, P, S,
                                          lens, dtype):
    rng = np.random.default_rng(0)
    q = _randn(rng, (B, H, Dh), dtype, dev)
    kp = _randn(rng, (N, ps, G, Dh), dtype, dev)
    vp = _randn(rng, (N, ps, G, Dh), dtype, dev)
    tables = torch.tensor(rng.integers(1, N, (B, P)), dtype=torch.int32,
                          device=dev)
    if lens is None:
        lens = rng.integers(1, P * ps + 1, (B,))
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    torch.testing.assert_close(
        paged_decode(q, kp, vp, tables, lengths),
        paged_decode_plain(q, kp, vp, tables, lengths),
        atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(
        paged_decode_splitkv(q, kp, vp, tables, lengths, num_splits=S),
        paged_decode_splitkv_plain(q, kp, vp, tables, lengths,
                                   num_splits=S),
        atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,lens", [(2, (1, 900)), (8, (1, 2048)),
                                    (8, (1, 16, 17, 300))])
def test_splitkv_kernel_matches_its_span_split(dev, S, lens, dtype):
    """The split-KV kernel runs the cluster's span split of the live pages
    with C = S: held to that algorithm in plain PyTorch."""
    rng = np.random.default_rng(1)
    B, H, G, Dh, N, ps, P = len(lens), 32, 8, 128, 600, 16, 128
    q = _randn(rng, (B, H, Dh), dtype, dev)
    kp = _randn(rng, (N, ps, G, Dh), dtype, dev)
    vp = _randn(rng, (N, ps, G, Dh), dtype, dev)
    tables = torch.tensor(rng.integers(1, N, (B, P)), dtype=torch.int32,
                          device=dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    torch.testing.assert_close(
        paged_decode_splitkv(q, kp, vp, tables, lengths, num_splits=S),
        paged_decode_cluster_plain(q, kp, vp, tables, lengths, cluster=S),
        atol=TOL[dtype], rtol=TOL[dtype])


def test_splitkv_kernel_refuses_more_than_eight_splits(dev):
    q = torch.zeros((1, 4, 64), device=dev)
    pages = torch.zeros((20, 16, 2, 64), device=dev)
    tables = torch.ones((1, 16), dtype=torch.int32, device=dev)
    lengths = torch.full((1,), 200, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="num_splits 9"):
        paged_decode_splitkv(q, pages, pages, tables, lengths, num_splits=9)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bq", [1, 4])
def test_duet_attention_kernel_matches_plain(dev, bq, dtype):
    rng = np.random.default_rng(3)
    N, ps, G, H, Dh, P = 24, 16, 2, 4, 64, 8
    kp = _randn(rng, (N, ps, G, Dh), dtype, dev)
    vp = _randn(rng, (N, ps, G, Dh), dtype, dev)
    tables = torch.tensor(rng.integers(1, N, (4, P)), dtype=torch.int32,
                          device=dev)
    decode_rows = [(0, 100), (1, 57), (2, 127)]
    prefill_rows = [(3, 64 + i) for i in range(20)]
    sched = build_duet_schedule(decode_rows, prefill_rows, block_q=bq)
    n = len(decode_rows) + len(prefill_rows)
    q = pack_duet_queries(sched, _randn(rng, (n, H, Dh), dtype, dev))
    args = (q.contiguous(),
            torch.tensor(sched.row_pos, device=dev)[:, None].contiguous(),
            torch.tensor(sched.tile_slot, device=dev), kp, vp, tables)
    got = unpack_duet_output(
        sched, duet_attention_paged(*args, block_q=bq), n)
    want = unpack_duet_output(
        sched, duet_attention_paged_plain(*args, block_q=bq), n)
    torch.testing.assert_close(got, want, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bq", [1, 16])
def test_paged_duet_kernel_matches_plain_at_engine_tiles(dev, bq, dtype):
    """qwen3-4b's heads (rep 4) at the engine's tiles (bq = 64 // rep = 16:
    decode rows on the decode core, chunk tiles on the prefill block) and
    at one row a tile: decode contexts 1, 17, 300 and 2048, a 40-row chunk
    and a pad tile, against the plain version and the tile schedule at the
    wrapper's C; pad rows come out as zeros."""
    from repro_torch.kernels.duet_attention import (
        duet_attention_paged_tiled_plain, paged_cluster_for)
    rng = np.random.default_rng(7)
    H, G, Dh, ps, P = 32, 8, 128, 16, 128
    decode_rows = [(b, c - 1) for b, c in enumerate((1, 17, 300, 2048))]
    prefill_rows = [(4, 500 + i) for i in range(40)]
    N = 5 * P + 1
    kp = _randn(rng, (N, ps, G, Dh), dtype, dev)
    vp = _randn(rng, (N, ps, G, Dh), dtype, dev)
    tables = torch.tensor(1 + rng.permutation(N - 1).reshape(5, P),
                          dtype=torch.int32, device=dev)
    sched = build_duet_schedule(decode_rows, prefill_rows, block_q=bq)
    n = len(decode_rows) + len(prefill_rows)
    q = pack_duet_queries(sched, _randn(rng, (n, H, Dh), dtype, dev))
    q = torch.cat([q, torch.ones_like(q[:bq])]).contiguous()   # a pad tile
    row_pos = torch.tensor(np.concatenate([sched.row_pos, [-1] * bq]),
                           dtype=torch.int32, device=dev)[:, None]
    tile_slot = torch.tensor(np.concatenate([sched.tile_slot, [-1]]),
                             dtype=torch.int32, device=dev)
    args = (q, row_pos.contiguous(), tile_slot, kp, vp, tables)
    got = duet_attention_paged(*args, block_q=bq)
    C = paged_cluster_for(q, tile_slot, kp, tables)
    for want in (duet_attention_paged_plain(*args, block_q=bq),
                 duet_attention_paged_tiled_plain(*args, block_q=bq,
                                                  cluster=C)):
        torch.testing.assert_close(got, want, atol=DUET_TOL[dtype][0],
                                   rtol=DUET_TOL[dtype][1])
    assert torch.count_nonzero(got[row_pos[:, 0] < 0]) == 0


def test_async_engine_duet_dispatch_uses_engine_block_q(dev, monkeypatch):
    """The async engine's fused duet steps launch duet_attention_paged on
    the card with tiles of bq = 64 // rep rows, and keep the CPU's greedy
    tokens (fp32)."""
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.kernels.ops import duet_block_q
    cfg = reduced(get_config("qwen3-4b"))
    bq = duet_block_q(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    assert bq == 64 // (cfg.num_heads // cfg.num_kv_heads)
    seen = []
    kernel = kernel_ops.duet_attention_paged

    def spy(q, *args, block_q):
        seen.append((block_q, q.device.type))
        return kernel(q, *args, block_q=block_q)
    specs = [(i, i * 0.0003, 20 + 7 * i, 6 + i) for i in range(5)]
    kw = dict(max_slots=3, max_len=128, token_budget=48, page_size=8)
    toks = {}
    for device in ("cpu", dev):
        model = Model.init(cfg, seed=0, device="cpu", attn_kernel=True)
        eng = AsyncDuetEngine(model.to(device), EngineConfig(**kw),
                              device=device)
        eng.submit([Request(rid=r, arrival=a, prompt_len=p, output_len=o)
                    for r, a, p, o in specs])
        monkeypatch.setattr(kernel_ops, "duet_attention_paged", spy)
        before = launch_counts()["duet_attention_paged"]
        metrics = eng.run()
        monkeypatch.undo()
        toks[str(device)] = {r.rid: list(r.output_tokens)
                             for r in metrics.requests}
        if device != "cpu":
            assert launch_counts()["duet_attention_paged"] > before
    assert seen and {b for b, _ in seen} == {bq}
    assert {d for _, d in seen} == {"cpu", "cuda"}
    assert toks["cpu"] == toks[str(dev)]


EDGE_ROWS = [(0, 0), (1, 15), (2, 16), (3, 2047)]   # lengths 1, 16, 17, 2048
CHUNK = [(3, 64 + i) for i in range(20)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bq,decode_rows,prefill_rows,S,H,G,Dh", [
    (8, [(0, 100), (1, 57), (2, 200)], CHUNK, 256, 4, 2, 64),
    (1, [(b, 255 + 92 * b) for b in range(8)], [], 1024, 32, 8, 128),
    # cluster edges: one row (C = 8), 32 rows (C = 1 or 2), lengths 1, 16,
    # 17, 2048, Dh 64 / 128 / 256, bq 1 and 8
    (1, [(0, 1000)], [], 1024, 32, 8, 128),
    (1, [(b, (0, 15, 16, 1023)[b % 4]) for b in range(32)], [], 1024, 32, 8,
     128),
    (1, EDGE_ROWS, [], 2048, 8, 2, 64),
    (1, EDGE_ROWS, [], 2048, 8, 4, 256),
    (8, EDGE_ROWS[:3], CHUNK, 256, 4, 2, 128),
    (8, EDGE_ROWS[:3], CHUNK, 256, 4, 2, 256),
])
def test_slab_duet_attention_kernel_matches_plain(dev, bq, decode_rows,
                                                  prefill_rows, S, H, G, Dh,
                                                  dtype):
    rng = np.random.default_rng(4)
    Ns = max(s for s, _ in decode_rows + prefill_rows) + 1
    ks = _randn(rng, (Ns, S, G, Dh), dtype, dev)
    vs = _randn(rng, (Ns, S, G, Dh), dtype, dev)
    sched = build_duet_schedule(decode_rows, prefill_rows, block_q=bq)
    n = len(decode_rows) + len(prefill_rows)
    q = pack_duet_queries(sched, _randn(rng, (n, H, Dh), dtype, dev))
    args = (q.contiguous(),
            torch.tensor(sched.row_pos, device=dev)[:, None].contiguous(),
            torch.tensor(sched.tile_slot, device=dev), ks, vs)
    got = unpack_duet_output(sched, duet_attention(*args, block_q=bq), n)
    want = unpack_duet_output(sched, duet_attention_plain(*args, block_q=bq),
                              n)
    torch.testing.assert_close(got, want, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,G,Dh,off,kv_len", [
    (1, 128, 128, 4, 2, 64, 0, None),
    (2, 128, 256, 4, 4, 64, 128, None),
    (1, 256, 256, 8, 2, 128, 0, None),
    (1, 128, 128, 4, 1, 64, 0, None),       # MQA
    (2, 77, 300, 32, 8, 128, 200, 250),     # ragged, padded keys
    # the bf16 kernel's tile edges: one query; rows ending mid-block
    # (Sq * rep not a multiple of 64 or 128); keys ending mid-tile (Sk not
    # a multiple of 64); kv_len inside a tile; rep 8 and 64; Dh 32; no
    # valid key at all (zeros)
    (1, 1, 33, 32, 8, 128, 32, None),
    (2, 45, 130, 32, 8, 128, 85, 100),
    (1, 200, 200, 8, 1, 32, 0, None),
    (1, 67, 129, 64, 1, 64, 62, None),
    (1, 300, 700, 32, 8, 128, 400, 650),
    (1, 16, 64, 4, 2, 64, 0, 0),
])
def test_flash_prefill_kernel_matches_plain(dev, B, Sq, Sk, H, G, Dh, off,
                                            kv_len, dtype):
    rng = np.random.default_rng(5)
    q = _randn(rng, (B, Sq, H, Dh), dtype, dev)
    k = _randn(rng, (B, Sk, G, Dh), dtype, dev)
    v = _randn(rng, (B, Sk, G, Dh), dtype, dev)
    torch.testing.assert_close(
        flash_prefill(q, k, v, q_offset=off, kv_len=kv_len),
        flash_prefill_plain(q, k, v, q_offset=off, kv_len=kv_len),
        atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("B,Sq,Sk,H,G,Dh,off,kv_len", [
    (1, 256, 768, 32, 8, 128, 512, None),   # the main chunk
    (2, 45, 130, 32, 8, 128, 85, 100),
    (1, 200, 200, 8, 1, 32, 0, None),
    (1, 67, 129, 64, 1, 64, 62, None),
])
def test_flash_prefill_bf16_matches_its_tile_schedule(dev, B, Sq, Sk, H, G,
                                                      Dh, off, kv_len):
    """The bf16 kernel against the plain version and against its own tile
    schedule in plain PyTorch."""
    from repro_torch.kernels.flash_prefill import flash_prefill_tiled_plain
    rng = np.random.default_rng(6)
    q = _randn(rng, (B, Sq, H, Dh), "bfloat16", dev)
    k = _randn(rng, (B, Sk, G, Dh), "bfloat16", dev)
    v = _randn(rng, (B, Sk, G, Dh), "bfloat16", dev)
    got = flash_prefill(q, k, v, q_offset=off, kv_len=kv_len)
    for want in (flash_prefill_plain(q, k, v, q_offset=off, kv_len=kv_len),
                 flash_prefill_tiled_plain(q, k, v, q_offset=off,
                                           kv_len=kv_len)):
        torch.testing.assert_close(got, want, atol=TOL["bfloat16"],
                                   rtol=TOL["bfloat16"])


def test_engines_on_the_card_match_the_cpu(dev):
    """Reduced qwen3-4b in fp32: the sync and async engines through the
    CUDA kernels (the async one with fused duet steps) give the plain CPU
    path's greedy tokens and the same ServingMetrics summary."""
    cfg = reduced(get_config("qwen3-4b"))
    cpu = Model.init(cfg, seed=0, device="cpu", attn_kernel=True)
    card = Model.init(cfg, seed=0, device="cpu", attn_kernel=True).to(dev)
    specs = [(i, i * 0.0003, 20 + 7 * i, 6 + i) for i in range(5)]
    kw = dict(max_slots=3, max_len=128, token_budget=48, page_size=8)
    runs = {}
    for label, cls, model, device in (
            ("cpu", DuetEngine, cpu, "cpu"),
            ("sync", DuetEngine, card, dev),
            ("async", AsyncDuetEngine, card, dev)):
        before = launch_counts()
        eng = cls(model, EngineConfig(**kw), device=device)
        eng.submit([Request(rid=r, arrival=a, prompt_len=p, output_len=o)
                    for r, a, p, o in specs])
        metrics = eng.run()
        after = launch_counts()
        runs[label] = ({r.rid: list(r.output_tokens)
                        for r in metrics.requests}, metrics.summary())
        if device != "cpu":
            assert eng.kernel_path == "cuda"
            assert after["paged_decode"] > before["paged_decode"]
        if cls is AsyncDuetEngine:
            assert after["duet_attention_paged"] > \
                before["duet_attention_paged"]
            assert 0 < eng.dstats.host_syncs <= eng.dstats.super_iterations
    assert runs["sync"] == runs["cpu"]
    assert runs["async"] == runs["cpu"]


def test_slab_engines_on_the_card_match_the_cpu(dev):
    """Reduced qwen3-4b in fp32 with paged=False: the sync and async slab
    engines through the slab duet_attention kernel give the plain CPU
    path's greedy tokens and the same ServingMetrics summary."""
    cfg = reduced(get_config("qwen3-4b"))
    cpu = Model.init(cfg, seed=0, device="cpu", attn_kernel=True)
    card = Model.init(cfg, seed=0, device="cpu", attn_kernel=True).to(dev)
    specs = [(i, i * 0.0003, 20 + 7 * i, 6 + i) for i in range(5)]
    kw = dict(max_slots=3, max_len=128, token_budget=48, page_size=8,
              paged=False)
    runs = {}
    for label, cls, model, device in (
            ("cpu", DuetEngine, cpu, "cpu"),
            ("sync", DuetEngine, card, dev),
            ("async", AsyncDuetEngine, card, dev)):
        before = launch_counts()
        eng = cls(model, EngineConfig(**kw), device=device)
        eng.submit([Request(rid=r, arrival=a, prompt_len=p, output_len=o)
                    for r, a, p, o in specs])
        metrics = eng.run()
        after = launch_counts()
        runs[label] = ({r.rid: list(r.output_tokens)
                        for r in metrics.requests}, metrics.summary())
        if device != "cpu":
            assert eng.kernel_path == "cuda"
            assert after["duet_attention"] > before["duet_attention"]
        if cls is AsyncDuetEngine:
            assert 0 < eng.dstats.host_syncs <= eng.dstats.super_iterations
    assert runs["sync"] == runs["cpu"]
    assert runs["async"] == runs["cpu"]
