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
from repro_torch.core.device import partition_curves
from repro_torch.core.roofline import card_spec
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
from repro_torch.kernels.sm_probe import (MAX_VALUE, sm_probe,
                                          sm_probe_plain)
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import Model
from repro_torch.serving import (AsyncDuetEngine, DuetEngine, EngineConfig,
                                 Request)
from repro_torch.serving.engine import device_pricing

pytestmark = pytest.mark.cuda
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the decode and duet kernels (paged_decode, split-KV, both
# duet_attention kernels): the limit chip_smoke.py holds them to (the
# output's bf16 ulp, P rounded to bf16)
ATTN_TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
            "bfloat16": dict(atol=5e-3, rtol=1e-2)}


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
        **ATTN_TOL[dtype])
    torch.testing.assert_close(
        paged_decode_splitkv(q, kp, vp, tables, lengths, num_splits=S),
        paged_decode_splitkv_plain(q, kp, vp, tables, lengths,
                                   num_splits=S),
        **ATTN_TOL[dtype])


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
        **ATTN_TOL[dtype])


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
    torch.testing.assert_close(got, want, **ATTN_TOL[dtype])


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
        torch.testing.assert_close(got, want, **ATTN_TOL[dtype])
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
    torch.testing.assert_close(got, want, **ATTN_TOL[dtype])


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


def _card_pricing(dev):
    """What an engine on ``dev`` prices (the card's spec and measured
    curve), for a CPU engine planning as the card's do."""
    return dict(hw=device_pricing(dev))


def test_sm_probe_matches_plain_on_the_card(dev):
    """The bandwidth probe's CTA checksums equal its plain version's at 1,
    2, 7 and every SM, and its CTAs run on as many distinct SMs."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(0)
    host = torch.from_numpy(rng.integers(0, MAX_VALUE, 4 * 300_001)
                            .astype(np.int32))
    buf = host.to(dev)
    for ctas in (1, 2, 7, sms):
        got, smid = sm_probe(buf, ctas)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), sm_probe_plain(host, ctas))
        assert torch.unique(smid).numel() == ctas
    with pytest.raises(ValueError, match="CTAs on a card"):
        sm_probe(buf, sms + 1)


def test_engines_on_the_card_price_the_card(dev):
    """hw=None on the card: both engines plan with the card's spec over its
    TPCs and the measured curve partition_curves holds: the curve over SMs
    placed by the block scheduler at a step of one TPC for an engine that
    does not split, the green contexts' curve at the driver's step for the
    async engine that splits."""
    from repro_torch.core.device import card_unit_step
    cfg = reduced(get_config("qwen3-4b"))
    card = Model.init(cfg, seed=0, device=dev, attn_kernel=True)
    spec = card_spec(torch.cuda.get_device_properties(dev))
    curves = {False: partition_curves(dev, spec),
              True: partition_curves(dev, spec, split=True)}
    ec = EngineConfig(max_slots=3, max_len=128)
    for eng in (DuetEngine(card, ec, device=dev),
                AsyncDuetEngine(card, ec, device=dev, sm_split=False),
                AsyncDuetEngine(card, ec, device=dev)):
        split = getattr(eng, "sm_split", False)
        assert eng.mux.hw.name == spec.name == torch.cuda.get_device_name(dev)
        assert eng.mux.total_units == spec.num_units
        assert eng.mux.unit_step == (card_unit_step(dev) if split else 1)
        assert eng.mux.bw_table == curves[split]
        assert eng.mux.pi_table == {u: spec.pi(u) for u in curves[split]}


def test_engines_on_the_card_match_the_cpu(dev):
    """Reduced qwen3-4b in fp32: the sync and async engines through the
    CUDA kernels (the async one with fused duet steps: a given spec at a
    step of one TPC keeps the SM split off) give the plain CPU path's
    greedy tokens and the same ServingMetrics summary, every engine
    priced as the card's engines that do not split are."""
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
        eng = cls(model, EngineConfig(**kw), device=device,
                  **_card_pricing(dev))
        eng.submit([Request(rid=r, arrival=a, prompt_len=p, output_len=o)
                    for r, a, p, o in specs])
        metrics = eng.run()
        after = launch_counts()
        runs[label] = ({r.rid: list(r.output_tokens)
                        for r in metrics.requests}, metrics.summary())
        assert not getattr(eng, "sm_split", False)
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
        eng = cls(model, EngineConfig(**kw), device=device,
                  **_card_pricing(dev))
        eng.submit([Request(rid=r, arrival=a, prompt_len=p, output_len=o)
                    for r, a, p, o in specs])
        metrics = eng.run()
        after = launch_counts()
        runs[label] = ({r.rid: list(r.output_tokens)
                        for r in metrics.requests}, metrics.summary())
        assert not getattr(eng, "sm_split", False)
        if device != "cpu":
            assert eng.kernel_path == "cuda"
            assert after["duet_attention"] > before["duet_attention"]
        if cls is AsyncDuetEngine:
            assert 0 < eng.dstats.host_syncs <= eng.dstats.super_iterations
    assert runs["sync"] == runs["cpu"]
    assert runs["async"] == runs["cpu"]


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slab"])
def test_graphed_async_engine_matches_eager_on_the_card(dev, paged):
    """Reduced qwen3-4b in fp32: the async engine replaying each bucket's
    CUDA graph serves the same greedy tokens, makes the same kernel
    launches and keeps at most one host sync a super-iteration as the same
    engine with every dispatch eager; the slab path's chunks stay eager by
    their rule."""
    cfg = reduced(get_config("qwen3-4b"))
    card = Model.init(cfg, seed=0, device=dev, attn_kernel=True)
    specs = [(i, i * 0.0003, 20 + 7 * i, 6 + i) for i in range(5)]
    kw = dict(max_slots=3, max_len=128, token_budget=48, page_size=8,
              paged=paged)
    runs = {}
    for graphs in (None, False):
        before = launch_counts()
        eng = AsyncDuetEngine(card, EngineConfig(**kw), device=dev,
                              graphs=graphs)
        eng.submit([Request(rid=r, arrival=a, prompt_len=p, output_len=o)
                    for r, a, p, o in specs])
        metrics = eng.run()
        after = launch_counts()
        st = eng.dstats
        runs[graphs] = ({r.rid: list(r.output_tokens)
                         for r in metrics.requests},
                        {k: after[k] - before[k] for k in after})
        assert 0 < st.host_syncs <= st.super_iterations
        assert st.captures + st.replays + st.eager_dispatches == \
            st.dispatches
        if graphs is None:
            assert eng.graphs and st.replays > 0 and st.captures > 0
            assert set(st.eager_reasons) <= {"warmup", "slab_chunk"}
            assert ("slab_chunk" in st.eager_reasons) == (not paged)
            assert eng.graph_pool_bytes() > 0
        else:
            assert st.eager_reasons == {"off": st.dispatches}
    assert runs[None] == runs[False]


# ---------------------------------------------------------------------------
# every GQA head shape: rep > 16 (the block role), rep > 64 (head blocks),
# reps that do not divide 64, Dh 256
# ---------------------------------------------------------------------------
# (H, G, Dh): granite-20b (MQA, rep 48), yi-9b (rep 8), minicpm-2b (rep 1
# at Dh 64), qwen3-14b (rep 5), granite-moe (rep 3), rep 96 and 128 (two
# head blocks), rep 8 and 48 at Dh 256
HEAD_SHAPES = [(48, 1, 128), (32, 4, 128), (36, 36, 64), (40, 8, 128),
               (24, 8, 64), (96, 1, 64), (128, 1, 64), (8, 1, 256),
               (48, 1, 256)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,G,Dh", HEAD_SHAPES)
def test_paged_decode_kernels_take_every_head_shape(dev, H, G, Dh, dtype):
    """paged_decode and split-KV (S = 4) at each head shape, contexts 1,
    16, 17 and 2048, against the plain version and the cluster's span
    split."""
    rng = np.random.default_rng(11)
    lens = (1, 16, 17, 2048)
    B, ps, P = len(lens), 16, 128
    N = B * P + 1
    q = _randn(rng, (B, H, Dh), dtype, dev)
    kp = _randn(rng, (N, ps, G, Dh), dtype, dev)
    vp = _randn(rng, (N, ps, G, Dh), dtype, dev)
    tables = torch.tensor(1 + rng.permutation(N - 1)[:B * P].reshape(B, P),
                          dtype=torch.int32, device=dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    want = paged_decode_plain(q, kp, vp, tables, lengths)
    torch.testing.assert_close(paged_decode(q, kp, vp, tables, lengths),
                               want, **ATTN_TOL[dtype])
    got = paged_decode_splitkv(q, kp, vp, tables, lengths, num_splits=4)
    for ref in (paged_decode_splitkv_plain(q, kp, vp, tables, lengths,
                                           num_splits=4),
                paged_decode_cluster_plain(q, kp, vp, tables, lengths,
                                           cluster=4)):
        torch.testing.assert_close(got, ref, **ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,G,Dh", HEAD_SHAPES)
def test_slab_duet_kernel_takes_every_head_shape(dev, H, G, Dh, dtype):
    """The slab duet_attention at each head shape: the slab decode's
    one-row tiles (contexts 1, 16, 17, 2048) and a tile of 8 chunk rows
    beside 3 decode rows."""
    rng = np.random.default_rng(12)
    S = 2048
    for bq, drows, prows in ((1, EDGE_ROWS, []),
                             (8, EDGE_ROWS[:3], CHUNK)):
        Ns = max(s for s, _ in drows + prows) + 1
        ks = _randn(rng, (Ns, S, G, Dh), dtype, dev)
        vs = _randn(rng, (Ns, S, G, Dh), dtype, dev)
        sched = build_duet_schedule(drows, prows, block_q=bq)
        n = len(drows) + len(prows)
        q = pack_duet_queries(sched, _randn(rng, (n, H, Dh), dtype, dev))
        args = (q.contiguous(),
                torch.tensor(sched.row_pos, device=dev)[:, None].contiguous(),
                torch.tensor(sched.tile_slot, device=dev), ks, vs)
        got = unpack_duet_output(sched, duet_attention(*args, block_q=bq), n)
        want = unpack_duet_output(
            sched, duet_attention_plain(*args, block_q=bq), n)
        torch.testing.assert_close(got, want, **ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,G,Dh,bq", [
    # each config's engine tiles (ops.duet_block_q)
    (48, 1, 128, 1), (32, 4, 128, 8), (36, 36, 64, 64), (40, 8, 128, 12),
    (24, 8, 64, 21),
    # rep > 64: head blocks; Dh 256 on both roles
    (96, 1, 64, 1), (128, 1, 64, 1), (128, 1, 128, 1), (16, 2, 256, 8),
    (48, 1, 256, 1),
])
def test_paged_duet_kernel_takes_every_head_shape(dev, H, G, Dh, bq, dtype):
    """duet_attention_paged at each head shape's engine tiles: decode
    contexts 1, 17, 300 and 2048 beside a 40-row chunk and a pad tile,
    against the plain version and the tile schedule at the wrapper's C;
    pad rows are zeros."""
    from repro_torch.kernels.duet_attention import (
        duet_attention_paged_tiled_plain, paged_cluster_for)
    rng = np.random.default_rng(13)
    ps, P = 16, 128
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
        torch.testing.assert_close(got, want, **ATTN_TOL[dtype])
    assert torch.count_nonzero(got[row_pos[:, 0] < 0]) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,G,Dh,off,kv_len", [
    (1, 100, 300, 24, 8, 64, 200, None),     # rep 3: 21 positions a block
    (2, 45, 130, 40, 8, 128, 85, 100),       # rep 5: 12 positions
    (1, 67, 129, 48, 1, 128, 62, None),      # rep 48: one position
    (1, 130, 200, 8, 1, 256, 70, None),      # Dh 256
    (1, 33, 100, 96, 1, 64, 67, None),       # rep 96: two head blocks
    (1, 20, 64, 128, 1, 64, 0, 0),           # rep 128, no valid key
])
def test_flash_prefill_kernel_takes_every_head_shape(dev, B, Sq, Sk, H, G,
                                                     Dh, off, kv_len, dtype):
    """flash_prefill at reps that do not divide 64, above 64, and at Dh
    256, against the plain version (and, in bf16, its tile schedule)."""
    from repro_torch.kernels.flash_prefill import flash_prefill_tiled_plain
    rng = np.random.default_rng(14)
    q = _randn(rng, (B, Sq, H, Dh), dtype, dev)
    k = _randn(rng, (B, Sk, G, Dh), dtype, dev)
    v = _randn(rng, (B, Sk, G, Dh), dtype, dev)
    got = flash_prefill(q, k, v, q_offset=off, kv_len=kv_len)
    wants = [flash_prefill_plain(q, k, v, q_offset=off, kv_len=kv_len)]
    if dtype == "bfloat16":
        wants.append(flash_prefill_tiled_plain(q, k, v, q_offset=off,
                                               kv_len=kv_len))
    for want in wants:
        torch.testing.assert_close(got, want, atol=TOL[dtype],
                                   rtol=TOL[dtype])


@pytest.mark.parametrize("heads", [(48, 1), (40, 8)])
def test_engines_at_published_head_counts_on_the_card(dev, heads):
    """A narrow two-layer model at granite-20b's 48 / 1 and qwen3-14b's
    40 / 8 heads (head dim 16 x 4 = 64), fp32: the async engine (duet tiles
    of bq 1 and 12) and the slab engine through the kernels give the CPU's
    greedy tokens."""
    import dataclasses
    H, G = heads
    cfg = dataclasses.replace(reduced(get_config("qwen3-4b")), num_heads=H,
                              num_kv_heads=G, head_dim=64)
    specs = [(i, i * 0.0003, 20 + 7 * i, 6 + i) for i in range(5)]
    for extra in ({}, {"paged": False}):
        kw = dict(max_slots=3, max_len=128, token_budget=48, page_size=8,
                  **extra)
        runs = {}
        for device in ("cpu", dev):
            model = Model.init(cfg, seed=0, device="cpu", attn_kernel=True)
            eng = AsyncDuetEngine(model.to(device), EngineConfig(**kw),
                                  device=device)
            eng.submit([Request(rid=r, arrival=a, prompt_len=p,
                                output_len=o) for r, a, p, o in specs])
            metrics = eng.run()
            runs[str(device)] = {r.rid: list(r.output_tokens)
                                 for r in metrics.requests}
        assert runs["cpu"] == runs[str(dev)]


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m",
                                  "deepseek-v2-lite-16b"])
def test_moe_engines_on_the_card_match_the_cpu(dev, name):
    """Reduced granite-moe (GQA at rep 2 with an MoE FFN) and deepseek
    (MLA, MoE with a shared expert), fp32, at the default capacity: the
    async engine on paged KV (granite-moe's fused duet steps through
    duet_attention_paged, its decode through paged_decode) and on the slab
    (granite-moe's decode through the slab duet_attention) gives the CPU's
    greedy tokens. deepseek's MLA runs no kernel."""
    cfg = reduced(get_config(name))
    gqa = name.startswith("granite")
    specs = [(i, i * 0.0003, 20 + 7 * i, 6 + i) for i in range(5)]
    for extra, kernels in (({}, ("paged_decode", "duet_attention_paged")),
                           ({"paged": False}, ("duet_attention",))):
        kw = dict(max_slots=3, max_len=128, token_budget=48, page_size=8,
                  **extra)
        runs = {}
        for device in ("cpu", dev):
            model = Model.init(cfg, seed=0, device="cpu", attn_kernel=True)
            before = launch_counts()
            eng = AsyncDuetEngine(model.to(device), EngineConfig(**kw),
                                  device=device)
            eng.submit([Request(rid=r, arrival=a, prompt_len=p,
                                output_len=o) for r, a, p, o in specs])
            metrics = eng.run()
            after = launch_counts()
            assert 0 < eng.dstats.host_syncs <= eng.dstats.super_iterations
            runs[str(device)] = {r.rid: list(r.output_tokens)
                                 for r in metrics.requests}
            if device != "cpu":
                for k in kernels:
                    assert (after[k] > before[k]) == gqa, k
        assert runs["cpu"] == runs[str(dev)]


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slab"])
@pytest.mark.parametrize("name", ["zamba2-1.2b", "xlstm-350m"])
def test_recurrent_engines_on_the_card_match_the_cpu(dev, name, paged):
    """Reduced zamba2 (Mamba2 + the shared attention block) and xlstm
    (mLSTM + sLSTM), fp32, five requests on three slots (slots reused):
    the sync and async engines on the card give the CPU's greedy tokens.
    zamba2's decode runs paged_decode (paged) or the slab duet_attention
    (slab), never a fused duet step beside recurrent blocks; its paged
    prefill chunks' shared attention runs duet_attention_paged with no
    decode rows; xlstm launches no kernel."""
    cfg = reduced(get_config(name), num_layers=4)
    specs = [(0, 0.0, 20, 6), (1, 0.0003, 27, 1), (2, 0.0006, 34, 8),
             (3, 0.0009, 41, 9), (4, 0.0012, 30, 10)]
    kw = dict(max_slots=3, max_len=128, token_budget=48, page_size=8,
              paged=paged)
    kernel = "paged_decode" if paged else "duet_attention"
    runs = {}
    for label, cls, device in (("cpu", DuetEngine, "cpu"),
                               ("sync", DuetEngine, dev),
                               ("async", AsyncDuetEngine, dev)):
        model = Model.init(cfg, seed=0, device="cpu", attn_kernel=True)
        before = launch_counts()
        eng = cls(model.to(device), EngineConfig(**kw), device=device)
        eng.submit([Request(rid=r, arrival=a, prompt_len=p, output_len=o)
                    for r, a, p, o in specs])
        metrics = eng.run()
        after = launch_counts()
        runs[label] = {r.rid: list(r.output_tokens)
                       for r in metrics.requests}
        if device != "cpu":
            assert (after[kernel] > before[kernel]) == \
                (name == "zamba2-1.2b")
            assert (after["duet_attention_paged"]
                    > before["duet_attention_paged"]) == \
                (name == "zamba2-1.2b" and paged)
        if cls is AsyncDuetEngine:
            assert 0 < eng.dstats.host_syncs <= eng.dstats.super_iterations
    assert runs["sync"] == runs["cpu"]
    assert runs["async"] == runs["cpu"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", [1, 8])
@pytest.mark.parametrize("name", ["qwen3-4b", "yi-9b"])
def test_paged_decode_sharded_matches_plain_on_tp2_shards(dev, name, splits,
                                                          dtype):
    """The sharded route on each rank's TP 2 head shard (qwen3-4b: 16 / 4
    heads, yi-9b: 16 / 2; Dh 128), pools allocated at the rank's width,
    against the plain paged decode over the full heads sliced to that
    rank; one counted launch a call, beside the inner kernel's."""
    from repro_torch.core.device import DeviceContext
    from repro_torch.kernels.ops import paged_decode_sharded
    cfg = get_config(name)
    tp, B, ps, P = 2, 8, 16, 128
    H, G, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(0)
    N = B * P + 1
    q = _randn(rng, (B, H, Dh), dtype, dev)
    kp = _randn(rng, (N, ps, G, Dh), dtype, dev)
    vp = _randn(rng, (N, ps, G, Dh), dtype, dev)
    tables = torch.tensor(1 + rng.permutation(N - 1).reshape(B, P),
                          dtype=torch.int32, device=dev)
    lengths = torch.tensor(np.linspace(256, 2048, B).astype(np.int64),
                           dtype=torch.int32, device=dev)
    want = paged_decode_plain(q, kp, vp, tables, lengths)
    Hl, Gl = H // tp, G // tp
    for r in range(tp):
        ctx = DeviceContext(cfg, dev, tp=tp, rank=r)
        heads = slice(r * Hl, (r + 1) * Hl)
        kv = slice(r * Gl, (r + 1) * Gl)
        before = launch_counts()
        got = paged_decode_sharded(
            q[:, heads].contiguous(), kp[:, :, kv].contiguous(),
            vp[:, :, kv].contiguous(), tables, lengths, ctx=ctx,
            num_splits=splits)
        after = launch_counts()
        torch.testing.assert_close(got.float(), want[:, heads].float(),
                                   **ATTN_TOL[dtype])
        inner = "paged_decode" if splits == 1 else "paged_decode_splitkv"
        assert after["paged_decode_sharded"] - \
            before["paged_decode_sharded"] == 1
        assert after[inner] - before[inner] == 1


# ---------------------------------------------------------------------------
# tensor parallelism: two ranks on card 0 over gloo
# ---------------------------------------------------------------------------
TP_SPECS = [(i, i * 0.0003, 20 + 7 * i, 6 + i) for i in range(5)]
TP_KW = dict(max_slots=3, max_len=128, token_budget=48, page_size=8)


def _tp_serve(cls, model, device, paged):
    """Serve TP_SPECS with strict_kernel on: (kernel path, tokens, kernel
    launches of the run)."""
    eng = cls(model, EngineConfig(paged=paged, strict_kernel=True, **TP_KW),
              device=device)
    eng.submit([Request(rid=r, arrival=a, prompt_len=p, output_len=o)
                for r, a, p, o in TP_SPECS])
    before = launch_counts()
    metrics = eng.run()
    after = launch_counts()
    return (eng.kernel_path,
            {r.rid: list(r.output_tokens) for r in metrics.requests},
            {k: after[k] - before[k] for k in after})


def tp2_card_rank(rank, name, paged):
    """One rank of the TP 2 card tests (a spawned process): reduced
    ``name`` in fp32 from seed 0, its slices on card 0, through both
    engines."""
    cfg = reduced(get_config(name))
    model = Model.init(cfg, seed=0, ctx=rank.context(cfg), attn_kernel=True)
    return {label: _tp_serve(cls, model, rank.device, paged)
            for label, cls in (("sync", DuetEngine),
                               ("async", AsyncDuetEngine))}


@pytest.mark.parametrize("name,paged,path", [
    ("qwen3-4b", True, "cuda_sharded"),     # KV heads shard
    ("qwen3-4b", False, "cuda"),            # the slab kernel on the shard
    ("granite-20b", True, "cuda"),          # one KV head: whole per rank
    ("granite-20b", False, "cuda"),
])
def test_tp2_kernels_run_on_rank_local_tensors(dev, name, paged, path):
    """At TP 2 every attention path launches its kernels on the rank's
    local tensors, none falls back to the plain version: the sharded decode
    route only where the KV heads shard, the ordinary decode kernels where
    every rank holds the heads whole, the slab kernel on the rank's slab.
    Both ranks give TP 1's greedy tokens on the card (the same draws from
    the card's generator: each rank keeps its slices of the full leaves)."""
    cfg = reduced(get_config(name))
    one = Model.init(cfg, seed=0, device=dev, attn_kernel=True)
    want = _tp_serve(DuetEngine, one, dev, paged)[1]
    del one
    ranks = run_ranks(tp2_card_rank, 2, device="cuda", share_card=True,
                      args=(name, paged))
    for res in ranks:
        for label, (kernel_path, tokens, n) in res.items():
            assert kernel_path == path, label
            assert tokens == want, label
            if not paged:
                assert n["duet_attention"] > 0, (label, n)
                continue
            inner = n["paged_decode"] + n["paged_decode_splitkv"]
            assert inner > 0, (label, n)
            sharded = n["paged_decode_sharded"]
            assert sharded == (inner if path == "cuda_sharded" else 0), n
            if label == "async":
                assert n["duet_attention_paged"] > 0, n


# ---------------------------------------------------------------------------
# training and the frontends
# ---------------------------------------------------------------------------
def test_train_step_on_the_card_matches_the_cpu(dev):
    """Reduced minicpm-2b on its WSD schedule, fp32 with TF32 off: three
    ``make_train_step`` steps on the card and on the CPU from the same
    weights and batches give losses, learning rates and grad norms within
    1e-4 (relative) and parameters within a tenth of the learning rate
    (Adam's m / sqrt(v) has no scale: an entry whose gradient is at the
    rounding noise moves by another fraction of lr on each device)."""
    from repro_torch.data import data_iterator
    from repro_torch.models import trainable
    from repro_torch.models.params import _leaves, _map
    from repro_torch.training import (AdamWConfig, init_adamw,
                                      make_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config("minicpm-2b"))
    cpu = Model.init(cfg, seed=0, device="cpu", requires_grad=True,
                     remat=True)
    card = Model(cfg, trainable(_map(lambda _, t: t.detach().to(
        dev, copy=True), cpu.param_tree())), remat=True)
    opt = AdamWConfig(lr=1e-3, schedule=cfg.lr_schedule, warmup_steps=2,
                      total_steps=3)
    runs = {}
    for label, model in (("cpu", cpu), ("card", card)):
        step = make_train_step(model, opt)
        params = model.param_tree()
        state = init_adamw(params)
        data = data_iterator(cfg, 64, 2, seed=0)
        rows = []
        for _ in range(3):
            params, state, m = step(params, state, next(data))
            rows.append({k: float(v) for k, v in m.items()})
        runs[label] = (params, rows)
    for c, g in zip(runs["cpu"][1], runs["card"][1]):
        for key in ("loss", "lr", "grad_norm"):
            assert abs(g[key] - c[key]) <= 1e-4 * abs(c[key]), (key, g, c)
    want = dict(_leaves(runs["cpu"][0]))
    for path, t in _leaves(runs["card"][0]):
        err = (t.detach().cpu() - want[path].detach()).abs().max().item()
        assert err <= 0.1 * opt.lr, (path, err)


@pytest.mark.parametrize("name", ["paligemma-3b", "musicgen-medium"])
def test_frontend_kernel_path_matches_plain_on_the_card(dev, name):
    """Reduced paligemma (a patch prefix under the prefix-LM mask, MQA)
    and musicgen (a codebook grid, (B, K, V) logits), fp32 with TF32 off:
    a slab prefill, then three slab decode steps through the slab
    duet_attention kernel against the plain path on a copy of the cache,
    within 1e-4 x max|logit|; the kernel launches once a layer a step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config(name))
    kern = Model.init(cfg, seed=0, device=dev, attn_kernel=True)
    plain = Model(cfg, kern.param_tree())
    rng = np.random.default_rng(0)
    B, S = 2, 12
    audio = cfg.frontend == "audio"
    shape = (B, cfg.num_codebooks, S) if audio else (B, S)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, shape), device=dev)
    kw, P = {}, 0
    if not audio:
        P = cfg.num_prefix_tokens
        kw["patch_embeds"] = _randn(rng, (B, P, cfg.d_model), "float32", dev)
    with torch.no_grad():
        cache = plain.init_cache(B, 128)
        first, _ = plain.prefill(toks, cache=cache, **kw)
        kcache = [type(c)(*(t.clone() for t in c)) for c in cache]
        tok = first.argmax(-1)[..., None]
        before = launch_counts()["duet_attention"]
        for i in range(3):
            pos = torch.full((B,), P + S + i, dtype=torch.int32, device=dev)
            lk, _ = kern.decode_step(kcache, tok, pos)
            lp, _ = plain.decode_step(cache, tok, pos)
            scale = max(1.0, lp.abs().max().item())
            assert (lk - lp).abs().max().item() <= 1e-4 * scale
            tok = lp.argmax(-1)[..., None]
    assert launch_counts()["duet_attention"] - before == 3 * cfg.num_layers
    if audio:
        assert tuple(lk.shape) == (B, cfg.num_codebooks, cfg.padded_vocab)


@pytest.mark.parametrize("s_d", [4, 32, 56])
def test_sm_split_contexts_are_disjoint_on_the_card(dev, s_d):
    """An SmSplit's two green contexts: the probe at one CTA for every SM
    of the card on each stream runs on exactly 2 x S_d and the rest of
    the SMs, none shared; two torch GreenContext.create calls, by
    contrast, cut the card afresh each."""
    from repro_torch.core.device import SmSplit, sm_granularity
    sms, low, step = sm_granularity(dev)
    split = SmSplit(dev, s_d)
    try:
        assert split.sms == {"decode": 2 * s_d, "prefill": sms - 2 * s_d}
        assert len(split.smids["decode"]) == 2 * s_d
        assert len(split.smids["prefill"]) == sms - 2 * s_d
        assert not split.smids["decode"] & split.smids["prefill"]
    finally:
        split.close()
    with pytest.raises(ValueError, match="not a group"):
        SmSplit(dev, (low + step) // 2 + 1)


def test_split_bucket_replay_equals_its_eager_run(dev):
    """A split bucket (reduced qwen3-4b, fp32, kernels on: 2 decode steps
    on S_d's SMs and a finishing chunk on S_p's) replayed from its CUDA
    graph gives its eager run's tokens, decode inputs and pools bitwise,
    and the sequential program's tokens."""
    from repro_torch.core.device import SmSplit
    from repro_torch.core.lookahead import BucketProgram, make_superiter_fn
    from repro_torch.serving.kvcache import PagePoolConfig, init_page_pools
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config("qwen3-4b"))
    model = Model.init(cfg, seed=0, dtype=torch.float32, device=dev,
                       attn_kernel=True)
    B, P, chunk = 4, 8, 24
    rng = np.random.default_rng(0)

    def world():
        pools = init_page_pools(cfg, PagePoolConfig(
            num_pages=(B + 1) * P + 1, page_size=8), torch.float32,
            device=dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        for group in pools:
            for t in group:
                t.copy_(torch.randn(t.shape, generator=gen, device=dev))
        return (pools, model.init_state_cache(B + 1),
                torch.arange(B + 1, dtype=torch.int32,
                             device=dev)[:, None] + 7,
                torch.full((B + 1,), 40, dtype=torch.int32, device=dev))
    # the chunk's slot B is inactive in the decode steps: its decode table
    # row is the null page, as the engine's, so no decode row reads the
    # pages the chunk writes meanwhile
    tables = np.arange(1, (B + 1) * P + 1).reshape(B + 1, P)
    feed = (np.arange(B + 1) < B, tables * (np.arange(B + 1) < B)[:, None],
            rng.integers(0, cfg.vocab_size, (1, chunk)), tables[-1:],
            (16, B, 0))
    split = SmSplit(dev, 32)
    outs = {}
    try:
        for label in ("sequential", "eager", "replayed"):
            fn = make_superiter_fn(model, 2, chunk=chunk, finish=True,
                                   sample=True, split=label != "sequential")
            bucket = BucketProgram(fn, dev, B + 1, width=P, chunk=chunk,
                                   pwidth=P, split=None if label ==
                                   "sequential" else split)
            bucket.feed(*feed)
            w = world()
            args = (*w, bucket.tables, None, bucket.active, bucket.pre_toks,
                    bucket.pre_tbl, bucket.pre_start, bucket.pre_slot,
                    bucket.override_tok)
            if label == "replayed":
                bucket.run(*args)
                w = world()
                args = (*w, *args[4:])
                out = bucket.capture(args, torch.cuda.graph_pool_handle())
            else:
                out = bucket.run(*args)
            torch.cuda.synchronize()
            outs[label] = [out[0], out[1], w[2], w[3]] + [
                t for g in w[0] for t in g]
    finally:
        split.close()
    for a, b in zip(outs["replayed"], outs["eager"]):
        assert torch.equal(a, b)
    for a, b in zip(outs["eager"][:2], outs["sequential"][:2]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the paged main path's kernels (paged_decode, split-KV, duet_attention_paged)
# at skewed contexts: masking, repeatability, capture, a green context
# ---------------------------------------------------------------------------
def _paged_case(dev, seed=11, ps=16):
    """qwen3-4b's heads, contexts 5, 17, 33, 300 and 2000: a decode batch and
    a duet launch (those rows beside a 40-row chunk at 500, engine tiles of
    16 rows, a pad tile) over one pool, bf16."""
    rng = np.random.default_rng(seed)
    H, G, Dh, P = 32, 8, 128, -(-2048 // ps)
    lens = (5, 17, 33, 300, 2000)
    B = len(lens)
    N = (B + 1) * P + 1
    kp = _randn(rng, (N, ps, G, Dh), "bfloat16", dev)
    vp = _randn(rng, (N, ps, G, Dh), "bfloat16", dev)
    tables = torch.tensor(1 + rng.permutation(N - 1).reshape(B + 1, P),
                          dtype=torch.int32, device=dev)
    q = _randn(rng, (B, H, Dh), "bfloat16", dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    sched = build_duet_schedule([(b, n - 1) for b, n in enumerate(lens)],
                                [(B, 500 + i) for i in range(40)],
                                block_q=16)
    dq = pack_duet_queries(sched, _randn(rng, (B + 40, H, Dh), "bfloat16",
                                         dev))
    dq = torch.cat([dq, torch.ones_like(dq[:16])]).contiguous()
    row_pos = torch.tensor(np.concatenate([sched.row_pos, [-1] * 16]),
                           dtype=torch.int32, device=dev)[:, None]
    tile_slot = torch.tensor(np.concatenate([sched.tile_slot, [-1]]),
                             dtype=torch.int32, device=dev)
    return dict(decode=(q, kp, vp, tables[:B].contiguous(), lengths),
                duet=(dq, row_pos.contiguous(), tile_slot, kp, vp, tables))


def _paged_calls(case):
    """The three wrappers of the paged main path on a case."""
    d, u = case["decode"], case["duet"]
    return (lambda: paged_decode(*d),
            lambda: paged_decode_splitkv(*d, num_splits=4),
            lambda: duet_attention_paged(*u, block_q=16))


@pytest.mark.parametrize("ps", [16, 12])
def test_paged_kernels_mask_nan_past_each_length(dev, ps):
    """NaN written into every key past a request's length in its last page
    (and past each decode row's position) must not reach the outputs,
    which stay finite and within ATTN_TOL of the plain versions on the
    clean pools: keys past a length are zero-filled, not read."""
    case = _paged_case(dev, ps=ps)
    q, kp, vp, tables, lengths = case["decode"]
    clean = (kp.clone(), vp.clone())
    for b, n in enumerate(lengths.tolist()):
        pid = int(tables[b, (n - 1) // ps])
        kp[pid, n - (n - 1) // ps * ps:] = float("nan")
        vp[pid, n - (n - 1) // ps * ps:] = float("nan")
    wants = (paged_decode_plain(q, *clean, tables, lengths),
             paged_decode_splitkv_plain(q, *clean, tables, lengths,
                                        num_splits=4),
             duet_attention_paged_plain(*case["duet"][:3], *clean,
                                        case["duet"][5], block_q=16))
    for call, want in zip(_paged_calls(case), wants):
        got = call()
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, **ATTN_TOL["bfloat16"])


def test_paged_kernels_are_bitwise_repeatable(dev):
    """Two launches on the same inputs give the same bits: each split's
    partials combine in a fixed order."""
    for call in _paged_calls(_paged_case(dev)):
        a = call()
        b = call()
        torch.cuda.synchronize()
        assert torch.equal(a, b)


def test_paged_kernels_replay_bitwise_from_a_graph(dev):
    """Each launch captured in a CUDA graph replays its eager run's bits,
    twice."""
    for call in _paged_calls(_paged_case(dev)):
        eager = call()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call()
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, eager)


def test_paged_kernels_launch_on_a_64_sm_split_stream(dev):
    """On an SM split's 64-SM green context each launch (its clusters
    sized to that context) is counted and matches its plain version."""
    from repro_torch.core.device import SmSplit
    case = _paged_case(dev)
    wants = (paged_decode_plain(*case["decode"]),
             paged_decode_splitkv_plain(*case["decode"], num_splits=4),
             duet_attention_paged_plain(*case["duet"], block_q=16))
    names = ("paged_decode", "paged_decode_splitkv", "duet_attention_paged")
    before = launch_counts()
    split = SmSplit(dev, 32)
    try:
        assert split.sms["decode"] == 64
        with torch.cuda.stream(split.decode_stream):
            gots = [call() for call in _paged_calls(case)]
        split.decode_stream.synchronize()
    finally:
        split.close()
    after = launch_counts()
    for name, got, want in zip(names, gots, wants):
        assert after[name] - before.get(name, 0) == 1
        torch.testing.assert_close(got, want, **ATTN_TOL["bfloat16"])


# ---------------------------------------------------------------------------
# paged_decode's block role on the warpgroup block (bf16, rep > 16, Dh
# 64-256, tables of at least ops.PAGED_WG_MIN_KEYS = 2048 keys; these cases
# use 4096): NaN past each length, repeatability, capture, a green context,
# split counts that are not powers of two
# ---------------------------------------------------------------------------
BLOCK_LENS = (5, 17, 33, 300, 2000, 4096)


def _block_case(dev, H, Dh, ps, seed=21):
    """MQA heads (H on one KV head), bf16: a decode batch at BLOCK_LENS over
    tables of 4096 keys in pages of ps, with NaN in every key and value past
    each length in its last page. Returns the case and the clean pools."""
    rng = np.random.default_rng(seed)
    B, P = len(BLOCK_LENS), -(-4096 // ps)
    N = B * P + 1
    kp = _randn(rng, (N, ps, 1, Dh), "bfloat16", dev)
    vp = _randn(rng, (N, ps, 1, Dh), "bfloat16", dev)
    tables = torch.tensor(1 + rng.permutation(N - 1).reshape(B, P),
                          dtype=torch.int32, device=dev)
    q = _randn(rng, (B, H, Dh), "bfloat16", dev)
    lengths = torch.tensor(BLOCK_LENS, dtype=torch.int32, device=dev)
    clean = (kp.clone(), vp.clone())
    for b, n in enumerate(BLOCK_LENS):
        pid = int(tables[b, (n - 1) // ps])
        for pool in (kp, vp):
            pool[pid, n - (n - 1) // ps * ps:] = float("nan")
    return (q, kp, vp, tables, lengths), clean


def _block_calls(case):
    """paged_decode and split-KV (S = 4) on a block-role case."""
    return (lambda: paged_decode(*case),
            lambda: paged_decode_splitkv(*case, num_splits=4))


@pytest.mark.parametrize("H,Dh,ps", [
    (48, 128, 16), (48, 128, 12), (48, 64, 16), (48, 256, 16),
    (96, 64, 12), (128, 128, 16), (128, 256, 12)])
def test_block_role_on_the_warpgroup_block(dev, H, Dh, ps):
    """paged_decode and split-KV on the warpgroup block at rep 48, 96 and
    128 (two head blocks), Dh 64, 128 and 256, pages of 16 and 12, NaN past
    every length: outputs finite and within ATTN_TOL of the plain versions
    and of the block's walk at the wrapper's cluster size (S for split-KV)
    on the clean pools; two launches bitwise equal."""
    from repro_torch.kernels.paged_decode import (cluster_for,
                                                  paged_decode_block_plain,
                                                  paged_engine)
    case, clean = _block_case(dev, H, Dh, ps)
    q, kp, _, tables, lengths = case
    assert paged_engine(q.dtype, Dh, tables.shape[1] * ps) == "warpgroup"
    C = cluster_for(q, kp, tables)
    wants = ((paged_decode_plain(q, *clean, tables, lengths),
              paged_decode_block_plain(q, *clean, tables, lengths,
                                       cluster=C)),
             (paged_decode_splitkv_plain(q, *clean, tables, lengths,
                                         num_splits=4),
              paged_decode_block_plain(q, *clean, tables, lengths,
                                       cluster=4)))
    before = launch_counts()
    for call, want in zip(_block_calls(case), wants):
        got = call()
        again = call()
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        for ref in want:
            torch.testing.assert_close(got, ref, **ATTN_TOL["bfloat16"])
        assert torch.equal(got, again)
    after = launch_counts()
    for name in ("paged_decode[block]", "paged_decode_splitkv[block]"):
        assert after[name] - before.get(name, 0) == 2


@pytest.mark.parametrize("num_splits", [3, 5, 6, 7])
def test_block_role_splitkv_takes_any_split_count(dev, num_splits):
    """Split-KV on the warpgroup block at split counts that are not powers
    of two (clusters of 3, 5, 6 and 7 CTAs), over tables of 2048 keys (the
    least the block takes), granite-20b's heads: every row of every head
    within ATTN_TOL of the plain version and of the block's walk at S
    ranks; two launches bitwise equal."""
    from repro_torch.kernels.ops import PAGED_WG_MIN_KEYS
    from repro_torch.kernels.paged_decode import (paged_decode_block_plain,
                                                  paged_engine)
    rng = np.random.default_rng(29)
    B, H, Dh, ps = 8, 48, 128, 16
    P = PAGED_WG_MIN_KEYS // ps
    N = B * P + 1
    kp = _randn(rng, (N, ps, 1, Dh), "bfloat16", dev)
    vp = _randn(rng, (N, ps, 1, Dh), "bfloat16", dev)
    tables = torch.tensor(1 + rng.permutation(N - 1).reshape(B, P),
                          dtype=torch.int32, device=dev)
    q = _randn(rng, (B, H, Dh), "bfloat16", dev)
    lengths = torch.tensor(np.linspace(1, P * ps, B).astype(np.int32),
                           device=dev)
    assert paged_engine(q.dtype, Dh, P * ps) == "warpgroup"
    case = (q, kp, vp, tables, lengths)
    got = paged_decode_splitkv(*case, num_splits=num_splits)
    again = paged_decode_splitkv(*case, num_splits=num_splits)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.equal(got, again)
    for want in (paged_decode_splitkv_plain(*case, num_splits=num_splits),
                 paged_decode_block_plain(*case, cluster=num_splits)):
        torch.testing.assert_close(got, want, **ATTN_TOL["bfloat16"])


@pytest.mark.parametrize("B,C", [(1, 16), (4, 16), (8, 8)])
def test_block_role_grid_at_granite_20b_batches(dev, B, C):
    """granite-20b's heads over tables of 4096 keys on the card: the
    warpgroup block's clusters of 16 up to a batch of 4 (at most 64 CTAs),
    clusters of 8 at a batch of 8 (64 CTAs), as the card's occupancy
    query and ops.cluster_cap give them."""
    from repro_torch.kernels.paged_decode import cluster_for
    q = torch.empty((B, 48, 128), dtype=torch.bfloat16, device=dev)
    kp = torch.empty((1, 16, 1, 128), dtype=torch.bfloat16, device=dev)
    tables = torch.empty((B, 256), dtype=torch.int32, device=dev)
    assert cluster_for(q, kp, tables) == C


def test_block_role_replays_bitwise_from_a_graph(dev):
    """Each warpgroup-block launch captured in a CUDA graph replays its
    eager run's bits, twice."""
    case, _ = _block_case(dev, 48, 128, 16)
    for call in _block_calls(case):
        eager = call()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call()
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, eager)


def test_block_role_launches_on_a_64_sm_split_stream(dev):
    """On an SM split's 64-SM green context each warpgroup-block launch
    (its clusters sized to that context) is counted and matches its plain
    version."""
    from repro_torch.core.device import SmSplit
    case, clean = _block_case(dev, 48, 128, 16)
    q, _, _, tables, lengths = case
    wants = (paged_decode_plain(q, *clean, tables, lengths),
             paged_decode_splitkv_plain(q, *clean, tables, lengths,
                                        num_splits=4))
    names = ("paged_decode[block]", "paged_decode_splitkv[block]")
    before = launch_counts()
    split = SmSplit(dev, 32)
    try:
        assert split.sms["decode"] == 64
        with torch.cuda.stream(split.decode_stream):
            gots = [call() for call in _block_calls(case)]
        split.decode_stream.synchronize()
    finally:
        split.close()
    after = launch_counts()
    for name, got, want in zip(names, gots, wants):
        assert after[name] - before.get(name, 0) == 1
        torch.testing.assert_close(got, want, **ATTN_TOL["bfloat16"])


# ---------------------------------------------------------------------------
# the slab duet_attention's block role (bf16, one-row tiles at rep > 16, Dh
# 64-256, prefill_core.cuh's block) over slabs of 4096 keys: NaN past each
# row's position, the log-sum-exp, repeatability, capture, a green context
# ---------------------------------------------------------------------------
SLAB_POS = (0, 16, 32, 299, 1999, 4095)
# the bf16 log-sum-exp, as chip_smoke.py holds it: l sums the bf16-rounded
# P, about 2^-9 of each key's weight
LSE_TOL = dict(atol=1e-2, rtol=1e-3)


def _slab_block_case(dev, H, Dh, seed=23):
    """MQA heads (H on one KV head), bf16: one-row decode tiles at
    SLAB_POS and a pad tile over slabs of 4096 keys, NaN in every key and
    value past each row's position in its slot. Returns the case and the
    clean slabs."""
    rng = np.random.default_rng(seed)
    T, S = len(SLAB_POS) + 1, 4096
    ks = _randn(rng, (T, S, 1, Dh), "bfloat16", dev)
    vs = _randn(rng, (T, S, 1, Dh), "bfloat16", dev)
    q = _randn(rng, (T, H, Dh), "bfloat16", dev)
    slots = rng.permutation(T - 1).tolist()
    tile_slot = torch.tensor(slots + [-1], dtype=torch.int32, device=dev)
    row_pos = torch.tensor([[p] for p in SLAB_POS] + [[-1]],
                           dtype=torch.int32, device=dev)
    clean = (ks.clone(), vs.clone())
    for slot, p in zip(slots, SLAB_POS):
        for slab in (ks, vs):
            slab[slot, p + 1:] = float("nan")
    return (q, row_pos, tile_slot, ks, vs), clean


@pytest.mark.parametrize("H,Dh", [(48, 128), (48, 64), (48, 256), (96, 64),
                                  (128, 128), (128, 256)])
def test_slab_block_role_with_lse(dev, H, Dh):
    """The slab duet_attention's one-row tiles at rep 48, 96 and 128, Dh
    64, 128 and 256, NaN past every position: output and log-sum-exp
    finite on the live rows and within ATTN_TOL of the plain version on
    the clean slabs, the pad tile zeros and -inf; two launches bitwise
    equal."""
    case, clean = _slab_block_case(dev, H, Dh)
    q, row_pos, tile_slot = case[:3]
    want, want_lse = duet_attention_plain(q, row_pos, tile_slot, *clean,
                                          block_q=1, return_lse=True)
    before = launch_counts()
    got, lse = duet_attention(*case, block_q=1, return_lse=True)
    again, again_lse = duet_attention(*case, block_q=1, return_lse=True)
    plain_out = duet_attention(*case, block_q=1)
    torch.cuda.synchronize()
    live = slice(0, len(SLAB_POS))
    assert torch.isfinite(got[live]).all() and torch.isfinite(lse[live]).all()
    torch.testing.assert_close(got[live], want[live], **ATTN_TOL["bfloat16"])
    torch.testing.assert_close(lse[live], want_lse[live], **LSE_TOL)
    assert not got[-1].any() and torch.isinf(lse[-1]).all()
    assert torch.equal(got, again) and torch.equal(lse, again_lse)
    torch.testing.assert_close(plain_out[live], want[live],
                               **ATTN_TOL["bfloat16"])
    assert launch_counts()["duet_attention[block]"] - \
        before.get("duet_attention[block]", 0) == 3


def test_slab_block_role_replays_bitwise_from_a_graph(dev):
    """The slab block role's launch, with its log-sum-exp, captured in a
    CUDA graph replays its eager run's bits, twice."""
    case, _ = _slab_block_case(dev, 48, 128)
    eager = duet_attention(*case, block_q=1, return_lse=True)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = duet_attention(*case, block_q=1, return_lse=True)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, eager))


def test_slab_block_role_launches_on_a_64_sm_split_stream(dev):
    """On an SM split's 64-SM green context the slab block role's launch
    (its clusters sized to that context) is counted and matches its plain
    version."""
    from repro_torch.core.device import SmSplit
    case, clean = _slab_block_case(dev, 48, 128)
    q, row_pos, tile_slot = case[:3]
    want = duet_attention_plain(q, row_pos, tile_slot, *clean, block_q=1)
    before = launch_counts()
    split = SmSplit(dev, 32)
    try:
        assert split.sms["decode"] == 64
        with torch.cuda.stream(split.decode_stream):
            got = duet_attention(*case, block_q=1)
        split.decode_stream.synchronize()
    finally:
        split.close()
    assert launch_counts()["duet_attention[block]"] - \
        before.get("duet_attention[block]", 0) == 1
    live = slice(0, len(SLAB_POS))
    torch.testing.assert_close(got[live], want[live], **ATTN_TOL["bfloat16"])
