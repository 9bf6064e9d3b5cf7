"""Port parity for slab-KV serving (``EngineConfig(paged=False)``) on the
CPU: the plain versions of the slab ``duet_attention`` and
``flash_prefill`` kernels against the JAX Pallas kernels in interpret mode,
the port's slab model (chunked prefill + decode step, with and without the
kernel hook; the sliding ring buffer) against the JAX ``Model``, and both
port engines with ``paged=False`` against a greedy oracle from the JAX
``Model.forward`` and against the port's paged engine.

Inputs come from seeded numpy generators and feed both packages. The JAX
engines are not the oracle: with jax 0.9 on a CPU backend they raise a
ShardingTypeError, while the model-level functions run. Tolerances: the
kernel tests' (float32 2e-5, bfloat16 2e-2); 3e-5 for flash_prefill
against the model's attention (the reference's own test); 1e-4 for float32
logits (the two packages differ only in summation order)."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.kernels import build_duet_schedule as jbuild_duet_schedule
from repro.kernels import pack_duet_queries as jpack_duet_queries
from repro.kernels import unpack_duet_output as junpack_duet_output
from repro.kernels.duet_attention import duet_attention as jduet_attention
from repro.kernels.flash_prefill import flash_prefill as jflash_prefill
from repro.kernels.ref import flash_prefill_ref as jflash_prefill_ref
from repro.models import Model as JModel
from repro.serving.request import synth_prompt_tokens as jsynth
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import (build_duet_schedule, launch_counts,
                                 pack_duet_queries, unpack_duet_output)
from repro_torch.kernels.duet_attention import (duet_attention,
                                                duet_attention_plain)
from repro_torch.kernels.flash_prefill import (flash_prefill,
                                               flash_prefill_plain)
from repro_torch.kernels.ref import flash_prefill_ref
from repro_torch.models import Model, params_from_jax
from repro_torch.models import attention as attn_mod
from repro_torch.serving import (AsyncDuetEngine, DuetEngine, EngineConfig,
                                 FinishEvent, Request, TokenEvent)

REPO = Path(__file__).resolve().parents[1]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LOGIT_TOL = 1e-4

KW = dict(max_slots=3, max_len=128, token_budget=48, page_size=8)
# arrivals 0.3 ms apart on the virtual clock: later prompts prefill while
# earlier requests decode
SPECS = [(i, i * 0.0003, 20 + 7 * i, 6 + i) for i in range(5)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the reduced model's ops are tiny, and with the
    suite's parallel workers sharing the cores, torch's default thread
    team per op slows these tests by an order of magnitude or more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(arr, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(arr, jd), torch.from_numpy(arr).to(td)


def _close(got_t, want_j, tol):
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_j, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# kernels: plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("share", [0.1, 0.3, 0.7])
def test_slab_duet_attention_plain_matches_pallas(share, dtype):
    """The mixed-phase schedule of the reference's kernel test: 3 decode
    rows and a 20-row prefill chunk over a (4, 256) slab, block_q 8."""
    Ns, S, H, G, Dh, bq = 4, 256, 4, 2, 64, 8
    rng = np.random.default_rng(0)
    jk, tk = _both(rng.standard_normal((Ns, S, G, Dh), np.float32), dtype)
    jv, tv = _both(rng.standard_normal((Ns, S, G, Dh), np.float32), dtype)
    decode_rows = [(0, 100), (1, 57), (2, 200)]
    prefill_rows = [(3, 64 + i) for i in range(20)]
    n = len(decode_rows) + len(prefill_rows)
    jq, tq = _both(rng.standard_normal((n, H, Dh), np.float32), dtype)
    jsched = jbuild_duet_schedule(decode_rows, prefill_rows, block_q=bq,
                                  decode_share=share)
    sched = build_duet_schedule(decode_rows, prefill_rows, block_q=bq,
                                decode_share=share)
    np.testing.assert_array_equal(sched.tile_slot, jsched.tile_slot)
    want = junpack_duet_output(jsched, jduet_attention(
        jpack_duet_queries(jsched, jq),
        jnp.asarray(jsched.row_pos)[:, None], jnp.asarray(jsched.tile_slot),
        jk, jv, block_q=bq, block_k=128, interpret=True), n)
    got = unpack_duet_output(sched, duet_attention(
        pack_duet_queries(sched, tq),
        torch.from_numpy(sched.row_pos)[:, None],
        torch.from_numpy(sched.tile_slot), tk, tv, block_q=bq, block_k=128),
        n)
    _close(got, want, TOL[dtype])


def test_slab_duet_attention_pad_rows_and_tiles_are_zero():
    """Pad rows (row_pos -1) and pad tiles (tile_slot -1) come out as
    zeros; live rows equal the plain version on the unpadded input. A slab
    whose length is not a multiple of block_k is refused (the reference's
    contract)."""
    rng = np.random.default_rng(1)
    k = torch.from_numpy(rng.standard_normal((2, 32, 2, 32), np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 32, 2, 32), np.float32))
    q = torch.from_numpy(rng.standard_normal((6, 4, 32), np.float32))
    row_pos = torch.tensor([[5], [-1], [31], [0], [-1], [-1]],
                           dtype=torch.int32)
    tile_slot = torch.tensor([0, 1, -1], dtype=torch.int32)
    out = duet_attention_plain(q, row_pos, tile_slot, k, v, block_q=2)
    assert not out[[1, 4, 5]].any()
    live = duet_attention_plain(q[[0, 2, 3]], row_pos[[0, 2, 3]],
                                torch.tensor([0, 1, 1], dtype=torch.int32),
                                k, v, block_q=1)
    torch.testing.assert_close(out[[0, 2, 3]], live)
    with pytest.raises(ValueError, match="block_k"):
        duet_attention(q, row_pos, tile_slot, k, v, block_q=2, block_k=24)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,G,Dh,off,kv_len", [
    (1, 128, 128, 4, 2, 64, 0, None),
    (2, 128, 256, 4, 4, 64, 128, None),     # chunked-prefill offset
    (1, 256, 256, 8, 2, 128, 0, None),
    (1, 128, 128, 4, 1, 64, 0, None),       # MQA
    (1, 128, 256, 4, 2, 64, 128, 200),      # padded keys past kv_len
])
def test_flash_prefill_plain_matches_pallas(B, Sq, Sk, H, G, Dh, off, kv_len,
                                            dtype):
    rng = np.random.default_rng(2)
    jq, tq = _both(rng.standard_normal((B, Sq, H, Dh), np.float32), dtype)
    jk, tk = _both(rng.standard_normal((B, Sk, G, Dh), np.float32), dtype)
    jv, tv = _both(rng.standard_normal((B, Sk, G, Dh), np.float32), dtype)
    want = jflash_prefill(jq, jk, jv, q_offset=off, kv_len=kv_len,
                          interpret=True)
    got = flash_prefill(tq, tk, tv, q_offset=off, kv_len=kv_len)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_prefill_ragged_shapes_match_jax_oracle(dtype):
    """Sq and Sk need not divide by 128 in the port: a 77-query chunk at
    offset 100 over 177 keys against the reference's jnp oracle, and the
    port's own oracle agrees."""
    rng = np.random.default_rng(3)
    jq, tq = _both(rng.standard_normal((2, 77, 4, 64), np.float32), dtype)
    jk, tk = _both(rng.standard_normal((2, 177, 2, 64), np.float32), dtype)
    jv, tv = _both(rng.standard_normal((2, 177, 2, 64), np.float32), dtype)
    want = jflash_prefill_ref(jq, jk, jv, q_offset=100)
    _close(flash_prefill_plain(tq, tk, tv, q_offset=100), want, TOL[dtype])
    _close(flash_prefill_ref(tq, tk, tv, q_offset=100), want, TOL[dtype])


def test_flash_prefill_matches_model_attention():
    """The reference's cross-check (tests/test_kernels.py): flash_prefill on
    gqa_prefill's own q/K/V gives gqa_prefill's attention."""
    cfg = reduced(get_config("qwen3-4b"))
    rng = np.random.default_rng(4)
    D, H, G, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    params = {name: torch.from_numpy(0.1 * rng.standard_normal(
        shape, np.float32)) for name, shape in (
        ("w_q", (D, H, Dh)), ("w_k", (D, G, Dh)), ("w_v", (D, G, Dh)),
        ("w_o", (H, Dh, D)))}
    x = torch.from_numpy(rng.standard_normal((1, 128, D), np.float32))
    positions = torch.arange(128)[None]
    out_model, cache = attn_mod.gqa_prefill(params, cfg, x, positions)
    q = attn_mod.apply_rope(torch.einsum("bsd,dhe->bshe", x, params["w_q"]),
                            positions, cfg.rope_theta)
    out_kernel = torch.einsum("bshe,hed->bsd",
                              flash_prefill(q, cache.k, cache.v),
                              params["w_o"])
    torch.testing.assert_close(out_kernel, out_model, atol=3e-5, rtol=3e-5)


# ---------------------------------------------------------------------------
# model: slab prefill + decode step against the JAX Model
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def setup():
    jcfg = jreduced(jget_config("qwen3-4b"))
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = reduced(get_config("qwen3-4b"))
    host = jax.tree.map(np.asarray, jparams)
    tmodel = Model(tcfg, params_from_jax(tcfg, host), attn_kernel=True)
    return jcfg, jparams, host, tcfg, tmodel


@pytest.mark.parametrize("attn_kernel", [False, True])
def test_slab_prefill_and_decode_match_jax(setup, attn_kernel):
    """Chunked prefill into the slab (5 + 6 tokens) and one decode step,
    with the kernel hook off and on, in float32."""
    jcfg, jparams, host, tcfg, tmodel = setup
    jm = JModel(jcfg, attn_kernel=attn_kernel)
    tm = Model(tcfg, params_from_jax(tcfg, host), attn_kernel=attn_kernel)
    B, S = 2, 12
    toks = np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (B, S)).astype(np.int32)
    pos = np.full((B,), S - 1, np.int32)
    slab = jm.init_cache(B, 128)
    jl1, slab = jm.prefill(jparams, jnp.asarray(toks[:, :5]), cache=slab)
    jl2, slab = jm.prefill(jparams, jnp.asarray(toks[:, 5:S - 1]),
                           cache=slab, start_pos=5)
    jl3, slab = jm.decode_step(jparams, slab, jnp.asarray(toks[:, S - 1:]),
                               jnp.asarray(pos))
    cache = tm.init_cache(B, 128)
    with torch.no_grad():
        tl1, cache = tm.prefill(torch.from_numpy(toks[:, :5]), cache=cache)
        tl2, cache = tm.prefill(torch.from_numpy(toks[:, 5:S - 1]),
                                cache=cache, start_pos=5)
        tl3, cache = tm.decode_step(cache, torch.from_numpy(toks[:, S - 1:]),
                                    torch.from_numpy(pos))
    for got, want in ((tl1, jl1), (tl2, jl2), (tl3, jl3)):
        _close(got, want, LOGIT_TOL)
    for (tk, tv), js in zip(cache, slab):
        _close(tk, js.k, LOGIT_TOL)
        _close(tv, js.v, LOGIT_TOL)


def test_full_sequence_prefill_matches_jax(setup):
    """``prefill`` without a cache returns the new K/V per layer."""
    jcfg, jparams, host, tcfg, tmodel = setup
    toks = np.random.default_rng(6).integers(
        0, tcfg.vocab_size, (2, 9)).astype(np.int32)
    jl, jcache = JModel(jcfg).prefill(jparams, jnp.asarray(toks))
    with torch.no_grad():
        tl, tcache = tmodel.prefill(torch.from_numpy(toks))
    _close(tl, jl, LOGIT_TOL)
    for (tk, tv), js in zip(tcache, jcache):
        _close(tk, js.k, LOGIT_TOL)
        _close(tv, js.v, LOGIT_TOL)


def test_sliding_ring_buffer_matches_jax_forward(setup):
    """Chunked ring-buffer prefill (the second chunk wraps the ring) plus a
    sliding decode step equal exact windowed attention: the JAX full
    forward with the sliding mask (the reference's consistency test)."""
    jcfg, jparams, host, tcfg, tmodel = setup
    jc = dataclasses.replace(jcfg, sliding_window=8)
    tc = dataclasses.replace(tcfg, sliding_window=8)
    tm = Model(tc, params_from_jax(tc, host))
    B, S = 1, 20
    toks = np.random.default_rng(7).integers(
        0, tc.vocab_size, (B, S)).astype(np.int32)
    want = JModel(jc).forward(jparams, jnp.asarray(toks), sliding=True)[:, -1]
    ring = tm.init_cache(B, S + 4, sliding=True)
    assert ring[0].k.shape[1] == 8
    with torch.no_grad():
        _, ring = tm.prefill(torch.from_numpy(toks[:, :7]), cache=ring,
                             sliding=True)
        _, ring = tm.prefill(torch.from_numpy(toks[:, 7:S - 1]), cache=ring,
                             start_pos=7, sliding=True)
        got, _ = tm.decode_step(ring, torch.from_numpy(toks[:, S - 1:]),
                                torch.full((B,), S - 1, dtype=torch.int32),
                                sliding=True)
    _close(got, want, LOGIT_TOL)


# ---------------------------------------------------------------------------
# engines: paged=False against the JAX greedy oracle and the paged engine
# ---------------------------------------------------------------------------
def greedy_oracle(forward, vocab, specs):
    """Greedy continuations from the JAX full-sequence forward, every
    sequence right-padded to one length (causal attention hides the
    padding from earlier positions)."""
    seqs = {rid: list(jsynth(rid, vocab, p)) for rid, _, p, _ in specs}
    want = {rid: o for rid, _, _, o in specs}
    out = {rid: [] for rid in seqs}
    L = max(p + o for _, _, p, o in specs)
    for _ in range(max(want.values())):
        batch = np.zeros((len(seqs), L), np.int32)
        for i, s in enumerate(seqs.values()):
            batch[i, :len(s)] = s
        logits = np.asarray(forward(jnp.asarray(batch)))
        for i, (rid, s) in enumerate(seqs.items()):
            if len(out[rid]) < want[rid]:
                tok = int(np.argmax(logits[i, len(s) - 1]))
                s.append(tok)
                out[rid].append(tok)
    return out


@pytest.fixture(scope="module")
def oracle(setup):
    jcfg, jparams, host, tcfg, tmodel = setup
    jm = JModel(jcfg)
    forward = jax.jit(lambda toks: jm.forward(jparams, toks))
    return greedy_oracle(forward, tcfg.vocab_size, SPECS)


def _serve(cls, model, specs, **kw):
    eng = cls(model, EngineConfig(**kw), device="cpu")
    eng.submit([Request(rid=r, arrival=a, prompt_len=p, output_len=o)
                for r, a, p, o in specs])
    metrics = eng.run()
    return eng, metrics, {r.rid: list(r.output_tokens)
                          for r in metrics.requests}


@pytest.mark.parametrize("attn_kernel", [False, True])
def test_slab_sync_engine_matches_jax_greedy_oracle(setup, oracle,
                                                    attn_kernel):
    jcfg, jparams, host, tcfg, tmodel = setup
    model = Model(tcfg, params_from_jax(tcfg, host), attn_kernel=attn_kernel)
    before = launch_counts()
    eng, metrics, toks = _serve(DuetEngine, model, SPECS, paged=False, **KW)
    assert eng.kernel_path == "torch"        # CPU: the plain versions run
    assert eng.pools is None and eng.prefix_cache is False
    assert metrics.summary()["num_finished"] == len(SPECS)
    assert toks == oracle
    assert eng.kv_mgr.used_pages == 0
    # on the CPU no kernel launches, whatever the hook
    assert launch_counts() == before


def test_slab_async_engine_matches_sync_and_oracle(setup, oracle):
    """Async slab tokens, event stream and metrics equal the sync slab
    engine's; at most one host sync per super-iteration; no duet
    dispatch (the fused duet kernel is paged-only)."""
    jcfg, jparams, host, tcfg, tmodel = setup
    _, sync_metrics, _ = _serve(DuetEngine, tmodel, SPECS, paged=False,
                                **KW)
    eng = AsyncDuetEngine(tmodel, EngineConfig(paged=False, **KW),
                          device="cpu")
    eng.submit([Request(rid=r, arrival=a, prompt_len=p, output_len=o)
                for r, a, p, o in SPECS])
    stream = {}
    for ev in eng.events():
        if isinstance(ev, TokenEvent):
            toks = stream.setdefault(ev.rid, [])
            assert ev.index == len(toks)
            toks.append(ev.token)
        elif isinstance(ev, FinishEvent):
            assert ev.reason == "completed"
    metrics = eng.run()
    assert {r.rid: list(r.output_tokens) for r in metrics.requests} == \
        oracle
    assert stream == oracle
    assert metrics.summary() == sync_metrics.summary()
    st = eng.dstats
    assert 0 < st.host_syncs <= st.super_iterations
    assert not any(key[-1] for key in eng._programs)
    assert eng.kv_mgr.used_pages == 0


@pytest.mark.parametrize("cls", [DuetEngine, AsyncDuetEngine])
def test_slab_engine_matches_paged_engine(setup, cls):
    """The slab engine is the paged engine's equivalence oracle: the same
    workload gives the same greedy tokens (kernel hook on)."""
    jcfg, jparams, host, tcfg, tmodel = setup
    _, _, slab = _serve(cls, tmodel, SPECS, paged=False, **KW)
    _, _, paged = _serve(cls, tmodel, SPECS, paged=True, **KW)
    assert slab == paged


@pytest.mark.parametrize("cls", [DuetEngine, AsyncDuetEngine])
def test_slab_engine_rejects_overlong_requests(setup, cls):
    """Footprints (40 + 8 tokens) beyond the slab row (max_len 32) end
    with a recorded ``rejected:`` outcome, never silently dropped; the
    paged engine with a larger pool serves the same requests."""
    jcfg, jparams, host, tcfg, tmodel = setup
    specs = [(i, 0.01 * i, 40, 8) for i in range(4)]
    kw = dict(max_slots=2, max_len=32, token_budget=48, page_size=8)
    _, metrics, _ = _serve(cls, tmodel, specs, paged=False, **kw)
    s = metrics.summary()
    assert s["num_rejected"] == 4 and s["num_finished"] == 0
    assert all(r.finish_reason.startswith("rejected:")
               for r in metrics.requests)
    eng, metrics, _ = _serve(cls, tmodel, specs, paged=True,
                             kv_pool_tokens=256, **kw)
    assert metrics.summary()["num_finished"] == 4
    assert eng.kv_mgr.used_pages == 0


def test_slab_inactive_slot_rows_stay_untouched(setup):
    """A decode step with an inactive slot leaves that slot's slab row, its
    token and its position as they were (the slot may belong to a request
    that is mid-prefill)."""
    from repro_torch.core.lookahead import lookahead_decode
    jcfg, jparams, host, tcfg, tmodel = setup
    rng = np.random.default_rng(8)
    cache = tmodel.init_cache(2, 32)
    for layer in cache:
        for t in layer:
            t.copy_(torch.from_numpy(rng.standard_normal(t.shape, np.float32)))
    before = [[t.clone() for t in layer] for layer in cache]
    tok = torch.tensor([[3], [4]], dtype=torch.int32)
    pos = torch.tensor([10, 20], dtype=torch.int32)
    active = torch.tensor([True, False])
    with torch.no_grad():
        toks, cache, new_pos = lookahead_decode(tmodel, cache, tok, pos, 2,
                                                active_mask=active)
    assert new_pos.tolist() == [12, 20]
    assert toks[1].tolist() == [4, 4]
    for layer, old in zip(cache, before):
        for t, o in zip(layer, old):
            torch.testing.assert_close(t[1], o[1], rtol=0, atol=0)
            assert not torch.equal(t[0, 10:12], o[0, 10:12])
            torch.testing.assert_close(t[0, :10], o[0, :10], rtol=0, atol=0)


def test_cli_no_paged_serves_on_cpu():
    """``--no-paged`` serves through the slab engines: every request
    finishes, the summary has no prefix_cache block, and the async engine
    keeps host_syncs <= super_iterations."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--no-paged", "--stream", "--num-requests", "4",
         "--max-len", "128", "--attn-kernel"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    finishes = [json.loads(ln) for ln in proc.stdout.splitlines()
                if ln.startswith('{"event": "finish"')]
    assert sorted(f["rid"] for f in finishes) == [0, 1, 2, 3]
    assert all(f["reason"] == "completed" for f in finishes)
    summary = json.loads(proc.stdout[proc.stdout.index("\n{\n") + 1:])
    assert summary["num_finished"] == 4
    assert "prefix_cache" not in summary
    st = summary["dispatch_stats"]
    assert 0 < st["host_syncs"] <= st["super_iterations"]
