"""The SM split on the CPU: what the card runs on two green contexts at
once, checked where the halves run one after the other.

(a) The lone chunk's kernel route (``gqa_prefill_paged`` with
``prefill_packing``: one ``duet_attention_paged`` launch with no decode
rows, its plain version here) against the JAX ``gqa_prefill_paged`` on
the same pools, in fp32 and bf16 at ``tests/test_kernels.py``'s TOL, a
chunk at 0 and one mid-prompt, two batch rows, a padded last tile; and
the packing against ``build_duet_schedule([], rows)`` with the kernel's
plain version against the JAX ``duet_attention_paged`` in interpret mode
on it.
(b) The split program's halves (``make_superiter_fn(..., split=True)``),
run in turn and joined (``run_halves``), in a short serving script of
reduced qwen3-4b (fp32): a mid-prompt chunk and a finishing one beside
decode steps, and a resume override. Tokens, pools and decode inputs are
bitwise the sequential program's, and the tokens the JAX greedy oracle's.
(c) The halves in either order give the same bits.
(d) With the card's ``unit_step`` (the driver's 4 TPCs), Algorithm 1
returns S_d at its multiples and prices the S_d it returns; the engine's
clock charges that price.
(e) ``sm_split=True`` raises on the CPU and under TP; an engine made to
split (its halves in turn, a stand-in for the green contexts) serves the
oracle's tokens, and a split bucket's key holds S_d and no per-dispatch
scalar.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.kernels import ops as jops
from repro.kernels.duet_attention import \
    duet_attention_paged as jax_duet_attention_paged
from repro.models import Model as JModel
from repro.models import attention as jattn
from repro.models.params import init_params as jinit_params
from repro.serving.request import synth_prompt_tokens as jsynth
from repro_torch.configs import get_config, reduced
from repro_torch.core import lookahead
from repro_torch.core.device import DeviceContext
from repro_torch.core.lookahead import (BucketProgram, SplitHalves,
                                        _scalar, make_superiter_fn)
from repro_torch.core.multiplexer import (AdaptiveMultiplexer,
                                          TabulatedPartitionCurves)
from repro_torch.core.roofline import RequestLoad, card_spec
from repro_torch.kernels.duet_attention import duet_attention_paged
from repro_torch.kernels.ops import build_duet_schedule, duet_block_q
from repro_torch.models import Model, params_from_jax
from repro_torch.models import attention as attn
from repro_torch.models.params import shard_params
from repro_torch.serving import (AsyncDuetEngine, DuetEngine, EngineConfig,
                                 Request)
from repro_torch.serving import async_engine
from repro_torch.serving.kvcache import PagePoolConfig, init_page_pools
from test_torch_engine import KW, SPECS, greedy_oracle

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}       # tests/test_kernels.py
H100 = types.SimpleNamespace(name="NVIDIA H100 80GB HBM3",
                             multi_processor_count=132)
UNITS, STEP = 66, 4
BW = {u: 3.35e12 * (1.0 - np.exp(-u / 9.0)) for u in range(1, UNITS + 1)}
# the card as device_pricing gives it on an H100: the driver's step of 8
# SMs between green-context groups is 4 TPCs
CARD4 = TabulatedPartitionCurves(
    card_spec(H100, unit_step=STEP),
    {u: card_spec(H100).pi(u) for u in BW}, BW)
PS, PAGES, SLOTS, WIDTH = 8, 16, 3, 8
# the script's requests: (rid, arrival, prompt, output)
SCRIPT = ((0, 0.0, 24, 8), (1, 0.0, 40, 4))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread (the engine test files' fixture): the reduced
    model's ops are tiny, and the suite's parallel workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """Reduced qwen3-4b: the JAX config and weights, the port's model on
    them with the kernel path on, and the JAX full-sequence forward."""
    jcfg = jreduced(jget_config("qwen3-4b"))
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = reduced(get_config("qwen3-4b"))
    tmodel = Model(tcfg, params_from_jax(
        tcfg, jax.tree.map(np.asarray, jparams)), attn_kernel=True)
    forward = jax.jit(lambda toks: jmodel.forward(jparams, toks))
    return jcfg, tcfg, tmodel, forward


# ---------------------------------------------------------------- the halves
def run_halves(halves: SplitHalves, args, first: str = "decode"):
    """The split program with its halves run one after the other
    (``first`` first) and then joined, where ``lookahead.fork_join`` runs
    them at once on two green contexts: the paged program's result."""
    (pools, state, last_tok, pos, tables, gen, active, pre_toks, pre_tbl,
     pre_start, pre_slot, override_tok) = args
    dev = last_tok.device
    pre_start, pre_slot, override_tok = (
        _scalar(v, dev) for v in (pre_start, pre_slot, override_tok))
    work = {"decode": lambda: halves.decode(pools, state, last_tok, pos,
                                            tables, gen, active),
            "prefill": lambda: halves.prefill(pools, state, pre_toks,
                                              pre_tbl, pre_start, pre_slot,
                                              override_tok)}
    second = "prefill" if first == "decode" else "decode"
    out = {h: work[h]() for h in (first, second)}
    toks, new_tok, new_pos = out["decode"]
    tok, sampled = out["prefill"]
    halves.join(last_tok, pos, new_tok, new_pos, tok, pre_start, pre_slot)
    return toks, sampled


# ----------------------------------------------------------------------- (a)
def _pools(rng, cfg, N, dtype):
    shape = (N, PS, cfg.num_kv_heads, cfg.head_dim)
    return [rng.standard_normal(shape, np.float32) for _ in range(2)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("start", [0, 24])
def test_chunk_kernel_route_matches_jax_prefill(setup, dtype, start):
    """(a) Two batch rows of a 37-row chunk (tiles of 32: the last one
    padded) at position 0 and mid-prompt (earlier keys already in the
    pages), through the kernel route's plain version, against the JAX
    gqa_prefill_paged: the output and both pools."""
    jcfg, tcfg, _, _ = setup
    td, jd = DTYPES[dtype]
    rng = np.random.default_rng(3)
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))["layers"][0]["attn"]
    L, B, P = 37, 2, 8
    kp, vp = _pools(rng, tcfg, B * P + 1, dtype)
    tables = (1 + rng.permutation(B * P)).reshape(B, P).astype(np.int32)
    x = rng.standard_normal((B, L, tcfg.d_model), np.float32)
    pos = np.broadcast_to(start + np.arange(L, dtype=np.int32), (B, L))
    jout, (jk, jv) = jattn.gqa_prefill_paged(
        {k: jnp.asarray(v, jd) for k, v in jp.items()}, jcfg,
        jnp.asarray(x, jd), jnp.asarray(pos), jnp.asarray(kp, jd),
        jnp.asarray(vp, jd), jnp.asarray(tables))
    tp = {k: torch.from_numpy(np.array(v)).to(td) for k, v in jp.items()}
    tk, tv = (torch.from_numpy(a).to(td) for a in (kp, vp))
    tpos = torch.from_numpy(pos.copy())
    bq = duet_block_q(tcfg.num_heads, tcfg.num_kv_heads, tcfg.head_dim)
    assert L % bq
    out, (tk, tv) = attn.gqa_prefill_paged(
        tp, tcfg, torch.from_numpy(x).to(td), tpos, tk, tv,
        torch.from_numpy(tables), packing=attn.prefill_packing(tpos, bq))
    for got, want in ((out, jout), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=TOL[dtype], rtol=TOL[dtype])


def test_chunk_packing_is_the_reference_schedule_and_kernel():
    """(a) prefill_packing is build_duet_schedule with no decode rows
    (tiles, rows, positions, pads); the kernel's plain version on it
    against the JAX duet_attention_paged in interpret mode on that
    schedule, on the live rows."""
    rng = np.random.default_rng(4)
    H, G, Dh, P, B, L, start = 4, 2, 64, 8, 2, 37, 20
    bq = duet_block_q(H, G, Dh)
    rows = [(b, start + i) for b in range(B) for i in range(L)]
    sched = build_duet_schedule([], rows, block_q=bq)
    assert sched.num_decode_tiles == 0
    pos = torch.from_numpy(np.broadcast_to(
        start + np.arange(L, dtype=np.int32), (B, L)).copy())
    src, row_pos, tile_slot, dst = attn.prefill_packing(pos, bq)
    order = torch.where(row_pos[:, 0] >= 0, src, torch.full_like(src, -1))
    np.testing.assert_array_equal(order.numpy(), sched.row_src)
    np.testing.assert_array_equal(row_pos[:, 0].numpy(), sched.row_pos)
    np.testing.assert_array_equal(tile_slot.numpy(), sched.tile_slot)
    kp, vp = (rng.standard_normal((B * P + 1, PS, G, Dh), np.float32)
              for _ in range(2))
    tables = (1 + rng.permutation(B * P)).reshape(B, P).astype(np.int32)
    src_q = rng.standard_normal((B * L, H, Dh), np.float32)
    got = duet_attention_paged(
        torch.from_numpy(src_q).index_select(0, src), row_pos, tile_slot,
        torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), block_q=bq)
    got = got.new_zeros((B * L + 1, H, Dh)).index_copy_(0, dst, got)[:-1]
    want = jax_duet_attention_paged(
        jops.pack_duet_queries(sched, jnp.asarray(src_q)),
        jnp.asarray(sched.row_pos)[:, None], jnp.asarray(sched.tile_slot),
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables), block_q=bq,
        interpret=True)
    want = jops.unpack_duet_output(sched, want, B * L)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL["float32"], rtol=TOL["float32"])


# ------------------------------------------------------------------- (b, c)
def _row(pages):
    return np.pad(np.asarray(pages, np.int32), (0, WIDTH - len(pages)))


def _serve_script(model, vocab, split, resume_tok=None):
    """Request 0 (slot 0) prefilled whole, then decoded beside request 1's
    prompt (slot 2) in a mid-prompt chunk of 16 and a finishing chunk of
    24, each with 2 decode steps, then 3 decode steps of both. ``split``:
    None runs the sequential program, "decode" / "prefill" the split
    halves in turn, that half first. ``resume_tok``: the finishing chunk
    resumes with that token instead of sampling. Returns (each request's
    tokens, the world's tensors)."""
    cfg = model.cfg
    pools = init_page_pools(cfg, PagePoolConfig(num_pages=PAGES,
                                                page_size=PS),
                            torch.float32, device="cpu")
    state = model.init_state_cache(SLOTS)
    last_tok = torch.zeros((SLOTS, 1), dtype=torch.int32)
    pos = torch.zeros((SLOTS,), dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    pa, pb = (np.asarray(jsynth(rid, vocab, p), np.int32)
              for rid, _, p, _ in SCRIPT)
    a_pages, b_pages = _row(range(1, 6)), _row(range(6, 12))

    def run(kb, chunk, finish, sample, active, rows, toks, start, slot,
            override, halves):
        tables = np.zeros((SLOTS, WIDTH), np.int32)
        for s, r in rows.items():
            tables[s] = r
        args = (pools, state, last_tok, pos, torch.from_numpy(tables), gen,
                torch.tensor(active),
                None if toks is None else torch.from_numpy(toks)[None],
                torch.from_numpy(b_pages if slot == 2 else a_pages)[None],
                start, slot, override)
        if halves and split:
            prog = make_superiter_fn(model, kb, chunk=chunk, finish=finish,
                                     sample=sample, split=True)
            assert isinstance(prog, SplitHalves)
            return run_halves(prog, args, first=split)
        return make_superiter_fn(model, kb, chunk=chunk, finish=finish,
                                 sample=sample)(*args)

    dec_a = [True, False, False]
    out = {0: [], 1: []}
    _, first = run(0, 24, True, True, [False] * 3, {}, pa, 0, 0, 0, False)
    out[0].append(int(first))
    toks, _ = run(2, 16, False, False, dec_a, {0: a_pages}, pb[:16], 0, 2, 0,
                  True)
    out[0] += toks[0].tolist()
    resume = resume_tok is not None
    toks, first = run(2, 24, True, not resume, dec_a, {0: a_pages}, pb[16:],
                      16, 2, resume_tok or 0, True)
    out[0] += toks[0].tolist()
    out[1].append(resume_tok if resume else int(first))
    toks, _ = run(3, 0, False, False, [True, False, True],
                  {0: a_pages, 2: b_pages}, None, 0, 0, 0, False)
    out[0] += toks[0].tolist()
    out[1] += toks[2].tolist()
    world = [last_tok, pos] + [t for layer in pools for t in layer]
    return out, world


@pytest.fixture(scope="module")
def oracle(setup):
    _, tcfg, _, forward = setup
    return greedy_oracle(forward, tcfg.vocab_size, SCRIPT)


@pytest.mark.parametrize("resume", [False, True])
@pytest.mark.parametrize("first", ["decode", "prefill"])
def test_split_halves_match_sequential_and_oracle(setup, oracle, first,
                                                  resume):
    """(b, c) The halves run in turn, in either order: the JAX greedy
    oracle's tokens, and tokens, pools and decode inputs bitwise the
    sequential program's."""
    _, tcfg, tmodel, _ = setup
    resume_tok = oracle[1][0] if resume else None
    want, want_world = _serve_script(tmodel, tcfg.vocab_size, None,
                                     resume_tok)
    got, got_world = _serve_script(tmodel, tcfg.vocab_size, first,
                                   resume_tok)
    assert want == got == oracle
    for g, w in zip(got_world, want_world):
        assert torch.equal(g, w)


# ----------------------------------------------------------------------- (d)
def _decisions(mux, loads):
    out = []
    for pre, dec in loads:
        t_mixed = mux.predict_mixed(pre + dec)
        for f in (0.5, 0.8, 0.97):
            mux.tbt_slo = f * t_mixed
            out.append((pre, dec, mux.step(pre, dec)))
    return out


def test_card_unit_step_prices_the_split_it_picks(setup):
    """(d) At the card's unit_step of 4 TPCs every duet decision has S_d
    a multiple of 4 and S_p the rest of the 66 TPCs, and its t_d / t_p
    are the roofline's at exactly that S_d / S_p; at a step of 1 some
    decision picks an S_d the driver cannot cut. An engine on the card's
    spec plans with that step."""
    _, tcfg, tmodel, _ = setup
    loads = [([RequestLoad(q=q, c=c, phase="prefill")],
              [RequestLoad(q=1, c=c) for _ in range(b)])
             for b in (1, 8, 32) for c in (128, 1000, 4000)
             for q in (64, 256, 1024)]
    picked = {}
    for step in (1, STEP):
        mux = AdaptiveMultiplexer(tcfg, hw=CARD4, total_units=UNITS,
                                  page_size=16, unit_step=step,
                                  bw_table=BW)
        parts = [(pre, dec, d.partition) for pre, dec, d in
                 _decisions(mux, loads) if d.mode == "duet"]
        assert parts
        picked[step] = {p.s_decode for _, _, p in parts}
        for pre, dec, p in parts:
            assert p.s_prefill + p.s_decode == UNITS
            assert p.t_decode == mux.model.iteration_latency(
                dec, units=p.s_decode)
            assert p.t_prefill == mux.model.iteration_latency(
                pre, units=p.s_prefill)
    assert all(s % STEP == 0 for s in picked[STEP])
    assert any(s % STEP for s in picked[1])
    eng = DuetEngine(tmodel, EngineConfig(**KW), hw=CARD4, device="cpu")
    assert eng.mux.unit_step == STEP and eng.mux.total_units == UNITS


def test_only_the_split_engine_prices_the_split(monkeypatch):
    """(d) ``device_pricing`` measures the green contexts' B(S) and steps
    Algorithm 1's S_d by the driver's granularity only when asked for the
    split (the async engine that runs it); every other engine gets the
    curve over spread CTAs at a step of one TPC, which makes no green
    context. ``partition_curves`` refuses the CPU for either curve."""
    from repro_torch.core.device import partition_curves
    from repro_torch.serving import engine as engine_mod
    asked = []

    def curves(device, spec, split=False):
        asked.append(split)
        return {u: BW[u] * (1.1 if split else 1.0) for u in BW}
    monkeypatch.setattr(engine_mod, "partition_curves", curves)
    monkeypatch.setattr(engine_mod, "card_unit_step", lambda dev: STEP)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: H100)
    cuda = torch.device("cuda")
    plain = engine_mod.device_pricing(cuda)
    split = engine_mod.device_pricing(cuda, split=True)
    assert asked == [False, True]
    assert (plain.unit_step, split.unit_step) == (1, STEP)
    assert plain.bw(UNITS) == BW[UNITS]
    assert split.bw(UNITS) == pytest.approx(1.1 * BW[UNITS])
    for kind in (False, True):
        with pytest.raises(ValueError, match="measures a CUDA card"):
            partition_curves("cpu", card_spec(H100), split=kind)


# ----------------------------------------------------------------------- (e)
def test_sm_split_true_raises_on_the_cpu_and_under_tp(setup, monkeypatch):
    """(e) No green context on the CPU, and TP keeps the fused duet
    launch: ``sm_split=True`` raises there; the default leaves it off.
    ``split_blocker`` names each engine that cannot split."""
    _, tcfg, tmodel, _ = setup
    with pytest.raises(ValueError, match="sm_split=True.*CUDA card"):
        AsyncDuetEngine(tmodel, EngineConfig(**KW), device="cpu",
                        sm_split=True)
    assert not AsyncDuetEngine(tmodel, EngineConfig(**KW),
                               device="cpu").sm_split
    ctx = DeviceContext(tcfg, torch.device("cpu"), tp=2, rank=0)
    model = Model(tcfg, shard_params(tmodel.param_tree(), tcfg, 2, 0),
                  ctx=ctx, attn_kernel=True)
    with pytest.raises(ValueError, match="sm_split=True.*collectives"):
        AsyncDuetEngine(model, EngineConfig(**KW), device="cpu",
                        sm_split=True)
    blocker = async_engine.split_blocker
    cuda = torch.device("cuda")
    plain = Model(tcfg, tmodel.param_tree(), attn_kernel=False)
    ec = EngineConfig(**KW)
    assert blocker(cuda, model, ec, CARD4) == "collectives"
    assert blocker(cuda, tmodel, EngineConfig(**dict(KW, paged=False)),
                   CARD4) == "slab"
    assert blocker(cuda, plain, ec, CARD4) == "kernel"
    assert blocker(cuda, tmodel, EngineConfig(**dict(KW, units=2)),
                   None) == "pricing"
    # a given hw must step as the driver cuts (asked of the card there)
    monkeypatch.setattr(async_engine, "card_unit_step", lambda dev: STEP)
    assert blocker(cuda, tmodel, ec, card_spec(H100)) == "pricing"
    assert blocker(cuda, tmodel, ec, CARD4) is None
    # hw None is priced for the split itself
    assert blocker(cuda, tmodel, ec, None) is None


class _HalvesInTurn:
    """Stands in for ``SmSplit`` on the CPU: records the S_d the engine
    asked for; the bucket's fork and join run the halves in turn."""

    made = []

    def __init__(self, device, s_d):
        self.s_d = s_d
        _HalvesInTurn.made.append(s_d)


def test_split_engine_serves_the_oracle_with_s_d_in_its_keys(
        setup, monkeypatch):
    """(e) The async engine planning as the card (unit_step 4) at a TBT
    bound between its predicted decode and mixed times, made to split
    with its halves in turn: the JAX greedy oracle's tokens, the sync
    engine's ServingMetrics, split dispatches counted by "S_p:S_d", and
    each split bucket's key holds its S_d (a multiple of 4) and none of a
    dispatch's start, slot or resume token."""
    _, tcfg, tmodel, forward = setup
    oracle = greedy_oracle(forward, tcfg.vocab_size, SPECS)
    monkeypatch.setattr(async_engine, "SmSplit", _HalvesInTurn)
    monkeypatch.setattr(lookahead, "fork_join",
                        lambda halves, split, args: run_halves(halves, args))
    seen = []
    feed = BucketProgram.feed

    def spy(self, active, tables=None, pre_toks=None, pre_tbl=None,
            scalars=(0, 0, 0)):
        seen.append((self, tuple(int(v) for v in scalars)))
        return feed(self, active, tables, pre_toks, pre_tbl, scalars)
    monkeypatch.setattr(BucketProgram, "feed", spy)
    mux = DuetEngine(tmodel, EngineConfig(**KW), hw=CARD4, device="cpu").mux
    dec = [RequestLoad(q=1, c=40) for _ in range(KW["max_slots"])]
    chunk = [RequestLoad(q=KW["token_budget"] - KW["max_slots"], c=0,
                         phase="prefill")]
    kw = dict(KW, tbt_slo=(mux.predict_mixed(dec)
                           + mux.predict_mixed(dec + chunk)) / 2)
    runs = {}
    for cls in (DuetEngine, AsyncDuetEngine):
        eng = cls(tmodel, EngineConfig(**kw), hw=CARD4, device="cpu")
        if cls is AsyncDuetEngine:
            eng.sm_split = True
        eng.submit([Request(rid=rid, arrival=a, prompt_len=p, output_len=o)
                    for rid, a, p, o in SPECS])
        metrics = eng.run()
        assert {r.rid: list(r.output_tokens)
                for r in metrics.requests} == oracle
        runs[cls] = metrics.summary()
    assert runs[DuetEngine] == runs[AsyncDuetEngine]
    st = eng.dstats
    assert sum(st.split_dispatches.values()) > 0
    for where in st.split_dispatches:
        s_p, s_d = map(int, where.split(":"))
        assert s_p + s_d == UNITS and s_d % STEP == 0
    split_keys = {k: p for k, p in eng._programs.items() if k[6]}
    assert split_keys and set(_HalvesInTurn.made) == {k[6] for k in
                                                        split_keys}
    for key, prog in split_keys.items():
        kb, width, chunk, pwidth, finish, sample, s_d, duet = key
        assert kb > 0 and chunk > 0 and not duet and s_d % STEP == 0
        assert all(isinstance(v, int) and not isinstance(v, bool)
                   for v in (kb, width, chunk, pwidth, s_d))
        assert all(isinstance(v, bool) for v in (finish, sample, duet))
        # the chunk's start, slot and resume token ride the bucket's
        # static buffers, fed at every dispatch
        assert any(p is prog for p, _ in seen)
    assert len(eng._programs) < len(seen)
    assert 0 < st.host_syncs <= st.super_iterations


def test_destroyed_split_streams_leave_no_cached_sizing(monkeypatch):
    """(e) A kernel on a split's stream sizes its clusters from an
    occupancy answer cached under the stream's raw handle; when the split
    is destroyed, its handles leave the registry and those caches are
    emptied, since a later stream of another context may take the same
    handle."""
    import sys
    from repro_torch.kernels import ops
    cleared = []
    for module, name in (("paged_decode", "occupancy"),
                         ("duet_attention", "occupancy"),
                         ("duet_attention", "paged_occupancy")):
        stub = types.SimpleNamespace(
            cache_clear=lambda m=module, n=name: cleared.append((m, n)))
        monkeypatch.setattr(sys.modules[f"repro_torch.kernels.{module}"],
                            name, stub)
    monkeypatch.setattr(ops, "SPLIT_STREAMS", {11: 64, 12: 68, 13: 16})
    ops.forget_split_streams([11, 12])
    assert ops.SPLIT_STREAMS == {13: 16}
    assert sorted(cleared) == [("duet_attention", "occupancy"),
                               ("duet_attention", "paged_occupancy"),
                               ("paged_decode", "occupancy")]
