"""Port parity for the configs beyond the qwen3 family: yi-9b (GQA
rep 8), minicpm-2b (MHA at head dim 64, tied embeddings, a padded vocab),
granite-20b (MQA, a non-gated gelu MLP), granite-moe-3b-a800m (GQA with
an MoE FFN in every layer) and deepseek-v2-lite-16b (MLA, a dense first
layer, then MoE with a shared expert), reduced as the reference reduces
them (granite keeps one KV head), and two narrow variants at the
published head counts of granite-20b (48 / 1) and qwen3-14b (40 / 8), two
layers at head dim 16 with vocab 512, whose async engines fuse duet tiles
of one and twelve rows (``ops.duet_block_q``).

For each: the JAX parameter tree carried over by ``params_from_jax``
leaf for leaf, and the greedy token streams of both port engines on
paged and on slab KV against a greedy oracle from the JAX
``Model.forward`` on the same weights (fp32, exact tokens). The JAX
engines are not the oracle: with jax 0.9 on a CPU backend they raise a
ShardingTypeError, while the model-level functions run.

MoE routing is not row-local (capacity and rank depend on every row a
call routes), and ``Model.forward`` routes whole padded sequences where
the engines route one step's rows, so the engine tests raise the capacity
factor to 64, where nothing is dropped, as the reference's own
consistency test does. At the default 1.25, where choices are dropped,
the step-level tests hold the port's ``prefill_paged``,
``decode_step_paged`` and (granite-moe) ``duet_step_paged`` to the JAX
``Model``'s on the same rows, pools and tables (fp32, 1e-4, equal
argmax)."""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.kernels import build_duet_schedule as jbuild_duet_schedule
from repro.models import Model as JModel
from repro.models import layers as jlayers
from repro.serving.kvcache import PagePoolConfig as JPagePoolConfig
from repro.serving.kvcache import init_page_pools as jinit_page_pools
from repro.serving.request import synth_prompt_tokens as jsynth
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import GQA_KINDS
from repro_torch.kernels import build_duet_schedule
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ops import duet_block_q
from repro_torch.models import Model, layers, moe, params_from_jax
from repro_torch.models.params import layout
from repro_torch.serving.kvcache import PagePoolConfig, init_page_pools
from repro_torch.serving import (AsyncDuetEngine, DuetEngine, EngineConfig,
                                 Request)

KW = dict(max_slots=3, max_len=128, token_budget=48, page_size=8)
# arrivals 0.3 ms apart on the virtual clock: later prompts prefill while
# earlier requests decode, so the async engine fuses duet steps
SPECS = [(i, i * 0.0003, 20 + 7 * i, 6 + i) for i in range(5)]
# name -> (base config, heads override: (H, G, head_dim) or None)
CASES = {
    "yi-9b": ("yi-9b", None),
    "minicpm-2b": ("minicpm-2b", None),
    "granite-20b": ("granite-20b", None),
    "granite-20b-heads": ("granite-20b", (48, 1, 16)),
    "qwen3-14b-heads": ("qwen3-14b", (40, 8, 16)),
    "granite-moe-3b-a800m": ("granite-moe-3b-a800m", None),
    "deepseek-v2-lite-16b": ("deepseek-v2-lite-16b", None),
}
MOE_NAMES = ("granite-moe-3b-a800m", "deepseek-v2-lite-16b")
# the engine tests' capacity factor for the MoE configs: nothing dropped,
# so the whole-sequence oracle routes as the engines' steps do
ORACLE_CAPACITY = 64.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the reduced model's ops are tiny, and with the
    suite's parallel workers sharing the cores, torch's default thread
    team per op slows these tests by an order of magnitude or more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name):
    base, heads = CASES[name]
    jcfg, tcfg = jreduced(jget_config(base)), reduced(get_config(base))
    if jcfg.is_moe:
        jcfg = dataclasses.replace(jcfg, capacity_factor=ORACLE_CAPACITY)
        tcfg = dataclasses.replace(tcfg, capacity_factor=ORACLE_CAPACITY)
    if heads is not None:
        H, G, dh = heads
        jcfg = dataclasses.replace(jcfg, num_heads=H, num_kv_heads=G,
                                   head_dim=dh)
        tcfg = dataclasses.replace(tcfg, num_heads=H, num_kv_heads=G,
                                   head_dim=dh)
    return jcfg, tcfg


def greedy_oracle(forward, vocab, specs):
    """Greedy continuations from the JAX full-sequence forward: every
    sequence is right-padded to one length (causal attention makes the
    padding invisible to earlier positions), so the forward compiles once
    and each step extends every unfinished request by its argmax."""
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


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """(name, jcfg, tcfg, the JAX tree as numpy, the port's model with the
    kernel hook on, the greedy oracle's tokens) of one config."""
    jcfg, tcfg = _cfgs(request.param)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    tmodel = Model(tcfg, params_from_jax(tcfg, tree), attn_kernel=True)
    forward = jax.jit(lambda toks: jmodel.forward(jparams, toks))
    oracle = greedy_oracle(forward, tcfg.vocab_size, SPECS)
    return request.param, jcfg, tcfg, tree, tmodel, oracle


def test_params_from_jax_round_trip(case):
    """Every leaf of the reference's tree lands in the port's layout
    unchanged: the non-gated MLP (granite, no w_gate), tied embeddings
    (minicpm, no w_out), one KV head (granite), the experts stacked on a
    leading axis and the shared expert (deepseek), MLA's latent
    projections and flat output projection (deepseek)."""
    name, jcfg, tcfg, tree, tmodel, _ = case
    assert set(layout(tcfg)) == set(tree)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    for path, leaf in flat:
        node = tmodel.params
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        np.testing.assert_array_equal(node.numpy(), leaf)
    assert ("w_out" in tmodel.params) == (not jcfg.tie_embeddings)
    D, H = tcfg.d_model, tcfg.num_heads
    for p, kind in zip(tmodel.params["layers"], tcfg.block_pattern):
        if "mlp" in p:
            assert ("w_gate" in p["mlp"]) == jcfg.mlp_gated
        else:
            E, F = tcfg.num_experts, tcfg.moe_d_ff
            assert kind.endswith("_moe")
            assert tuple(p["moe"]["w_gate"].shape) == (E, D, F)
            assert tuple(p["moe"]["w_down"].shape) == (E, F, D)
            assert ("shared" in p["moe"]) == (tcfg.num_shared_experts > 0)
        if kind.startswith("mla"):
            assert tuple(p["attn"]["w_o"].shape) == (H * tcfg.v_head_dim, D)
            assert tuple(p["attn"]["w_dkv"].shape) == (D, tcfg.kv_lora_rank)
        else:
            assert p["attn"]["w_k"].shape[1] == jcfg.num_kv_heads
    assert sum(b.numel() for b in tmodel.buffers()) == \
        tcfg.param_count()


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slab"])
@pytest.mark.parametrize("cls", [DuetEngine, AsyncDuetEngine],
                         ids=["sync", "async"])
def test_engines_match_jax_greedy_oracle(case, cls, paged, monkeypatch):
    """Both engines on both KV layouts give the oracle's greedy tokens;
    the async paged engine fuses duet steps in tiles of
    ops.duet_block_q rows (1 at rep 48, 12 at rep 5; none for MLA, as the
    reference's probe keeps the duet kernel to GQA blocks) and keeps at
    most one host sync per super-iteration."""
    name, jcfg, tcfg, tree, tmodel, oracle = case
    seen = []
    plain = kernel_ops.duet_attention_paged

    def spy(*args, block_q):
        seen.append(block_q)
        return plain(*args, block_q=block_q)
    monkeypatch.setattr(kernel_ops, "duet_attention_paged", spy)
    eng = cls(tmodel, EngineConfig(paged=paged, **KW), device="cpu")
    eng.submit([Request(rid=r, arrival=a, prompt_len=p, output_len=o)
                for r, a, p, o in SPECS])
    metrics = eng.run()
    assert metrics.summary()["num_finished"] == len(SPECS)
    assert {r.rid: list(r.output_tokens) for r in metrics.requests} == oracle
    assert eng.kv_mgr.used_pages == 0
    if cls is AsyncDuetEngine:
        assert 0 < eng.dstats.host_syncs <= eng.dstats.super_iterations
        if paged and all(k in GQA_KINDS for k in tcfg.block_pattern):
            bq = duet_block_q(tcfg.num_heads, tcfg.num_kv_heads,
                              tcfg.head_dim)
            assert seen and set(seen) == {bq}
        else:
            assert not seen
    if name == "granite-20b-heads":
        assert duet_block_q(48, 1, 16) == 1
    if name == "qwen3-14b-heads":
        assert duet_block_q(40, 8, 16) == 12


@pytest.mark.parametrize("name", ["yi-9b", "minicpm-2b", "granite-20b",
                                  "granite-moe-3b-a800m",
                                  "deepseek-v2-lite-16b"])
def test_published_shapes(name):
    """The full-width shapes the card serves, from the port's registry:
    head dims, reps, the padded vocab and the parameter count."""
    cfg, ref = get_config(name), jget_config(name)
    want = {"yi-9b": (128, 8, 64_000, 8.83e9),
            "minicpm-2b": (64, 1, 122_880, 2.72e9),
            "granite-20b": (128, 48, 49_152, 20.3e9),
            "granite-moe-3b-a800m": (64, 3, 49_408, 3.30e9),
            "deepseek-v2-lite-16b": (192, 1, 102_400, 15.7e9)}[name]
    assert (cfg.head_dim, cfg.num_heads // cfg.num_kv_heads,
            cfg.padded_vocab) == want[:3]
    assert cfg.padded_vocab == ref.padded_vocab
    assert abs(cfg.param_count() - want[3]) < 0.01 * want[3]


def test_unembed_masks_minicpm_padded_vocab():
    """Tied unembedding over minicpm-2b's vocab (122753, padded to 122880):
    the 127 pad columns hold the dtype's minimum, as in the reference."""
    rng = np.random.default_rng(0)
    cfg = get_config("minicpm-2b")
    emb = rng.standard_normal((cfg.padded_vocab, 8), np.float32)
    h = rng.standard_normal((2, 8), np.float32)
    got = layers.unembed({"embedding": torch.from_numpy(emb)},
                         torch.from_numpy(h), cfg.vocab_size).numpy()
    want = np.asarray(jlayers.unembed({"embedding": jnp.asarray(emb)},
                                      jnp.asarray(h), cfg.vocab_size))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert (got[:, cfg.vocab_size:] == np.finfo(np.float32).min).all()


def test_published_moe_and_mla_shapes():
    """The MoE and MLA shapes of the two MoE configs at full width:
    granite-moe's 32 attn_moe layers of 40 experts (top-8, width 512) and
    its 24 / 8 heads at Dh 64 (the duet tiles of 21 rows); deepseek's dense
    first layer (width 10944), 26 mla_moe layers of 64 routed + 2 shared
    experts (top-6, width 1408) and its latent cache of 1152 bytes a token
    a layer in bf16; and the parameters each token activates."""
    g, d = get_config("granite-moe-3b-a800m"), get_config("deepseek-v2-lite-16b")
    assert g.block_pattern == ("attn_moe",) * 32
    assert (g.num_experts, g.moe_top_k, g.moe_d_ff, g.num_shared_experts) \
        == (40, 8, 512, 0)
    assert duet_block_q(g.num_heads, g.num_kv_heads, g.head_dim) == 21
    assert d.block_pattern == ("mla",) + ("mla_moe",) * 26
    assert (d.num_experts, d.moe_top_k, d.moe_d_ff, d.num_shared_experts) \
        == (64, 6, 1408, 2)
    lay = layout(d)
    assert lay["layers"][0]["mlp"]["w_up"].shape == (2048, 10944)
    moe_l = lay["layers"][1]["moe"]
    assert moe_l["w_gate"].shape == (64, 2048, 1408)
    assert moe_l["shared"]["w_up"].shape == (2048, 2 * 1408)
    assert (d.kv_lora_rank + d.qk_rope_dim) * 2 == 1152
    for cfg, active in ((g, 0.88e9), (d, 2.66e9)):
        assert abs(cfg.active_param_count() - active) < 0.01 * active
        assert cfg.active_param_count() == \
            jget_config(cfg.name).active_param_count()


# ---------------------------------------------------------------------------
# step level, default capacity: the port's paged steps against the JAX
# Model's on the same rows
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=MOE_NAMES)
def step_models(request):
    """(jcfg, the JAX Model with its steps jitted, its params, tcfg, the
    port's Model) of one MoE config, reduced, at the default capacity."""
    jcfg = jreduced(jget_config(request.param))
    tcfg = reduced(get_config(request.param))
    assert tcfg.capacity_factor == jcfg.capacity_factor == 1.25
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    tmodel = Model(tcfg, params_from_jax(tcfg, jax.tree.map(np.asarray,
                                                             jparams)),
                   attn_kernel=True)
    jm = copy.copy(jmodel)
    jm.prefill_paged = jax.jit(
        lambda p, toks, pools, tbl, start_pos: JModel.prefill_paged(
            jmodel, p, toks, pools, [None] * jcfg.num_layers, tbl,
            start_pos=start_pos)[:2])
    jm.decode_step_paged = jax.jit(
        lambda p, pools, tok, pos, tbl: JModel.decode_step_paged(
            jmodel, p, pools, [None] * jcfg.num_layers, tok, pos, tbl)[:2])
    return jcfg, jm, jparams, tcfg, tmodel


def _check_step(got, want, tol=1e-4):
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _check_pools(tpools, jpools):
    for tp, jp in zip(tpools, jpools):
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                       rtol=1e-4)


def test_moe_steps_match_jax_at_default_capacity(step_models, monkeypatch):
    """Request A (14 tokens, one chunk) and request B (9 tokens, chunks of
    5 and 4) prefill into the pools; then a decode step of three slots —
    A, B and an inactive slot (all-zero table row, position 0) that the
    MoE routes with the others; then, on granite-moe, a fused duet step of
    those three decode rows and an 8-row chunk of request C, at one row a
    tile and at the engine's tiles, against the JAX duet step at one row a
    tile (the Pallas kernel in interpret mode); deepseek's duet step is
    refused (MLA blocks), as the reference's. Logits within 1e-4 with
    equal argmax at every step, pools within 1e-4, and the capacity binds
    somewhere along the way."""
    jcfg, jm, jparams, tcfg, tmodel = step_models
    dropped = []
    plain = moe.route_indices

    def spy(*a):
        g, s, keep = plain(*a)
        dropped.append(int((~keep).sum()))
        return g, s, keep
    monkeypatch.setattr(moe, "route_indices", spy)
    rng = np.random.default_rng(17)
    ps, N, P = 4, 32, 6
    jpools = jinit_page_pools(jcfg, JPagePoolConfig(num_pages=N,
                                                    page_size=ps))
    tpools = init_page_pools(tcfg, PagePoolConfig(num_pages=N, page_size=ps))
    tblA = np.asarray([[1, 2, 3, 4, 0, 0]], np.int32)
    tblB = np.asarray([[5, 6, 7, 0, 0, 0]], np.int32)
    toks = {r: rng.integers(0, tcfg.vocab_size, (1, n)).astype(np.int32)
            for r, n in (("A", 15), ("B", 10), ("C", 8))}
    for rid, tbl, chunks in (("A", tblA, [(0, 14)]),
                             ("B", tblB, [(0, 5), (5, 9)])):
        for s0, s1 in chunks:
            t = toks[rid][:, s0:s1]
            jl, jpools = jm.prefill_paged(jparams, jnp.asarray(t), jpools,
                                          jnp.asarray(tbl), jnp.int32(s0))
            tl, tpools, _ = tmodel.prefill_paged(
                torch.from_numpy(t), tpools, tmodel.init_state_cache(1),
                torch.from_numpy(tbl), start_pos=s0)
            _check_step(tl, jl)
    _check_pools(tpools, jpools)
    tok = np.asarray([[toks["A"][0, 14]], [toks["B"][0, 9]], [0]], np.int32)
    pos = np.asarray([14, 9, 0], np.int32)
    tbl = np.concatenate([tblA, tblB, np.zeros((1, P), np.int32)])
    pre = [(np.copy(np.asarray(a)), np.copy(np.asarray(b)))
           for a, b in jpools]
    jl, jpools = jm.decode_step_paged(jparams, jpools, jnp.asarray(tok),
                                      jnp.asarray(pos), jnp.asarray(tbl))
    tl, tpools, _ = tmodel.decode_step_paged(
        tpools, tmodel.init_state_cache(3), torch.from_numpy(tok),
        torch.from_numpy(pos), torch.from_numpy(tbl))
    _check_step(tl, jl)
    _check_pools(tpools, jpools)
    if not all(k in GQA_KINDS for k in tcfg.block_pattern):
        # the duet step takes GQA blocks only, as the reference's
        with pytest.raises(ValueError, match="GQA attention blocks"):
            tmodel.duet_step_paged(tpools, None, torch.from_numpy(tok),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(tbl),
                                   torch.arange(3, dtype=torch.int32))
    else:
        # the duet step from the pools before the decode step
        C = 8
        tblC = np.asarray([[9, 10, 0, 0, 0, 0]], np.int32)
        row_tok = np.concatenate([tok[:, 0], toks["C"][0]])[:, None]
        row_pos = np.concatenate([pos, np.arange(C)]).astype(np.int32)
        row_tbl = np.concatenate([tbl, np.repeat(tblC, C, axis=0)])
        decode_rows = [(s, int(p)) for s, p in enumerate(pos)]
        chunk_rows = [(3, i) for i in range(C)]
        jsched = jbuild_duet_schedule(decode_rows, chunk_rows, block_q=1)
        jl, jp2, _ = JModel.duet_step_paged(
            jm, jparams, [tuple(map(jnp.asarray, p)) for p in pre],
            [None] * jcfg.num_layers, jnp.asarray(row_tok),
            jnp.asarray(row_pos), jnp.asarray(row_tbl),
            jnp.asarray(jsched.row_src))
        bq_engine = duet_block_q(tcfg.num_heads, tcfg.num_kv_heads,
                                 tcfg.head_dim)
        for bq in (1, bq_engine):
            sched = build_duet_schedule(decode_rows, chunk_rows, block_q=bq)
            tl, tp2, _ = tmodel.duet_step_paged(
                [tuple(torch.from_numpy(np.copy(a)) for a in p)
                 for p in pre], tmodel.init_state_cache(3 + C),
                torch.from_numpy(row_tok), torch.from_numpy(row_pos),
                torch.from_numpy(row_tbl), torch.from_numpy(sched.row_src),
                block_q=bq)
            _check_step(tl, jl)
            _check_pools(tp2, jp2)
    assert sum(dropped) > 0, "the capacity never bound"
