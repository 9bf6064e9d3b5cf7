"""Port parity for the dense configs beyond the qwen3 family: yi-9b (GQA
rep 8), minicpm-2b (MHA at head dim 64, tied embeddings, a padded vocab)
and granite-20b (MQA, a non-gated gelu MLP), reduced as the reference
reduces them (granite keeps one KV head), and two narrow variants at the
published head counts of granite-20b (48 / 1) and qwen3-14b (40 / 8), two
layers at head dim 16 with vocab 512, whose async engines fuse duet tiles
of one and twelve rows (``ops.duet_block_q``).

For each: the JAX parameter tree carried over by ``params_from_jax``
leaf for leaf, and the greedy token streams of both port engines on
paged and on slab KV against a greedy oracle from the JAX
``Model.forward`` on the same weights (fp32, exact tokens). The JAX
engines are not the oracle: with jax 0.9 on a CPU backend they raise a
ShardingTypeError, while the model-level functions run."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import Model as JModel
from repro.models import layers as jlayers
from repro.serving.request import synth_prompt_tokens as jsynth
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ops import duet_block_q
from repro_torch.models import Model, layers, params_from_jax
from repro_torch.models.params import layout
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
}


def _cfgs(name):
    base, heads = CASES[name]
    jcfg, tcfg = jreduced(jget_config(base)), reduced(get_config(base))
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
    (minicpm, no w_out), one KV head (granite)."""
    name, jcfg, tcfg, tree, tmodel, _ = case
    assert set(layout(tcfg)) == set(tree)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    for path, leaf in flat:
        node = tmodel.params
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        np.testing.assert_array_equal(node.numpy(), leaf)
    mlp = tmodel.params["layers"][0]["mlp"]
    assert ("w_gate" in mlp) == jcfg.mlp_gated
    assert ("w_out" in tmodel.params) == (not jcfg.tie_embeddings)
    assert tmodel.params["layers"][0]["attn"]["w_k"].shape[1] == \
        jcfg.num_kv_heads
    assert sum(b.numel() for b in tmodel.buffers()) == \
        tcfg.param_count()


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slab"])
@pytest.mark.parametrize("cls", [DuetEngine, AsyncDuetEngine],
                         ids=["sync", "async"])
def test_engines_match_jax_greedy_oracle(case, cls, paged, monkeypatch):
    """Both engines on both KV layouts give the oracle's greedy tokens;
    the async paged engine fuses duet steps in tiles of
    ops.duet_block_q rows (1 at rep 48, 12 at rep 5) and keeps at most one
    host sync per super-iteration."""
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
        if paged:
            bq = duet_block_q(tcfg.num_heads, tcfg.num_kv_heads,
                              tcfg.head_dim)
            assert seen and set(seen) == {bq}
    if name == "granite-20b-heads":
        assert duet_block_q(48, 1, 16) == 1
    if name == "qwen3-14b-heads":
        assert duet_block_q(40, 8, 16) == 12


@pytest.mark.parametrize("name", ["yi-9b", "minicpm-2b", "granite-20b"])
def test_published_shapes(name):
    """The full-width shapes the card serves, from the port's registry:
    head dims, reps, the padded vocab and the bf16 weight bytes."""
    cfg, ref = get_config(name), jget_config(name)
    want = {"yi-9b": (128, 8, 64_000, 8.83e9),
            "minicpm-2b": (64, 1, 122_880, 2.72e9),
            "granite-20b": (128, 48, 49_152, 20.3e9)}[name]
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
