"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff=1408(per-expert)
vocab=102400, MLA kv_lora=512, 2 shared + 64 routed experts top-6.

[arXiv:2405.04434]. 64 routed + 2 shared experts, top-6, as the real
V2-Lite (the reference's spec note, DESIGN.md §4). Layer 0 keeps a dense
FFN (d_ff=10944) per the V2-Lite model card.

MLA: queries are full-rank (no q-LoRA in V2-Lite); keys/values are compressed
into a 512-dim latent plus a shared 64-dim decoupled RoPE key. The KV cache
stores only (c_kv, k_rope) — the technique's memory win — and the decode path
can expand the latents (the paper-faithful baseline) or absorb the
up-projections into the query and output (``Model(mla_absorb=True)``).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    source="arXiv:2405.04434",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,          # MLA: per-head latent expansion, h_kv == h_q
    head_dim=192,             # qk_nope(128) + qk_rope(64)
    d_ff=10944,               # dense-FFN width (layer 0)
    vocab_size=102_400,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    num_experts=64,
    num_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
))
