"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512
(per-expert) vocab=49155, MoE 40 experts top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base]. Every layer is ``attn_moe``:
GQA at rep 3 and head dim 64 on the attention kernels, then 40 routed
experts of width 512, eight chosen per token, no shared expert; tied
embeddings. The reference's spec note (DESIGN.md §4) follows the primary
spec line's 40 experts.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,               # per-expert hidden dim (no dense layers)
    vocab_size=49_155,
    num_experts=40,
    num_shared_experts=0,
    moe_top_k=8,
    moe_d_ff=512,
    tie_embeddings=True,
))
