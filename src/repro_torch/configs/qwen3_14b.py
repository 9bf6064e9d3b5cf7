"""qwen3-14b — the paper's multi-GPU evaluation model (§5.3, TP=2).

40L d_model=5120 40H (GQA kv=8, head_dim 128) d_ff=17408 vocab=151936,
qk_norm. [hf:Qwen/Qwen3-14B]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-14b",
    family="dense",
    source="hf:Qwen/Qwen3-14B (paper §5.3)",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
))
