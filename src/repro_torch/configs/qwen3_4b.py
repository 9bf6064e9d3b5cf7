"""qwen3-4b [dense] — 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936.

qk_norm + GQA, llama-style SwiGLU MLP. [hf:Qwen/Qwen3-8B]
This family (Qwen3) is the paper's own evaluation model class; the duet
scheduler's roofline operator census for Fig. 6/7 is built from this config.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-4b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,          # Qwen3 uses head_dim 128 (not d_model/heads = 80)
    d_ff=9728,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
))
