"""qwen3-8b — the paper's own primary evaluation model (§5.1, TP=1).

36L d_model=4096 32H (GQA kv=8, head_dim 128) d_ff=12288 vocab=151936,
qk_norm. Used by the GPU-regime validation benchmark
(benchmarks/gpu_regime.py) that reproduces the paper's own claims before the
TPU adaptation is evaluated. [hf:Qwen/Qwen3-8B]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-8b",
    family="dense",
    source="hf:Qwen/Qwen3-8B (paper §5.1)",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
))
