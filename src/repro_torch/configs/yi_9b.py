"""yi-9b [dense] — 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.

Llama-architecture GQA. [arXiv:2403.04652]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="yi-9b",
    family="dense",
    source="arXiv:2403.04652",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64_000,
    rope_theta=10_000.0,
))
