"""minicpm-2b [dense] — 40L d_model=2304 36H (kv=36) d_ff=5760 vocab=122753.

Llama-like architecture trained with the WSD (warmup-stable-decay) schedule
[arXiv:2404.06395]. The WSD schedule is implemented in
``repro_torch.training.optimizer`` and selected via ``lr_schedule="wsd"``.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="minicpm-2b",
    family="dense",
    source="arXiv:2404.06395",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122_753,
    lr_schedule="wsd",
    tie_embeddings=True,
))
