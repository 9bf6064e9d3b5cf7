"""granite-20b [dense] — 52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.

Llama-architecture code model with multi-query attention [arXiv:2405.04324].
Largest assigned config — the tensor-parallel stress test (48 q heads / 16
chips, MQA kv head replicated across the model axis).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-20b",
    family="dense",
    source="arXiv:2405.04324",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49_152,
    activation="gelu",
    mlp_gated=False,
))
