"""zamba2-1.2b [hybrid] — 38L d_model=2048 32H (kv=32) d_ff=8192 ssm_state=64
vocab=32000. Mamba2 backbone + one weight-SHARED attention+MLP block invoked
periodically [arXiv:2411.15242].

Every ``shared_attn_period``-th layer (6 of the 38) is the single shared
transformer block (the same weights at every occurrence — Zamba2's weight
sharing); the other 32 are Mamba2 (SSD) blocks of 64 heads of 64 channels
(expand 2) over a state of 64. The shared block is a GQA kind at rep 1,
head dim 64, so its decode attention runs the ported kernels. As in the
reference, the shared block acts directly on the residual stream (no
embedding concatenation, no per-occurrence LoRA deltas).
"""
from repro_torch.configs.base import ArchConfig, register


def _pattern(num_layers: int, period: int):
    return tuple("shared_attn" if i % period == period - 1 else "mamba2"
                 for i in range(num_layers))


CONFIG = register(ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    source="arXiv:2411.15242",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32_000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    shared_attn_period=6,
    block_pattern=_pattern(38, 6),
))
