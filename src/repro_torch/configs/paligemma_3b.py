"""paligemma-3b [vlm] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=257216.

SigLIP vision encoder + Gemma decoder [arXiv:2407.07726]. The SigLIP ViT and
projector are a STUB, as in the reference: the caller provides precomputed
patch embeddings (B, 256, d_model). The Gemma-2B language decoder
that consumes them is fully implemented: MQA (kv=1), GeGLU FFN, RMSNorm,
and the PaliGemma prefix-LM mask (bidirectional attention over the image
prefix + prompt, causal over the suffix).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="paligemma-3b",
    family="vlm",
    source="arXiv:2407.07726",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257_216,
    activation="gelu",
    frontend="vision",
    num_prefix_tokens=256,   # 224px / 14px patches -> 256 SigLIP tokens
    prefix_lm=True,
    tie_embeddings=True,
))
