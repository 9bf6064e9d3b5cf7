"""musicgen-medium [audio] — 48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048.

Decoder-only transformer over EnCodec residual-codebook tokens
[arXiv:2306.05284]. The EnCodec conv codec frontend is a STUB per the
assignment carve-out, as in the reference: the caller provides the (B, K, S)
codebook token grid. The decoder embeds the K=4 codebooks (summed
embeddings, delay pattern applied upstream) and predicts K parallel heads of
2048 codes each.

Simplifications vs the full MusicGen system (noted per DESIGN.md): T5 text
cross-attention conditioning is omitted — the assignment specifies the
transformer backbone only; GELU activations per the original fairseq decoder.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="musicgen-medium",
    family="audio",
    source="arXiv:2306.05284",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    activation="gelu",
    mlp_gated=False,
    frontend="audio",
    num_codebooks=4,
))
