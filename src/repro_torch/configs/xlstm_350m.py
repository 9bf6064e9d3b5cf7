"""xlstm-350m [ssm] — 24L d_model=1024 4H d_ff=0 vocab=50304.

sLSTM + mLSTM blocks [arXiv:2405.04517]. d_ff=0: xLSTM blocks carry their
own projections (mLSTM: pre-up-projection 2x with a causal conv and the
matrix-memory cell; sLSTM: the scalar-memory cell and a gated 4/3 FFN)
instead of a separate transformer MLP. Every 4th block is sLSTM, the rest
mLSTM (xLSTM[3:1]). No attention: the serving paths launch no kernel.
"""
from repro_torch.configs.base import ArchConfig, register


def _pattern(num_layers: int):
    return tuple("slstm" if i % 4 == 3 else "mlstm" for i in range(num_layers))


CONFIG = register(ArchConfig(
    name="xlstm-350m",
    family="ssm",
    source="arXiv:2405.04517",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    block_pattern=_pattern(24),
))
