"""Assigned input shapes and their shape-only input tensors, for the dry
run (``repro_torch.launch.dryrun``).

Four shapes from the assignment:

  train_4k       seq_len=  4,096  global_batch= 256  (training)      -> train_step
  prefill_32k    seq_len= 32,768  global_batch=  32  (prefill)       -> prefill
  decode_32k     seq_len= 32,768  global_batch= 128  (decode)        -> decode_step
  long_500k      seq_len=524,288  global_batch=   1  (long decode)   -> decode_step

Decode shapes run ``decode_step``: ONE new token against a KV cache of
``seq_len``. ``long_500k`` uses the sub-quadratic variant: the
sliding-window ring-buffer cache for attention archs, the O(1) recurrent
state for SSM/hybrid ones.

A copy of the reference's ``repro.configs.shapes``. Its
``jax.ShapeDtypeStruct`` is a tensor on the ``meta`` device here: a shape
and a dtype, no storage.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"
    sliding: bool = False  # use the sub-quadratic sliding-window/state variant


SHAPES: dict[str, InputShape] = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode", sliding=True),
}


def get_shape(name: str) -> InputShape:
    return SHAPES[name]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


# ----------------------------------------------------------------------------
def input_specs(cfg: ArchConfig, shape: InputShape,
                kv_dtype=None) -> dict:
    """Meta tensors for every model input of this entry point, at the
    global batch (no allocation).

    Modality frontends are stubbed per the assignment carve-out: for VLM the
    vision patch embeddings arrive precomputed, for audio the codebook token
    grid stands in for EnCodec output. The decode cache is
    ``models.transformer.cache_specs``' (``kv_dtype``, default bf16).
    """
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    bf16 = torch.bfloat16

    specs: dict = {}
    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "vision":
            p = cfg.num_prefix_tokens
            specs["patch_embeds"] = _meta((B, p, cfg.d_model), bf16)
            text = (B, S - p)
        elif cfg.frontend == "audio":
            text = (B, cfg.num_codebooks, S)
        else:
            text = (B, S)
        specs["tokens"] = _meta(text, i32)
        if shape.kind == "train":
            specs["labels"] = _meta(text, i32)
    elif shape.kind == "decode":
        if cfg.frontend == "audio":
            specs["token"] = _meta((B, cfg.num_codebooks, 1), i32)
        else:
            specs["token"] = _meta((B, 1), i32)
        specs["pos"] = _meta((B,), i32)
        from repro_torch.models.transformer import cache_specs
        specs["cache"] = cache_specs(
            cfg, batch=B, max_len=S, dtype=kv_dtype or bf16,
            sliding=shape.sliding)
    else:
        raise ValueError(shape.kind)
    return specs
