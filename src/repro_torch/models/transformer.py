"""The served model: an ``nn.Module`` that holds its weights and runs the
paged serving steps of the reference's ``repro.models.transformer.Model``.

  * ``prefill_paged``     — chunked prefill against the paged KV pool
  * ``decode_step_paged`` — one token per slot (continuous batching)
  * ``duet_step_paged``   — decode rows + one prefill chunk in one fused
                            attention launch per layer

Only all-GQA dense block patterns (the qwen3 family) are ported; the slab
cache, MLA, MoE, recurrent blocks and frontends are not yet. Weights keep
the reference's layouts and names (``params_from_jax`` carries a JAX tree
over unchanged), and the weight methods take no ``params`` argument: the
module owns them. Page pools are updated in place.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import GQA_KINDS, ArchConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import embed, gated_mlp, rms_norm, unembed
from repro_torch.models.params import init_params, layout

ATTN_KINDS = GQA_KINDS


class ParamTree(nn.Module):
    """One node of the weight tree. Tensors are registered as buffers
    (inference only, no autograd) and sub-trees as modules, and the node
    indexes like the reference's dicts: ``p["w_q"]``, ``"q_norm" in p``."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, torch.Tensor):
                self.register_buffer(key, val)
            elif isinstance(val, list):
                self.add_module(key, nn.ModuleList(
                    [ParamTree(v) for v in val]))
            else:
                self.add_module(key, ParamTree(val))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._buffers or key in self._modules


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, params: dict, *,
                 attn_kernel: bool = False, split_kv_threshold: int = 0):
        super().__init__()
        layout(cfg)              # raises for block kinds not yet ported
        self.cfg = cfg
        self.params = ParamTree(params)
        # route decode attention through the kernel dispatcher (the CUDA
        # kernels on the card, their plain versions on the CPU); the plain
        # attention math is the default oracle
        self.attn_kernel = attn_kernel
        # a positive threshold (tokens of table capacity) selects the
        # split-KV flash-decoding kernel above it
        self.split_kv_threshold = split_kv_threshold

    @classmethod
    def init(cls, cfg: ArchConfig, *, seed: int = 0,
             dtype=torch.float32, device: DeviceLike = None,
             **kw) -> "Model":
        """Random weights from ``torch.Generator(device).manual_seed(seed)``
        on ``device`` (default: the card; raises without CUDA)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, init_params(cfg, gen, dtype, dev), **kw)

    @property
    def device(self) -> torch.device:
        return self.params["embedding"].device

    @property
    def dtype(self) -> torch.dtype:
        return self.params["embedding"].dtype

    # ----------------------------------------------------------------- embed
    def _embed(self, tokens):
        return embed(self.params, tokens)

    def _logits(self, x):
        # tied embeddings have no w_out in the layout, so unembed reads
        # the embedding table
        return unembed(self.params, x, self.cfg.vocab_size)

    # ---------------------------------------------------------------- blocks
    def _mlp_block(self, p, x):
        """Post-attention MLP residual shared by every paged path."""
        h = rms_norm(x, p["mlp_norm"], self.cfg.norm_eps)
        return x + gated_mlp(p["mlp"], h, self.cfg.activation)

    # ------------------------------------------------------------ paged serve
    def prefill_paged(self, tokens, pools, state, tables, *,
                      start_pos: Optional[int] = None):
        """Chunked prefill with paged attention KV (PagedAttention layout).

        ``tokens`` (B, S); ``pools``: per-layer (k_pages, v_pages);
        ``state``: per-slot cache for recurrent layers (all None here);
        ``tables`` (B, P) int32 block tables covering the chunk's
        positions; ``start_pos`` the chunk's first absolute position.
        Returns (last_position_logits, pools, state).
        """
        cfg = self.cfg
        x = self._embed(tokens)
        B, S = x.shape[:2]
        start = 0 if start_pos is None else int(start_pos)
        positions = (start + torch.arange(S, device=x.device))[None, :] \
            .expand(B, S)
        for i, p in enumerate(self.params["layers"]):
            h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
            out, pools[i] = attn_mod.gqa_prefill_paged(
                p["attn"], cfg, h, positions, *pools[i], tables)
            x = self._mlp_block(p, x + out)
        x = rms_norm(x, self.params["final_norm"], cfg.norm_eps)
        logits = self._logits(x[:, -1:])
        return logits[:, 0], pools, state

    def decode_step_paged(self, pools, state, token, pos, tables):
        """One decode step against paged attention KV. token (B,1);
        pos (B,) int; tables (B,P). Returns (logits, pools, state)."""
        cfg = self.cfg
        x = self._embed(token)
        for i, p in enumerate(self.params["layers"]):
            h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
            out, pools[i] = attn_mod.gqa_decode_paged(
                p["attn"], cfg, h, *pools[i], tables, pos,
                use_kernel=self.attn_kernel,
                split_kv_threshold=self.split_kv_threshold)
            x = self._mlp_block(p, x + out)
        x = rms_norm(x, self.params["final_norm"], cfg.norm_eps)
        logits = self._logits(x)
        return logits[:, 0], pools, state

    def duet_step_paged(self, pools, state, token, pos, tables, order):
        """One fused mixed-phase duet step against paged attention KV.

        ``token`` (R,1) combined rows — decode rows first (one per engine
        slot, each with its own ``tables`` row), then one prefill chunk's
        rows (successive positions, all sharing the chunk's table row).
        ``pos`` (R,) absolute positions; ``tables`` (R,P); ``order`` (R,)
        the Algorithm-1 tile permutation (``ops.build_duet_schedule``).
        Every layer executes both phases in one ``duet_attention_paged``
        launch. Returns (logits (R,V), pools, state).
        """
        cfg = self.cfg
        x = self._embed(token)
        for i, p in enumerate(self.params["layers"]):
            h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
            out, pools[i] = attn_mod.gqa_duet_paged(
                p["attn"], cfg, h, *pools[i], tables, pos, order)
            x = self._mlp_block(p, x + out)
        x = rms_norm(x, self.params["final_norm"], cfg.norm_eps)
        logits = self._logits(x)
        return logits[:, 0], pools, state

    # ---------------------------------------------------------------- cache
    def init_state_cache(self, batch: int):
        """Per-slot cache for paged serving: every layer of an all-GQA
        pattern keeps its KV in the page pools, so every entry is None."""
        return [None for _ in self.cfg.block_pattern]
