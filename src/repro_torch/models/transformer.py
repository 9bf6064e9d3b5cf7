"""The served model: an ``nn.Module`` that holds its weights and runs the
serving steps of the reference's ``repro.models.transformer.Model``.

Slab cache (one contiguous KV row per slot, ``init_cache``):

  * ``prefill``           — full-sequence or chunked prefill into the slab
  * ``decode_step``       — one token per slot; the kernel hook routes the
                            attention through the slab ``duet_attention``
                            kernel, ``sliding`` uses the ring buffer

Paged KV pool:

  * ``prefill_paged``     — chunked prefill against the paged KV pool
  * ``decode_step_paged`` — one token per slot (continuous batching)
  * ``duet_step_paged``   — decode rows + one prefill chunk in one fused
                            attention launch per layer

Attention blocks are ported — GQA (``attn``, ``attn_moe``) and MLA
(``mla``, ``mla_moe``), each with a dense MLP or the MoE FFN; recurrent
blocks and frontends are not yet. A GQA layer's cache is an AttnCache (or a
(k_pages, v_pages) pool pair), an MLA layer's an MLACache of latents (or a
(ckv_pages, krope_pages) pair). MLA runs no kernel (the reference has
none), and the fused duet step takes GQA blocks only, as the reference's.
Weights keep the reference's layouts and names (``params_from_jax``
carries a JAX tree over unchanged), and the weight methods take no
``params`` argument: the module owns them. Slab caches and page pools are
updated in place.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import GQA_KINDS, MLA_KINDS, ArchConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import embed, gated_mlp, rms_norm, unembed
from repro_torch.models.moe import moe_ffn
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
                 mla_absorb: bool = False, attn_kernel: bool = False,
                 split_kv_threshold: int = 0):
        super().__init__()
        layout(cfg)              # raises for block kinds not yet ported
        self.cfg = cfg
        self.params = ParamTree(params)
        # MLA decode: fold the latent up-projections into the query and
        # the output instead of expanding every cached latent each step
        self.mla_absorb = mla_absorb
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
    def _mlp_block(self, p, kind, x):
        """Post-attention MLP / MoE residual shared by every path. The MoE
        routes all of ``x``'s rows together, in row order."""
        h = rms_norm(x, p["mlp_norm"], self.cfg.norm_eps)
        if kind in ("attn_moe", "mla_moe"):
            return x + moe_ffn(p["moe"], self.cfg, h)
        return x + gated_mlp(p["mlp"], h, self.cfg.activation)

    def _layers(self):
        """(layer params, block kind) of every layer."""
        return zip(self.params["layers"], self.cfg.block_pattern)

    def _run_block_prefill(self, i, x, positions, cache_in, *, window=None):
        """One attention block (GQA or MLA, the kinds ``layout`` admits) of
        a full-sequence (``cache_in`` None) or chunked prefill. Returns
        (x, the layer's AttnCache or MLACache)."""
        cfg = self.cfg
        p, kind = self.params["layers"][i], cfg.block_pattern[i]
        h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
        if kind in MLA_KINDS:
            if cache_in is not None:
                out, new_cache = attn_mod.mla_prefill_cached(
                    p["attn"], cfg, h, positions, cache_in)
            else:
                out, new_cache = attn_mod.mla_prefill(p["attn"], cfg, h,
                                                      positions)
        elif cache_in is not None:
            out, new_cache = attn_mod.gqa_prefill_cached(
                p["attn"], cfg, h, positions, cache_in, window=window)
        else:
            out, new_cache = attn_mod.gqa_prefill(p["attn"], cfg, h,
                                                  positions, window=window)
        return self._mlp_block(p, kind, x + out), new_cache

    # ------------------------------------------------------------- slab serve
    def prefill(self, tokens, *, cache=None,
                start_pos: Optional[int] = None, sliding: bool = False):
        """Prefill (optionally a chunk continuing an existing cache).

        Returns (last_position_logits, cache). With ``cache`` given (one
        AttnCache or MLACache per layer, e.g. slot views of the engine's
        slab), the chunk's K/V or latents are written into it in place;
        without it, the cache of the new ones is returned. ``start_pos``:
        the chunk's first absolute position (default 0).
        """
        cfg = self.cfg
        x = self._embed(tokens)
        B, S = x.shape[:2]
        start = 0 if start_pos is None else int(start_pos)
        positions = (start + torch.arange(S, device=x.device))[None, :] \
            .expand(B, S)
        window = cfg.sliding_window if sliding else None
        new_cache = []
        for i in range(cfg.num_layers):
            c = None if cache is None else cache[i]
            if c is not None and window is None:
                # keys past the chunk are all masked: views of the slab cut
                # at the chunk's end keep the attention off its unwritten
                # tail (the writes still land in the slab)
                c = attn_mod.prefix_views(c, start + S)
            x, c = self._run_block_prefill(i, x, positions, c, window=window)
            new_cache.append(c)
        x = rms_norm(x, self.params["final_norm"], cfg.norm_eps)
        logits = self._logits(x[:, -1:])
        return logits[:, 0], (new_cache if cache is None else cache)

    def decode_step(self, cache, token, pos, *, sliding: bool = False,
                    active_mask: Optional[torch.Tensor] = None):
        """One decode step against the slab cache. token (B,1); pos (B,)
        int. The kernel hook (``attn_kernel``) takes the slab
        ``duet_attention`` kernel unless ``sliding``. ``active_mask`` (B,)
        bool, the port's argument: rows off it keep their slab entry (the
        reference's look-ahead loop restores them after the step).
        Returns (logits (B, V), cache)."""
        cfg = self.cfg
        x = self._embed(token)
        for i, (p, kind) in enumerate(self._layers()):
            h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
            if kind in MLA_KINDS:
                out, cache[i] = attn_mod.mla_decode(
                    p["attn"], cfg, h, cache[i], pos,
                    absorb=self.mla_absorb, active_mask=active_mask)
            elif self.attn_kernel and not sliding:
                out, cache[i] = attn_mod.gqa_decode_kernel(
                    p["attn"], cfg, h, cache[i], pos,
                    active_mask=active_mask)
            else:
                out, cache[i] = attn_mod.gqa_decode(
                    p["attn"], cfg, h, cache[i], pos, sliding=sliding,
                    active_mask=active_mask)
            x = self._mlp_block(p, kind, x + out)
        x = rms_norm(x, self.params["final_norm"], cfg.norm_eps)
        logits = self._logits(x)
        return logits[:, 0], cache

    # ------------------------------------------------------------ paged serve
    def prefill_paged(self, tokens, pools, state, tables, *,
                      start_pos: Optional[int] = None):
        """Chunked prefill with paged attention KV (PagedAttention layout).

        ``tokens`` (B, S); ``pools``: per-layer (k_pages, v_pages), or
        (ckv_pages, krope_pages) for an MLA layer;
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
        for i, (p, kind) in enumerate(self._layers()):
            h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
            prefill = (attn_mod.mla_prefill_paged if kind in MLA_KINDS
                       else attn_mod.gqa_prefill_paged)
            out, pools[i] = prefill(p["attn"], cfg, h, positions, *pools[i],
                                    tables)
            x = self._mlp_block(p, kind, x + out)
        x = rms_norm(x, self.params["final_norm"], cfg.norm_eps)
        logits = self._logits(x[:, -1:])
        return logits[:, 0], pools, state

    def decode_step_paged(self, pools, state, token, pos, tables):
        """One decode step against paged attention KV. token (B,1);
        pos (B,) int; tables (B,P). Returns (logits, pools, state)."""
        cfg = self.cfg
        x = self._embed(token)
        for i, (p, kind) in enumerate(self._layers()):
            h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
            if kind in MLA_KINDS:
                out, pools[i] = attn_mod.mla_decode_paged(
                    p["attn"], cfg, h, *pools[i], tables, pos,
                    absorb=self.mla_absorb)
            else:
                out, pools[i] = attn_mod.gqa_decode_paged(
                    p["attn"], cfg, h, *pools[i], tables, pos,
                    use_kernel=self.attn_kernel,
                    split_kv_threshold=self.split_kv_threshold)
            x = self._mlp_block(p, kind, x + out)
        x = rms_norm(x, self.params["final_norm"], cfg.norm_eps)
        logits = self._logits(x)
        return logits[:, 0], pools, state

    def duet_step_paged(self, pools, state, token, pos, tables, order, *,
                        block_q: int = 1):
        """One fused mixed-phase duet step against paged attention KV.

        ``token`` (R,1) combined rows — decode rows first (one per engine
        slot, each with its own ``tables`` row), then one prefill chunk's
        rows (successive positions, all sharing the chunk's table row).
        ``pos`` (R,) absolute positions; ``tables`` (R,P); ``order``
        (T*block_q,) the Algorithm-1 schedule's ``row_src``
        (``ops.build_duet_schedule`` with the same ``block_q``; -1 = pad;
        a permutation of the rows at ``block_q=1``). Every layer executes
        both phases in one ``duet_attention_paged`` launch; the tiles'
        packing stays inside attention, so an MoE routes the R rows in row
        order. Requires GQA attention blocks (the engine's capability
        probe gates dispatch). Returns (logits (R,V), pools, state).
        """
        cfg = self.cfg
        for kind in cfg.block_pattern:
            if kind not in ATTN_KINDS:
                raise ValueError(
                    f"duet kernel path requires GQA attention blocks, "
                    f"got {kind!r}")
        x = self._embed(token)
        packing = attn_mod.duet_packing(order, pos, block_q)
        for i, (p, kind) in enumerate(self._layers()):
            h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
            out, pools[i] = attn_mod.gqa_duet_paged(
                p["attn"], cfg, h, *pools[i], tables, pos, packing)
            x = self._mlp_block(p, kind, x + out)
        x = rms_norm(x, self.params["final_norm"], cfg.norm_eps)
        logits = self._logits(x)
        return logits[:, 0], pools, state

    # ---------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_len: int,
                   dtype: Optional[torch.dtype] = None, *,
                   sliding: bool = False) -> list:
        """Zeroed slab cache on the model's device, one AttnCache
        (batch, S, G, Dh) per GQA layer, S = max_len (min(max_len,
        sliding_window) with ``sliding``), and one MLACache (batch,
        max_len, r | rope) per MLA layer. ``dtype`` defaults to the
        model's."""
        return _build_cache(self.cfg, batch, max_len,
                            dtype or self.dtype, sliding, self.device)

    def init_state_cache(self, batch: int):
        """Per-slot cache for paged serving: every attention layer keeps
        its KV (or latents) in the page pools, so every entry is None."""
        return [None for _ in self.cfg.block_pattern]


def _build_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, sliding,
                 device) -> list:
    """One zeroed AttnCache per GQA layer, one MLACache per MLA layer
    (``layout`` refuses other kinds)."""
    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    S = min(max_len, cfg.sliding_window) if sliding else max_len
    G, dh = cfg.num_kv_heads, cfg.head_dim
    return [attn_mod.MLACache(ckv=zeros(batch, max_len, cfg.kv_lora_rank),
                              krope=zeros(batch, max_len, cfg.qk_rope_dim))
            if kind in MLA_KINDS else
            attn_mod.AttnCache(k=zeros(batch, S, G, dh),
                               v=zeros(batch, S, G, dh))
            for kind in cfg.block_pattern]
