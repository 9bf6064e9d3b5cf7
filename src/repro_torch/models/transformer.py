"""The model: an ``nn.Module`` that holds its weights and runs the
training forward and loss and the serving steps of the reference's
``repro.models.transformer.Model``.

Training (no cache is touched; every block's plain prefill path, so
autograd reaches every weight):

  * ``forward``           — full-sequence logits; with ``remat`` each block
                            is checkpointed (recomputed in the backward)
  * ``loss``              — next-token cross-entropy: causal LM (text), the
                            mean over the codebooks (audio), the text
                            suffix after the patch prefix (vision)

Slab cache (one contiguous KV row per slot, ``init_cache``):

  * ``prefill``           — full-sequence or chunked prefill into the slab
  * ``decode_step``       — one token per slot; the kernel hook routes the
                            attention through the slab ``duet_attention``
                            kernel, ``sliding`` uses the ring buffer

``cache_specs`` / ``cache_pspecs`` give the reference's global slab cache
tree as ``meta`` tensors and its partition specs on a grid, for the dry
run (``launch/dryrun.py``). Under a context with a sequence group
(context-parallel decode, ``DeviceContext.seq``) ``init_cache`` builds the
rank's span of every GQA cache's and MLA latent cache's sequence, as
``cache_pspecs`` places it, and ``decode_step`` combines the group's
partials; ``shard_cache`` cuts a whole cache into a rank's rows, heads
and span (``unshard_cache`` joins the ranks' shards).

Paged KV pool:

  * ``prefill_paged``     — chunked prefill against the paged KV pool
  * ``decode_step_paged`` — one token per slot (continuous batching)
  * ``duet_step_paged``   — decode rows + one prefill chunk in one fused
                            attention launch per layer

Every block kind of the reference is ported: GQA (``attn``, ``attn_moe``,
and Zamba2's ``shared_attn``, whose one set of weights sits at the
top-level ``shared_attn`` slot) and MLA (``mla``, ``mla_moe``), each with a
dense MLP or the MoE FFN, and the recurrent blocks ``mamba2``, ``mlstm``
and ``slstm``; and both frontends: audio (``tokens`` (B, K, S), the K
codebook embeddings summed, K heads giving (B, S, K, V) logits; slab
serving only, as the reference's paged steps raise for it) and vision
(``patch_embeds`` (B, P, D) prepended to the text embeddings, attended
bidirectionally under the prefix-LM mask). Cache layout per layer:

  attn / shared_attn -> AttnCache(k, v) (or a (k_pages, v_pages) pool pair)
  mla                -> MLACache(ckv, krope) (or (ckv_pages, krope_pages))
  mamba2             -> MambaCache(conv, ssm)
  mlstm              -> MLSTMCache(conv, C, n, m)
  slstm              -> SLSTMCache(c, n, m, h)

A recurrent layer keeps its state in the slab cache on the slab path and
in the per-slot ``state`` list (``init_state_cache``) on the paged path;
its pool entry is None. MLA and the recurrent blocks run no kernel (the
reference has none), and the fused duet step takes GQA blocks only, as
the reference's. Weights keep the reference's layouts and names
(``params_from_jax`` carries a JAX tree over unchanged), and the weight
methods take no ``params`` argument: the module owns them. Slab caches,
page pools and recurrent state are updated in place.

Tensor parallelism (``ctx``, a ``DeviceContext`` with tp > 1): the model
holds the rank's slices of the weights (``ctx.place_params``, or
``Model.init`` with the context), cut as the reference's axis rules say,
and sizes its caches at the rank's widths. The embedding and the logits
are vocab-parallel (the audio frontend's K tables and heads too, one
all-reduce each); GQA and MLA blocks run the rank's heads (MLA's latent
stays whole, so every rank writes the same latents); dense FFNs and
shared experts their ``ffn`` columns; the MoE routes every token
globally and runs the rank's experts (or each expert's ``moe_ffn``
columns); Mamba2 its heads' share of the inner width, with the whole B/C
channels; mLSTM and sLSTM blocks stay whole. Each sharded block ends in
one all-reduce and a whole one in none, so every rank computes the same
logits (``models/layers.py``, ``models/attention.py``, ``models/moe.py``,
``models/ssm.py``). The collectives are autograd's
(``DeviceContext.reduce_from_model`` / ``copy_to_model``), so the
training forward at TP gives every rank the gradients of its slices and
the whole leaves' whole gradients.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import GQA_KINDS, MLA_KINDS, ArchConfig
from repro_torch.core.device import (DeviceContext, DeviceLike,
                                     resolve_device)
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (cross_entropy, embed,
                                      embed_codebooks, gated_mlp, rms_norm,
                                      unembed, unembed_codebooks)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.params import (_leaves, _mlstm_inner, _shard_leaf,
                                       axis_rules, init_params, layout,
                                       param_specs, trainable)
from repro_torch.models.ssm import MambaCache
from repro_torch.models.xlstm import MLSTMCache, SLSTMCache

ATTN_KINDS = GQA_KINDS
# recurrent kind -> (its params key, prefill, decode step)
RECURRENT = {
    "mamba2": ("mamba", ssm_mod.mamba2_prefill, ssm_mod.mamba2_decode),
    "mlstm": ("mlstm", xlstm_mod.mlstm_prefill, xlstm_mod.mlstm_decode),
    "slstm": ("slstm", xlstm_mod.slstm_forward, xlstm_mod.slstm_forward),
}
STATE_TYPES = (MambaCache, MLSTMCache, SLSTMCache)


def write_state(dst, new, active_mask: Optional[torch.Tensor] = None):
    """Write a recurrent layer's new state ``new`` into ``dst`` in place,
    each leaf cast to ``dst``'s dtype; rows off ``active_mask`` (B,) bool
    keep theirs (the recurrent half of the reference's
    ``_freeze_inactive``)."""
    for d, n in zip(dst, new):
        n = n.to(d.dtype)
        if active_mask is not None:
            m = active_mask.reshape((-1,) + (1,) * (n.ndim - 1))
            n = torch.where(m, n, d)
        d.copy_(n)


def reset_slot_state(cache, slot: int):
    """Put slot ``slot``'s recurrent state (slab cache or paged ``state``
    list) back to the value ``init_state_cache`` and ``init_cache`` give it
    (zeros), in place; attention entries are left alone. The engines call
    this when a prefill starts at position 0 (a new occupant, or a re-prefill
    after preemption), so no request starts from an earlier one's state."""
    for c in cache:
        if isinstance(c, STATE_TYPES):
            for t in c:
                t[slot].zero_()


class ParamTree(nn.Module):
    """One node of the weight tree. Tensors are registered as buffers, held
    as they are given (a training run gives leaves that require grad,
    ``models.params.trainable``), and sub-trees as modules; the node
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


def _check_tp(cfg: ArchConfig, params: dict, ctx: DeviceContext):
    """Refuse a tree that is not this rank's slices."""
    specs = dict(_leaves(param_specs(cfg, ctx.tp)))
    have = dict(_leaves(params))
    for path, d in _leaves(layout(cfg)):
        want = tuple(_shard_leaf(torch.empty(d.shape, device="meta"),
                                 specs[path], ctx.tp, 0).shape)
        got = tuple(have[path].shape)
        if got != want:
            raise ValueError(
                f"Model: {'/'.join(map(str, path))} has shape {got}, rank "
                f"{ctx.rank} of tp={ctx.tp} holds {want}; pass "
                "ctx.place_params(tree)")


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, params: dict, *,
                 mla_absorb: bool = False, attn_kernel: bool = False,
                 split_kv_threshold: int = 0, remat: bool = False,
                 ctx: Optional[DeviceContext] = None):
        super().__init__()
        self.cfg = cfg
        # the device context: one device by default; with tp > 1 ``params``
        # are this rank's slices
        if ctx is None:
            ctx = DeviceContext(cfg, params["final_norm"].device)
        elif ctx.tp > 1:
            _check_tp(cfg, params, ctx)
        self.ctx = ctx
        self.params = ParamTree(params)
        # a Mamba2 layer's conv over the rank's channels (its x channels and
        # the whole B/C ones) for the steps that take no gradient: layer
        # index -> (the conv leaves' versions, (conv_w, conv_b))
        self._rank_conv = {}
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
        # checkpoint each block in the training forward (its activations
        # are recomputed in the backward), as the reference's remat
        self.remat = remat

    @classmethod
    def init(cls, cfg: ArchConfig, *, seed: int = 0,
             dtype=torch.float32, device: DeviceLike = None,
             ctx: Optional[DeviceContext] = None,
             requires_grad: bool = False, **kw) -> "Model":
        """Random weights from ``torch.Generator(device).manual_seed(seed)``
        on ``device`` (default: the card; raises without CUDA; a context
        brings its own device). With a TP context every rank draws the same
        full leaves and keeps its slice of each before drawing the next.
        With ``requires_grad`` the leaves require grad, for training."""
        dev = ctx.device if ctx is not None else resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        tp, rank = (ctx.tp, ctx.rank) if ctx is not None else (1, 0)
        params = init_params(cfg, gen, dtype, dev, tp=tp, rank=rank)
        return cls(cfg, trainable(params) if requires_grad else params,
                   ctx=ctx, **kw)

    @property
    def device(self) -> torch.device:
        return self.params["final_norm"].device

    @property
    def dtype(self) -> torch.dtype:
        return self.params["final_norm"].dtype

    def param_tree(self) -> dict:
        """The model's own weight tensors as a nested dict (lists for
        ``layers``), in the layout of ``models.params.layout``: what the
        optimizer updates in place and a checkpoint saves."""
        def walk(node):
            if isinstance(node, nn.ModuleList):
                return [walk(m) for m in node]
            return {**dict(node._buffers),
                    **{k: walk(m) for k, m in node._modules.items()}}
        return walk(self.params)

    # ----------------------------------------------------------------- embed
    def _embed(self, tokens, patch_embeds=None):
        """(x, prefix_len). Audio: ``tokens`` (B, K, S), the K codebooks'
        embeddings summed. Vision: ``patch_embeds`` (B, P, D), when given,
        go before the text embeddings and ``prefix_len`` is P."""
        cfg = self.cfg
        if cfg.frontend == "audio":
            return embed_codebooks(self.params["codebook_embeddings"],
                                   tokens, self.ctx), 0
        x = embed(self.params, tokens, self.ctx)
        if patch_embeds is None:
            return x, 0
        return (torch.cat([patch_embeds.to(x.dtype), x], dim=1),
                patch_embeds.shape[1])

    def _logits(self, x):
        """Logits (B, S, V), or (B, S, K, V) from the audio heads. Tied
        embeddings have no w_out in the layout, so unembed reads the
        embedding table."""
        if self.cfg.frontend == "audio":
            return unembed_codebooks(self.params["w_heads"], x,
                                     self.cfg.vocab_size, self.ctx)
        return unembed(self.params, x, self.cfg.vocab_size, self.ctx)

    def _text_only(self):
        if self.cfg.frontend == "audio":
            raise NotImplementedError("paged serving covers text frontends")

    # ---------------------------------------------------------------- blocks
    def _mlp_block(self, p, kind, x):
        """Post-attention MLP / MoE residual shared by every path. The MoE
        routes all of ``x``'s rows together, in row order."""
        h = rms_norm(x, p["mlp_norm"], self.cfg.norm_eps)
        if kind in ("attn_moe", "mla_moe"):
            return x + moe_ffn(p["moe"], self.cfg, h, self.ctx)
        return x + gated_mlp(p["mlp"], h, self.cfg.activation, self.ctx)

    def _block_params(self, i: int):
        """(layer ``i``'s params, its kind): a ``shared_attn`` layer reads
        the one shared block's weights."""
        kind = self.cfg.block_pattern[i]
        if kind == "shared_attn":
            return self.params["shared_attn"], kind
        return self.params["layers"][i], kind

    def _layers(self):
        """(layer params, block kind) of every layer."""
        return (self._block_params(i) for i in range(self.cfg.num_layers))

    def _conv_cut(self, i, p):
        """Layer ``i``'s rank conv (``ssm.rank_conv``) cut once and reused
        while its leaves are unchanged, for steps that take no gradient;
        None (the block cuts it in the forward, where autograd sees the
        index) at tp 1 or when a gradient may flow."""
        w, b = p["conv_w"], p["conv_b"]
        if not self.ctx.sharded("ssm_inner") or (
                torch.is_grad_enabled()
                and (w.requires_grad or b.requires_grad)):
            return None
        key = (w._version, b._version)
        hit = self._rank_conv.get(i)
        if hit is None or hit[0] != key:
            hit = (key, ssm_mod.rank_conv(p, self.ctx.local_d_inner,
                                          self.ctx.rank))
            self._rank_conv[i] = hit
        return hit[1]

    def _recurrent(self, i, x, cache_in, *, decode: bool):
        """Layer ``i``, a recurrent block (pre-norm, residual). Returns (x,
        the layer's new state). A Mamba2 block takes the rank's conv and
        the context; the xLSTM blocks stay whole and make no
        collective."""
        p, kind = self._block_params(i)
        key, prefill, step = RECURRENT[kind]
        kw = ({"conv": self._conv_cut(i, p[key]), "ctx": self.ctx}
              if kind == "mamba2" else {})
        h = rms_norm(x, p["norm"], self.cfg.norm_eps)
        out, new = (step if decode else prefill)(p[key], self.cfg, h,
                                                 cache_in, **kw)
        return x + out, new

    def _run_block_prefill(self, i, x, positions, cache_in, *,
                           prefix_len: int = 0, window=None):
        """One block of a full-sequence (``cache_in`` None) or chunked
        prefill; a GQA block attends the first ``prefix_len`` positions
        bidirectionally. Returns (x, the layer's AttnCache, MLACache or
        recurrent state). Without a cache nothing is written in place, so
        autograd runs through it."""
        cfg = self.cfg
        p, kind = self._block_params(i)
        if kind in RECURRENT:
            return self._recurrent(i, x, cache_in, decode=False)
        h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
        if kind in MLA_KINDS:
            if cache_in is not None:
                out, new_cache = attn_mod.mla_prefill_cached(
                    p["attn"], cfg, h, positions, cache_in, ctx=self.ctx)
            else:
                out, new_cache = attn_mod.mla_prefill(p["attn"], cfg, h,
                                                      positions,
                                                      ctx=self.ctx)
        elif cache_in is not None:
            out, new_cache = attn_mod.gqa_prefill_cached(
                p["attn"], cfg, h, positions, cache_in, window=window,
                prefix_len=prefix_len, ctx=self.ctx)
        else:
            out, new_cache = attn_mod.gqa_prefill(p["attn"], cfg, h,
                                                  positions,
                                                  prefix_len=prefix_len,
                                                  window=window,
                                                  ctx=self.ctx)
        return self._mlp_block(p, kind, x + out), new_cache

    # --------------------------------------------------------------- training
    def forward(self, tokens, *, patch_embeds=None, sliding: bool = False):
        """Full-sequence forward -> logits at every position: (B, S, V);
        audio (B, S, K, V); vision over the P patch positions and the
        text's, (B, P + S, V). With ``remat`` and autograd on, each block
        is checkpointed (``torch.utils.checkpoint``, non-reentrant): only
        its input is kept and its activations are recomputed in the
        backward."""
        cfg = self.cfg
        x, prefix_len = self._embed(tokens, patch_embeds)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
        window = cfg.sliding_window if sliding else None
        prefix_len = prefix_len if cfg.prefix_lm else 0

        def block(i, h):
            return self._run_block_prefill(i, h, positions, None,
                                           prefix_len=prefix_len,
                                           window=window)[0]

        for i in range(cfg.num_layers):
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, i, x, use_reentrant=False)
            else:
                x = block(i, x)
        x = rms_norm(x, self.params["final_norm"], cfg.norm_eps)
        return self._logits(x)

    def loss(self, batch: dict) -> torch.Tensor:
        """Mean next-token cross-entropy of a batch of tensors on the
        model's device (``data.pipeline``'s keys): text ``tokens`` /
        ``labels`` (B, S), each position predicting the next; audio (B, K,
        S), over every codebook; vision the text suffix after the
        ``patch_embeds`` prefix, the logit at position P - 1 + t predicting
        text token t."""
        cfg = self.cfg
        if cfg.frontend == "audio":
            logits = self.forward(batch["tokens"][:, :, :-1])
            # logits (B,S,K,V) -> (B,K,S,V), aligned with the labels
            return cross_entropy(logits.transpose(1, 2),
                                 batch["labels"][:, :, 1:], cfg.vocab_size)
        if cfg.frontend == "vision":
            logits = self.forward(batch["tokens"],
                                  patch_embeds=batch["patch_embeds"])
            P = batch["patch_embeds"].shape[1]
            St = batch["tokens"].shape[1]
            return cross_entropy(logits[:, P - 1:P + St - 1],
                                 batch["labels"], cfg.vocab_size)
        logits = self.forward(batch["tokens"][:, :-1])
        return cross_entropy(logits, batch["labels"][:, 1:], cfg.vocab_size)

    # ------------------------------------------------------------- slab serve
    def prefill(self, tokens, *, cache=None,
                start_pos: Optional[int] = None, patch_embeds=None,
                sliding: bool = False):
        """Prefill (optionally a chunk continuing an existing cache).

        Returns (last_position_logits, cache). With ``cache`` given (one
        entry per layer, e.g. slot views of the engine's slab), the chunk's
        K/V or latents are written into it in place and recurrent state
        carries forward from it and is written back in place; without it,
        the cache of the new ones is returned. ``start_pos``: the chunk's
        first absolute position (default 0). Audio: ``tokens`` (B, K, S)
        and (B, K, V) logits. Vision: ``patch_embeds`` (B, P, D) take
        positions 0..P-1 before the text, attended bidirectionally under
        the prefix-LM mask.
        """
        cfg = self.cfg
        if cache is not None and self.ctx.seq > 1 and any(
                kind in ATTN_KINDS or kind in MLA_KINDS
                for kind in cfg.block_pattern):
            raise NotImplementedError(
                "prefill into a sequence-sharded cache is not yet ported: "
                "prefill the whole cache and cut it with shard_cache")
        x, prefix_len = self._embed(tokens, patch_embeds)
        prefix_len = prefix_len if cfg.prefix_lm else 0
        B, S = x.shape[:2]
        start = 0 if start_pos is None else int(start_pos)
        positions = (start + torch.arange(S, device=x.device))[None, :] \
            .expand(B, S)
        window = cfg.sliding_window if sliding else None
        new_cache = []
        for i, kind in enumerate(cfg.block_pattern):
            c = None if cache is None else cache[i]
            recurrent = kind in RECURRENT
            if c is not None and window is None and not recurrent:
                # keys past the chunk are all masked: views of the slab cut
                # at the chunk's end keep the attention off its unwritten
                # tail (the writes still land in the slab)
                c = attn_mod.prefix_views(c, start + S)
            x, new = self._run_block_prefill(i, x, positions, c,
                                             prefix_len=prefix_len,
                                             window=window)
            if recurrent and c is not None:
                write_state(c, new)
            new_cache.append(new)
        x = rms_norm(x, self.params["final_norm"], cfg.norm_eps)
        logits = self._logits(x[:, -1:])
        return logits[:, 0], (new_cache if cache is None else cache)

    def decode_step(self, cache, token, pos, *, sliding: bool = False,
                    active_mask: Optional[torch.Tensor] = None):
        """One decode step against the slab cache. token (B,1); pos (B,)
        int. The kernel hook (``attn_kernel``) takes the slab
        ``duet_attention`` kernel unless ``sliding``. ``active_mask`` (B,)
        bool, the port's argument: rows off it keep their slab entry and
        recurrent state (the reference's look-ahead loop restores them
        after the step). Audio: token (B, K, 1), the codebooks summed.
        Under a context with a sequence group (``ctx.seq`` > 1) every GQA
        cache and MLA latent cache is the rank's span of the sequence (or
        ring), as ``cache_pspecs`` places it: each rank attends over its
        span and the group's partials are combined in one collective a
        layer (an MLA layer first gathers every head's query over the
        model group), so every rank of the group gets the logits one
        device with the whole cache gets, bit for bit the same on every
        rank (``pos`` stays global).
        Returns (logits (B, V), or (B, K, V) for audio, cache)."""
        cfg = self.cfg
        x, _ = self._embed(token)
        for i, (p, kind) in enumerate(self._layers()):
            if kind in RECURRENT:
                x, new = self._recurrent(i, x, cache[i], decode=True)
                write_state(cache[i], new, active_mask)
                continue
            h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
            if kind in MLA_KINDS:
                out, cache[i] = attn_mod.mla_decode(
                    p["attn"], cfg, h, cache[i], pos,
                    absorb=self.mla_absorb, active_mask=active_mask,
                    ctx=self.ctx)
            elif self.attn_kernel and not sliding:
                out, cache[i] = attn_mod.gqa_decode_kernel(
                    p["attn"], cfg, h, cache[i], pos,
                    active_mask=active_mask, ctx=self.ctx)
            else:
                out, cache[i] = attn_mod.gqa_decode(
                    p["attn"], cfg, h, cache[i], pos, sliding=sliding,
                    active_mask=active_mask, ctx=self.ctx)
            x = self._mlp_block(p, kind, x + out)
        x = rms_norm(x, self.params["final_norm"], cfg.norm_eps)
        logits = self._logits(x)
        return logits[:, 0], cache

    # ------------------------------------------------------------ paged serve
    def prefill_paged(self, tokens, pools, state, tables, *,
                      start_pos: Optional[int] = None):
        """Chunked prefill with paged attention KV (PagedAttention layout).

        ``tokens`` (B, S); ``pools``: per-layer (k_pages, v_pages), or
        (ckv_pages, krope_pages) for an MLA layer, None for a recurrent
        one; ``state``: per-layer recurrent state of the B rows (None for
        attention layers; e.g. ``slot_views`` of the engine's per-slot
        state), carried forward and written back in place;
        ``tables`` (B, P) int32 block tables covering the chunk's
        positions; ``start_pos`` the chunk's first absolute position, a
        host int or a 0-d device tensor (read on the device: a captured
        CUDA graph takes it at replay).
        Returns (last_position_logits, pools, state).
        """
        cfg = self.cfg
        self._text_only()
        x, _ = self._embed(tokens)
        B, S = x.shape[:2]
        start = 0 if start_pos is None else start_pos
        if isinstance(start, torch.Tensor):
            start = start.to(x.device, torch.long)
        positions = (start + torch.arange(S, device=x.device))[None, :] \
            .expand(B, S)
        for i, (p, kind) in enumerate(self._layers()):
            if kind in RECURRENT:
                x, new = self._recurrent(i, x, state[i], decode=False)
                write_state(state[i], new)
                continue
            h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
            if kind in MLA_KINDS:
                out, pools[i] = attn_mod.mla_prefill_paged(
                    p["attn"], cfg, h, positions, *pools[i], tables,
                    ctx=self.ctx)
            else:
                out, pools[i] = attn_mod.gqa_prefill_paged(
                    p["attn"], cfg, h, positions, *pools[i], tables,
                    ctx=self.ctx)
            x = self._mlp_block(p, kind, x + out)
        x = rms_norm(x, self.params["final_norm"], cfg.norm_eps)
        logits = self._logits(x[:, -1:])
        return logits[:, 0], pools, state

    def decode_step_paged(self, pools, state, token, pos, tables, *,
                          active_mask: Optional[torch.Tensor] = None):
        """One decode step against paged attention KV. token (B,1);
        pos (B,) int; tables (B,P). ``active_mask`` (B,) bool, the port's
        argument: rows off it keep their recurrent state (their attention
        writes land in the null page through all-zero table rows).
        Returns (logits, pools, state)."""
        cfg = self.cfg
        self._text_only()
        x, _ = self._embed(token)
        for i, (p, kind) in enumerate(self._layers()):
            if kind in RECURRENT:
                x, new = self._recurrent(i, x, state[i], decode=True)
                write_state(state[i], new, active_mask)
                continue
            h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
            if kind in MLA_KINDS:
                out, pools[i] = attn_mod.mla_decode_paged(
                    p["attn"], cfg, h, *pools[i], tables, pos,
                    absorb=self.mla_absorb, ctx=self.ctx)
            else:
                out, pools[i] = attn_mod.gqa_decode_paged(
                    p["attn"], cfg, h, *pools[i], tables, pos,
                    use_kernel=self.attn_kernel,
                    split_kv_threshold=self.split_kv_threshold,
                    ctx=self.ctx)
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
        self._text_only()
        for kind in cfg.block_pattern:
            if kind not in ATTN_KINDS:
                raise ValueError(
                    f"duet kernel path requires GQA attention blocks, "
                    f"got {kind!r}")
        x, _ = self._embed(token)
        packing = attn_mod.duet_packing(order, pos, block_q)
        for i, (p, kind) in enumerate(self._layers()):
            h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
            out, pools[i] = attn_mod.gqa_duet_paged(
                p["attn"], cfg, h, *pools[i], tables, pos, packing,
                ctx=self.ctx)
            x = self._mlp_block(p, kind, x + out)
        x = rms_norm(x, self.params["final_norm"], cfg.norm_eps)
        logits = self._logits(x)
        return logits[:, 0], pools, state

    # ---------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_len: int,
                   dtype: Optional[torch.dtype] = None, *,
                   sliding: bool = False) -> list:
        """Zeroed slab cache on the model's device: one AttnCache
        (batch, S, G, Dh) per GQA layer, S = max_len (min(max_len,
        sliding_window) with ``sliding``), one MLACache (batch, max_len,
        r | rope) per MLA layer, and one recurrent state per recurrent
        layer (its conv tail in ``dtype``, the rest fp32), all at the
        rank's widths (G its KV heads, Mamba2 its heads and inner
        channels). Under a sequence group a GQA cache holds the rank's
        span of S, S / ``ctx.seq`` keys, and an MLA cache its span of
        max_len (raises where that does not divide). ``dtype`` defaults
        to the model's."""
        return _build_cache(self.cfg, batch, max_len,
                            dtype or self.dtype, sliding, self.device,
                            ctx=self.ctx)

    def init_state_cache(self, batch: int) -> list:
        """Per-slot cache for paged serving: attention entries are None
        (their KV lives in the page pools); recurrent layers keep their
        O(1) per-slot state, zeroed, as ``init_cache`` builds it."""
        return _build_cache(self.cfg, batch, 1, self.dtype, False,
                            self.device, attention=False, ctx=self.ctx)


def _build_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, sliding,
                 device, *, attention: bool = True,
                 ctx: DeviceContext) -> list:
    """One zeroed entry per layer: AttnCache (GQA), MLACache (MLA),
    MambaCache / MLSTMCache / SLSTMCache (recurrent; fp32 but for the conv
    tails, as the reference's), at ``ctx``'s rank widths: its KV heads
    and its span of the GQA sequence (``ctx.seq_span``), its span of MLA's
    latent sequence (of ``max_len`` even when ``sliding``: MLA never
    slides), and Mamba2's conv (B, W-1, d_inner/tp + 2n) and SSM state
    (B, heads/tp, p, n); the xLSTM states stay whole. With ``attention``
    False the attention entries are None (the paged path's per-slot
    state)."""
    def zeros(*shape, dt=None):
        return torch.zeros(shape, dtype=dt or dtype, device=device)
    f32 = torch.float32
    S = min(max_len, cfg.sliding_window) if sliding else max_len
    S_lat = max_len
    if attention:
        S = ctx.seq_span(S)[1]
        S_lat = ctx.seq_span(max_len)[1]
    G, dh = ctx.local_kv_heads, cfg.head_dim
    cache = []
    for kind in cfg.block_pattern:
        if kind in ATTN_KINDS:
            cache.append(attn_mod.AttnCache(k=zeros(batch, S, G, dh),
                                            v=zeros(batch, S, G, dh))
                         if attention else None)
        elif kind in MLA_KINDS:
            cache.append(attn_mod.MLACache(
                ckv=zeros(batch, S_lat, cfg.kv_lora_rank),
                krope=zeros(batch, S_lat, cfg.qk_rope_dim))
                if attention else None)
        elif kind == "mamba2":
            conv_ch = ctx.local_d_inner + 2 * cfg.ssm_state
            cache.append(MambaCache(
                conv=zeros(batch, cfg.ssm_conv - 1, conv_ch),
                ssm=zeros(batch, ctx.local_ssm_heads, cfg.ssm_head_dim,
                          cfg.ssm_state, dt=f32)))
        elif kind == "mlstm":
            di = _mlstm_inner(cfg)
            h, hd = cfg.num_heads, di // cfg.num_heads
            cache.append(MLSTMCache(conv=zeros(batch, cfg.ssm_conv - 1, di),
                                    C=zeros(batch, h, hd, hd, dt=f32),
                                    n=zeros(batch, h, hd, dt=f32),
                                    m=zeros(batch, h, dt=f32)))
        elif kind == "slstm":
            D = cfg.d_model
            cache.append(SLSTMCache(*(zeros(batch, D, dt=f32)
                                      for _ in range(4))))
        else:
            raise ValueError(kind)
    return cache


def cache_specs(cfg: ArchConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, *, sliding: bool = False) -> list:
    """The reference's (global) slab cache tree as ``meta`` tensors, no
    storage: whole KV heads and Mamba2 widths, MLA latents at ``max_len``
    even when ``sliding``."""
    meta = torch.device("meta")
    return _build_cache(cfg, batch, max_len, dtype, sliding, meta,
                        ctx=DeviceContext(cfg, meta))


def cache_pspecs(cfg: ArchConfig, grid, batch: int, *,
                 sliding: bool = False) -> list:
    """The reference's partition specs of the :func:`cache_specs` tree on
    ``grid`` (``launch.mesh.Grid``, or anything whose ``shape`` maps axis
    names to sizes): each leaf's spec is a tuple with one entry a dim,
    None, an axis name or a tuple of two or more axis names (the entries
    of the reference's ``PartitionSpec``, which writes one axis as its
    name).

    Batch shards over (pod?, data) when they divide it; for batch 1
    (long_500k) attention caches shard their *sequence* over the data axes
    instead (context-parallel decode). An attention cache whose KV heads do
    not shard over ``model`` shards its sequence over it too, and MLA's
    latents always do; recurrent states replicate over data, Mamba2's SSM
    state split on ``ssm_heads``. (What the reference's GSPMD lowering
    places. The port's ranks hold it for the GQA and MLA caches under a
    context whose sequence group is :func:`cache_seq_axes`', and cut
    Mamba2's conv tail to the rank's channels.)"""
    on_batch, seq_ax = _batch_and_seq_axes(grid, batch)
    batch_ax = _entry(on_batch)
    rules = axis_rules(cfg, grid.shape.get("model", 1))
    ssm_heads_ax = rules["ssm_heads"]

    specs = []
    for kind in cfg.block_pattern:
        if kind in ATTN_KINDS:
            kv_ax = rules["kv_heads"]
            sq = _entry(_gqa_seq_axes(cfg, grid, seq_ax))
            s = (batch_ax, sq, kv_ax, None)
            specs.append(attn_mod.AttnCache(k=s, v=s))
        elif kind in MLA_KINDS:
            sq = _entry(seq_ax + ("model",))
            specs.append(attn_mod.MLACache(ckv=(batch_ax, sq, None),
                                           krope=(batch_ax, sq, None)))
        elif kind == "mamba2":
            specs.append(MambaCache(conv=(batch_ax, None, None),
                                    ssm=(batch_ax, ssm_heads_ax, None,
                                         None)))
        elif kind == "mlstm":
            specs.append(MLSTMCache(conv=(batch_ax, None, None),
                                    C=(batch_ax, None, None, None),
                                    n=(batch_ax, None, None),
                                    m=(batch_ax, None)))
        elif kind == "slstm":
            s2 = (batch_ax, None)
            specs.append(SLSTMCache(c=s2, n=s2, m=s2, h=s2))
        else:
            raise ValueError(kind)
    return specs


def _entry(axes: tuple):
    """A spec entry over ``axes``: None, one name, or the tuple."""
    return None if not axes else axes[0] if len(axes) == 1 else axes


def _batch_and_seq_axes(grid, batch: int):
    """(the axes the batch is cut on, the data axes an attention cache's
    sequence is cut on instead: batch 1)"""
    # launch.mesh imports the models package (through core), so not above
    from repro_torch.launch.mesh import batch_split, data_axes
    on_batch, _ = batch_split(grid, batch)
    return on_batch, (() if on_batch else data_axes(grid))


def _gqa_seq_axes(cfg: ArchConfig, grid, seq_ax: tuple) -> tuple:
    """The axes a GQA cache's sequence is cut on: ``seq_ax`` (the data
    axes at batch 1), then ``model`` where the KV heads do not divide
    it."""
    kv_ax = axis_rules(cfg, grid.shape.get("model", 1))["kv_heads"]
    return seq_ax + (("model",) if kv_ax is None else ())


def cache_seq_axes(cfg: ArchConfig, grid, batch: int) -> tuple:
    """The axes :func:`cache_pspecs` cuts an attention cache's sequence
    on, in the spec entry's order: the data axes at batch 1, then
    ``model`` for MLA's latents (always) and for a GQA cache whose KV heads
    do not divide it; () where it cuts none. A rank's context-parallel
    sequence group is the ranks over these axes
    (``launch.mesh.Rank.context(cfg, seq_axes=...)``). Raises for a config
    whose GQA and MLA caches would need two different groups (no
    registered config has both kinds)."""
    _, seq_ax = _batch_and_seq_axes(grid, batch)
    gqa = _gqa_seq_axes(cfg, grid, seq_ax)
    if not any(kind in MLA_KINDS for kind in cfg.block_pattern):
        return gqa
    mla = seq_ax + ("model",)
    if gqa != mla and any(kind in ATTN_KINDS for kind in cfg.block_pattern):
        raise ValueError(f"cache_seq_axes: {cfg.name}'s GQA caches cut "
                         f"their sequence on {gqa} and its MLA latents on "
                         f"{mla}; a rank has one sequence group")
    return mla


def _axes_of(entry) -> tuple:
    return () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)


def _rank_slices(kind: str, leaf: int, spec: tuple, shape, cfg: ArchConfig,
                 grid, coords: dict):
    """The index into a whole cache leaf of ``shape`` that gives the
    rank at grid ``coords`` its shard: on each dim cut by ``spec``, the
    rank's part (the entry's axes row-major: data major, model minor); on
    Mamba2's conv tail (channels [x | B | C]) the rank's x channels and
    every B and C channel where ``ssm_inner`` is cut (the port's rank
    conv, ``ssm.rank_conv``), where the reference's spec keeps the
    channels whole. Raises where a part does not divide."""
    idx = []
    for dim, (size, entry) in enumerate(zip(shape, spec)):
        n, part = 1, 0
        for a in _axes_of(entry):
            n *= grid.shape[a]
            part = part * grid.shape[a] + coords[a]
        if size % n:
            raise ValueError(f"shard_cache: {kind} leaf {leaf} dim {dim} "
                             f"of {size} does not split into {n} parts")
        w = size // n
        idx.append(slice(part * w, (part + 1) * w))
    tp = grid.shape.get("model", 1)
    if kind == "mamba2" and leaf == 0 and tp > 1 \
            and axis_rules(cfg, tp)["ssm_inner"] == "model":
        di = cfg.d_inner // tp
        m = coords["model"]
        idx[2] = torch.cat([torch.arange(m * di, (m + 1) * di),
                            torch.arange(cfg.d_inner, shape[2])])
    return tuple(idx)


def _grid_coords(grid, rank: int) -> dict:
    import numpy as np
    return dict(zip(grid.axis_names,
                    (int(i) for i in np.unravel_index(rank, grid.sizes))))


def shard_cache(cache: list, cfg: ArchConfig, grid, batch: int, rank: int,
                *, sliding: bool = False) -> list:
    """Global rank ``rank``'s shard of a whole slab cache (e.g. the
    reference's from its ``prefill``, one entry a layer) on ``grid``, as
    :func:`cache_pspecs` places it: its rows, its KV heads and its span of
    every GQA cache's sequence (or ring) and of every MLA latent cache's
    sequence, its Mamba2 heads and conv channels; recurrent states whole
    otherwise. The cache's counterpart of ``models.params.shard_params``:
    the result is what ``Model.init_cache`` builds under the rank's
    context (copies). ``batch`` is the global batch."""
    coords = _grid_coords(grid, rank)
    specs = cache_pspecs(cfg, grid, batch, sliding=sliding)
    out = []
    for kind, entry, spec in zip(cfg.block_pattern, cache, specs):
        out.append(type(entry)(*(
            t[_rank_slices(kind, i, s, t.shape, cfg, grid, coords)].clone()
            for i, (t, s) in enumerate(zip(entry, spec)))))
    return out


def unshard_cache(shards: list, cfg: ArchConfig, grid, batch: int, *,
                  sliding: bool = False) -> list:
    """The whole cache from every rank's :func:`shard_cache` shard
    (``shards`` in global rank order): each rank's part put back where it
    came from (parts every rank holds are taken from the last)."""
    if len(shards) != grid.size:
        raise ValueError(f"unshard_cache: {len(shards)} shards for a grid "
                         f"of {grid.size} ranks")
    specs = cache_pspecs(cfg, grid, batch, sliding=sliding)
    tp = grid.shape.get("model", 1)
    conv_cut = tp > 1 and axis_rules(cfg, tp)["ssm_inner"] == "model"
    out = []
    for layer, (kind, spec) in enumerate(zip(cfg.block_pattern, specs)):
        first = shards[0][layer]
        leaves = []
        for i, (t, s) in enumerate(zip(first, spec)):
            shape = [size * math.prod(grid.shape[a] for a in _axes_of(e))
                     for size, e in zip(t.shape, s)]
            if kind == "mamba2" and i == 0 and conv_cut:
                shape[2] = cfg.d_inner + 2 * cfg.ssm_state
            whole = t.new_empty(shape)
            for r in range(grid.size):
                idx = _rank_slices(kind, i, s, shape, cfg, grid,
                                   _grid_coords(grid, r))
                whole[idx] = shards[r][layer][i]
            leaves.append(whole)
        out.append(type(first)(*leaves))
    return out
