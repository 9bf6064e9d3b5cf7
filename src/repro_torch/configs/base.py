"""Architecture configuration system.

Every assigned architecture is expressed as an :class:`ArchConfig` — a frozen,
declarative description consumed by ``repro_torch.models.transformer.Model`` (layer
stack), ``repro_torch.models.params`` (init) and ``repro_torch.core.roofline``
(operator census). The port registers every architecture of the
reference; ``get_config`` of any other name raises "not yet ported".

Block types (``block_pattern`` entries):
  ``attn``    self-attention + MLP (dense transformer block)
  ``attn_moe``self-attention + MoE FFN
  ``mla``     multi-head latent attention + MLP
  ``mla_moe`` MLA + MoE FFN (DeepSeek-V2 style)
  ``mamba2``  Mamba2 (SSD) block
  ``shared_attn`` hybrid shared transformer block (Zamba2): weights shared
              across all occurrences in the pattern
  ``slstm``   xLSTM sLSTM block
  ``mlstm``   xLSTM mLSTM block
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

VOCAB_PAD_MULTIPLE = 256  # embedding tables padded so `model`-axis sharding divides

# Single source of truth for how block kinds store sequence state: attention
# kinds keep it in the KV cache (paged pools); recurrent kinds carry O(1)
# per-slot state that must process every token. Attention further splits by
# cache layout — GQA kinds store (K, V) per KV head, MLA kinds store the
# compressed (latent, rope) pair — and that split decides page-pool shapes,
# sharding axes and roofline KV-byte counts. Every allowlist downstream
# (model assembly, page-pool shapes, prefix-cache gating, KV sharding)
# derives from these tuples; a new kind registered here is either fully
# supported everywhere or rejected loudly, never half-registered.
GQA_KINDS = ("attn", "attn_moe", "shared_attn")
MLA_KINDS = ("mla", "mla_moe")
ATTENTION_KINDS = GQA_KINDS + MLA_KINDS
RECURRENT_KINDS = ("mamba2", "slstm", "mlstm")


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    source: str                      # citation from the assignment
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None   # default d_model // num_heads
    block_pattern: Tuple[str, ...] = ()  # default: ("attn",) * num_layers

    # --- attention options -------------------------------------------------
    qk_norm: bool = False            # Qwen3-style per-head RMSNorm on q/k
    rope_theta: float = 10_000.0
    sliding_window: int = 8192       # window used by the long-context variant
    prefix_lm: bool = False          # PaliGemma: bidirectional attn on prefix
    activation: str = "silu"         # silu | gelu
    mlp_gated: bool = True           # SwiGLU/GeGLU vs plain 2-matrix FFN

    # --- MLA (DeepSeek-V2) --------------------------------------------------
    kv_lora_rank: int = 0            # >0 enables MLA
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    num_experts_routed: int = 0      # 0 = all; >0: only the first N are
    # routable (the rest are zero-weight padding added so the expert dim
    # divides the model axis — §Perf iteration, EXPERIMENTS.md)
    num_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim
    first_dense_layers: int = 0      # leading layers that keep a dense FFN
    capacity_factor: float = 1.25

    # --- SSM (Mamba2) ---------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_expand: int = 2

    # --- xLSTM ----------------------------------------------------------------
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0

    # --- hybrid (Zamba2) -------------------------------------------------------
    shared_attn_period: int = 6      # shared transformer block every N layers

    # --- modality frontend stubs ----------------------------------------------
    frontend: Optional[str] = None   # None | "vision" | "audio"
    num_prefix_tokens: int = 0       # vision patch embeddings prepended
    num_codebooks: int = 1           # audio: parallel codebook heads

    # --- training -----------------------------------------------------------
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    lr_schedule: str = "cosine"      # cosine | wsd

    # ------------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if not self.block_pattern:
            if self.num_experts > 0 and self.kv_lora_rank > 0:
                pat = ["mla"] * self.first_dense_layers + ["mla_moe"] * (
                    self.num_layers - self.first_dense_layers)
            elif self.num_experts > 0:
                pat = ["attn"] * self.first_dense_layers + ["attn_moe"] * (
                    self.num_layers - self.first_dense_layers)
            else:
                pat = ["attn"] * self.num_layers
            object.__setattr__(self, "block_pattern", tuple(pat))
        assert len(self.block_pattern) == self.num_layers, (
            self.name, len(self.block_pattern), self.num_layers)

    # ------------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        m = VOCAB_PAD_MULTIPLE
        return (self.vocab_size + m - 1) // m * m

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def has_attention(self) -> bool:
        return any(b in ATTENTION_KINDS for b in self.block_pattern)

    @property
    def is_recurrent(self) -> bool:
        """True when decode state is O(1) in context length (SSM / xLSTM)."""
        return all(b in RECURRENT_KINDS for b in self.block_pattern)

    @property
    def attention_only(self) -> bool:
        """True when every block's sequence state lives in the KV cache.
        Recurrent blocks carry per-slot state that must observe every
        prompt token, so features that skip prefill work for cached
        context (prefix caching) are only sound when this holds."""
        return all(b in ATTENTION_KINDS for b in self.block_pattern)

    @property
    def d_inner(self) -> int:
        """Mamba2 inner channel count."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    # -- parameter census (analytical, used by roofline + docs) ---------------
    def param_count(self) -> int:
        from repro_torch.models.params import count_params_analytical
        return count_params_analytical(self)

    def active_param_count(self) -> int:
        from repro_torch.models.params import count_params_analytical
        return count_params_analytical(self, active_only=True)


# ----------------------------------------------------------------------------
_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"arch {name!r} is not yet ported to repro_torch; it serves "
            f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


# every architecture of the reference: the dense GQA and MQA configs (the
# qwen3 family, the paper's own evaluation models, §5.1/§5.3; yi-9b,
# minicpm-2b with tied embeddings, granite-20b with MQA and a gelu MLP),
# the MoE ones (granite-moe on GQA, deepseek-v2-lite on MLA), the
# recurrent ones (zamba2: Mamba2 + a shared attention block; xlstm: mLSTM
# + sLSTM) and the two frontends (paligemma: a vision prefix under the
# prefix-LM mask; musicgen: summed audio codebooks and one head each)
_ARCH_MODULES = ["qwen3_4b", "qwen3_8b", "qwen3_14b", "yi_9b", "minicpm_2b",
                 "granite_20b", "granite_moe_3b_a800m",
                 "deepseek_v2_lite_16b", "zamba2_1_2b", "xlstm_350m",
                 "paligemma_3b", "musicgen_medium"]
_loaded = False


def _ensure_loaded():
    global _loaded
    if _loaded:
        return
    import importlib
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")
    _loaded = True


# ----------------------------------------------------------------------------
def reduced(cfg: ArchConfig, *, num_layers: int = 2, d_model: int = 256,
            vocab: int = 512, max_experts: int = 4) -> ArchConfig:
    """Smoke-test variant of the same family: ≤2 layers, d_model≤512, ≤4 experts.

    Head/expert structure is scaled down proportionally so every code path of
    the family (GQA grouping, MoE routing, MLA compression, scan chunking,
    shared blocks) is still exercised.
    """
    d_model = min(d_model, cfg.d_model)
    heads = max(2, min(4, cfg.num_heads))
    # preserve the GQA ratio qualitatively
    if cfg.num_kv_heads == cfg.num_heads:
        kv = heads
    elif cfg.num_kv_heads == 1:
        kv = 1
    else:
        kv = max(1, heads // 2)
    experts = min(max_experts, cfg.num_experts) if cfg.is_moe else 0
    top_k = min(2, cfg.moe_top_k) if cfg.is_moe else 0

    # rebuild a block pattern of the right length for the family
    pat: Tuple[str, ...] = ()
    kinds = set(cfg.block_pattern)
    if kinds == {"attn"}:
        pat = ("attn",) * num_layers
    elif "mla_moe" in kinds or "mla" in kinds:
        pat = ("mla",) + ("mla_moe",) * (num_layers - 1)
    elif "attn_moe" in kinds:
        pat = ("attn_moe",) * num_layers
    elif "mamba2" in kinds and "shared_attn" in kinds:
        pat = ("mamba2", "shared_attn") * (num_layers // 2) or ("mamba2",)
    elif kinds == {"mamba2"}:
        pat = ("mamba2",) * num_layers
    elif kinds <= {"slstm", "mlstm"}:
        pat = ("mlstm", "slstm") * (num_layers // 2) or ("mlstm",)
    else:
        pat = cfg.block_pattern[:num_layers]

    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        num_layers=len(pat),
        block_pattern=pat,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=d_model // heads,
        d_ff=max(4 * 16, (cfg.d_ff * d_model // max(cfg.d_model, 1)) // 16 * 16) if cfg.d_ff else 0,
        vocab_size=vocab,
        num_experts=experts,
        num_shared_experts=min(1, cfg.num_shared_experts),
        moe_top_k=top_k,
        moe_d_ff=64 if cfg.is_moe else 0,
        first_dense_layers=0,
        kv_lora_rank=64 if cfg.kv_lora_rank else 0,
        qk_rope_dim=16 if cfg.kv_lora_rank else cfg.qk_rope_dim,
        qk_nope_dim=32 if cfg.kv_lora_rank else cfg.qk_nope_dim,
        v_head_dim=d_model // heads if cfg.kv_lora_rank else cfg.v_head_dim,
        ssm_state=min(16, cfg.ssm_state) if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else cfg.ssm_head_dim,
        num_prefix_tokens=min(8, cfg.num_prefix_tokens),
        sliding_window=64,
        shared_attn_period=2,
    )
