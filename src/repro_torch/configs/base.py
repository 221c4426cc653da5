"""Model configuration: ``ModelConfig``, its layer plan and the registry.

A copy of the parts of the JAX package's ``configs/base.py`` that the
serving slices need (the decoder's layer plan, and an enc-dec arch's
encoder plan, ``encoder_layer_specs``); field names and defaults are
unchanged so a config means the same thing on both sides.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

ATTN_FULL = "full"          # global causal (or bidirectional for encoders)
ATTN_WINDOW = "window"      # sliding-window causal
ATTN_NONE = "none"          # attention-free (pure SSM layer)

MIX_ATTN = "attn"           # plain MHSA/GQA
MIX_SSM = "ssm"             # mamba2 SSD block
MIX_HYBRID = "hybrid"       # parallel attn + ssm heads (hymba)

FFN_DENSE = "dense"         # (gated) MLP
FFN_MOE = "moe"             # mixture of experts
FFN_NONE = "none"           # no FFN (mamba2 blocks)


@dataclass(frozen=True)
class LayerSpec:
    """One transformer layer's structure."""
    mixer: str = MIX_ATTN                 # attn | ssm | hybrid
    attn: str = ATTN_FULL                 # full | window | none
    ffn: str = FFN_DENSE                  # dense | moe | none
    cross_attn: bool = False              # decoder cross-attention (enc-dec)
    d_ff: int = 0                         # dense FFN width for THIS layer

    def cache_kinds(self):
        kinds = []
        if self.mixer in (MIX_ATTN, MIX_HYBRID) and self.attn != ATTN_NONE:
            kinds.append("kv")
        if self.mixer in (MIX_SSM, MIX_HYBRID):
            kinds.append("ssm")
        if self.cross_attn:
            kinds.append("cross_kv")
        return kinds


@dataclass(frozen=True)
class LayerGroup:
    """``n_reps`` repetitions of a (short) layer pattern.  Stacked
    parameters for the group carry a leading ``n_reps`` axis."""
    n_reps: int
    pattern: tuple  # tuple[LayerSpec, ...]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | encdec | vlm | encoder
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads

    # --- attention features -------------------------------------------------
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0           # 0 -> no SWA anywhere
    local_global_ratio: int = 0       # k -> k local layers per 1 global (gemma3)
    causal: bool = True               # False for encoders
    attn_scale: Optional[float] = None

    # --- FFN / MoE ----------------------------------------------------------
    act: str = "silu"                 # silu (gated) | gelu
    gated_ffn: bool = True
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                 # per-expert intermediate size
    first_k_dense: int = 0            # deepseek: first k layers use dense FFN
    dense_ff_override: int = 0        # width of those dense layers

    # --- SSM (mamba2 / SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256              # SSD chunk length

    # --- enc-dec / frontends --------------------------------------------------
    n_enc_layers: int = 0             # >0 -> encoder-decoder
    enc_seq_len: int = 0              # fixed encoder memory length for decode shapes
    frontend: Optional[str] = None    # audio_frames | vision_patches
    n_frontend_embeds: int = 0        # patches/frames provided as precomputed embeds

    # --- misc -----------------------------------------------------------------
    sandwich_norm: bool = False       # gemma3: post-sublayer norms
    scale_embed: bool = False         # gemma3: embeddings scaled by sqrt(E)
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    max_seq_len: int = 131_072
    source: str = ""                  # provenance note

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def is_encoder_only(self) -> bool:
        return self.family == "encoder"

    def layer_specs(self) -> list:
        """Per-layer structure for the decoder stack."""
        return [self._spec_for_layer(i) for i in range(self.n_layers)]

    def _spec_for_layer(self, i: int) -> LayerSpec:
        if self.family == "ssm":
            return LayerSpec(mixer=MIX_SSM, attn=ATTN_NONE, ffn=FFN_NONE)
        if self.local_global_ratio > 0:
            k = self.local_global_ratio
            attn = ATTN_FULL if (i % (k + 1)) == k else ATTN_WINDOW
        elif self.sliding_window > 0:
            attn = ATTN_WINDOW
        else:
            attn = ATTN_FULL
        mixer = MIX_HYBRID if self.family == "hybrid" else MIX_ATTN
        if self.family == "hybrid":
            full_at = {0, self.n_layers // 2, self.n_layers - 1}
            attn = ATTN_FULL if i in full_at else ATTN_WINDOW
        if self.n_experts > 0 and i >= self.first_k_dense:
            ffn, d_ff = FFN_MOE, 0
        elif self.n_experts > 0:
            ffn, d_ff = FFN_DENSE, (self.dense_ff_override or self.d_ff)
        else:
            ffn, d_ff = FFN_DENSE, self.d_ff
        return LayerSpec(mixer=mixer, attn=attn, ffn=ffn, d_ff=d_ff,
                         cross_attn=self.is_encdec)

    def encoder_layer_specs(self) -> list:
        """Per-layer structure for the encoder stack (enc-dec archs)."""
        return [LayerSpec(mixer=MIX_ATTN, attn=ATTN_FULL, ffn=FFN_DENSE,
                          d_ff=self.d_ff, cross_attn=False)
                for _ in range(self.n_enc_layers)]

    def layer_groups(self, specs: Optional[Sequence[LayerSpec]] = None) -> list:
        """Factor the layer list into (n_reps x pattern) groups."""
        specs = list(specs if specs is not None else self.layer_specs())
        return factor_layer_groups(specs)

    def window_for(self, spec: LayerSpec) -> int:
        return self.sliding_window if spec.attn == ATTN_WINDOW else 0


def factor_layer_groups(specs) -> list:
    """Greedy periodic factoring: find the shortest repeating pattern prefix,
    emit (reps, pattern) groups; remainder becomes its own group(s)."""
    groups = []
    i = 0
    n = len(specs)
    while i < n:
        best = (1, 1)  # (period, reps)
        for period in (1, 2, 3, 4, 6, 8):
            if i + period > n:
                break
            reps = 1
            while i + (reps + 1) * period <= n and \
                    specs[i + reps * period: i + (reps + 1) * period] == specs[i: i + period]:
                reps += 1
            if reps * period > best[0] * best[1] or \
                    (reps * period == best[0] * best[1] and period < best[0]):
                best = (period, reps)
        period, reps = best
        groups.append(LayerGroup(n_reps=reps, pattern=tuple(specs[i:i + period])))
        i += period * reps
    return groups


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    assert cfg.name not in _REGISTRY, f"duplicate config {cfg.name}"
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; the PyTorch port serves "
                       f"{sorted(_REGISTRY)} so far")
    return _REGISTRY[name]


PAPER_MODELS = ["tinyllama-42m", "tinyllama-42m-64h", "mobilebert"]


def _ensure_loaded():
    if _REGISTRY:
        return
    from repro_torch.configs import (  # noqa: F401
        deepseek_moe, gemma3, hymba, mamba2_370m, mistral_large, mixtral,
        paper_models, pixtral, qwen3, seamless_m4t)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests (same rule as the JAX
    package's ``reduced``, so both sides build identical shapes)."""
    scale = dict(
        n_layers=min(cfg.n_layers, 2 + (2 if cfg.local_global_ratio else 0)),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        max_seq_len=512,
    )
    if cfg.local_global_ratio:
        scale["n_layers"] = cfg.local_global_ratio + 1
        scale["sliding_window"] = 64
    elif cfg.sliding_window:
        scale["sliding_window"] = 64
    if cfg.n_experts:
        scale.update(n_experts=min(cfg.n_experts, 8),
                     top_k=min(cfg.top_k, 2),
                     n_shared_experts=min(cfg.n_shared_experts, 1),
                     moe_d_ff=64, first_k_dense=min(cfg.first_k_dense, 1),
                     dense_ff_override=256 if cfg.first_k_dense else 0)
    if cfg.ssm_state:
        scale.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
    if cfg.is_encdec:
        scale.update(n_enc_layers=2, enc_seq_len=64)
    if cfg.n_frontend_embeds:
        scale.update(n_frontend_embeds=16)
    if cfg.family == "hybrid":
        scale.update(n_layers=4)
    scale.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **scale)
