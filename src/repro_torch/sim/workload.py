"""Per-chip workload extraction for the paper's partitioning (§IV).

Given a ModelConfig + inference mode, produce what ONE chip of an n-chip
system executes for ONE transformer block: MACs, weight bytes (int8,
head/F-sliced, zero duplication), activation traffic, KV-cache traffic and
the two synchronization payloads.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig

INT8 = 1
ACC = 4        # int32 accumulators / fp32 intermediates


@dataclass(frozen=True)
class BlockWorkload:
    macs_per_chip: float            # MAC count (per token step or per prompt)
    w_bytes_per_chip: float         # resident weight bytes (this block)
    act_bytes_per_chip: float       # L2 activation traffic
    kv_bytes_per_chip: float        # KV cache read+write traffic
    sync_payload_bytes: float       # per-sync partial output (S*E)
    n_syncs: int                    # 2 (paper §IV)
    min_rows_per_core: float        # smallest per-core tile (efficiency)


def tinyllama_block(cfg: ModelConfig, mode: str, n_chips: int,
                    n_cores: int = 8) -> BlockWorkload:
    """Decoder block under the paper's partitioning.

    mode: 'autoregressive' (1 token vs KV cache of S) | 'prompt' (S tokens).
    FFN uses the paper's two-matrix description (E x F, F x E).
    """
    E, F, H = cfg.d_model, cfg.d_ff, cfg.n_heads
    S_ctx = 128 if mode == "autoregressive" else 16
    s_new = 1 if mode == "autoregressive" else S_ctx
    P = cfg.head_dim_

    h_loc = max(1, H // n_chips)
    # weights per chip (int8, never duplicated)
    w_attn = (3 * E * P * H + H * P * E) / n_chips       # Wq,Wk,Wv,Wo slices
    w_ffn = (E * F + F * E) / n_chips                    # W_L1, W_L2 slices
    w_bytes = (w_attn + w_ffn) * INT8

    # MACs per chip
    proj = (4 * E * P * H) / n_chips * s_new
    attn = 2 * (h_loc * P) * S_ctx * s_new               # QK^T + AV local heads
    ffn = (2 * E * F) / n_chips * s_new
    macs = proj + attn + ffn

    act = 6 * s_new * E * INT8 + 2 * s_new * (F / n_chips) * INT8
    kv = 2 * h_loc * P * S_ctx * INT8 + 2 * h_loc * P * s_new * INT8

    sync_payload = s_new * E * ACC                       # partial sums int32
    rows = min((F / n_chips) / n_cores, (H * P / n_chips) / n_cores)
    return BlockWorkload(macs, w_bytes, act, kv, sync_payload, 2, max(rows, 1))


def mobilebert_block(cfg: ModelConfig, n_chips: int,
                     n_cores: int = 8) -> BlockWorkload:
    """Encoder block, S=268 bidirectional (no KV cache, prompt-like)."""
    E, F, H = cfg.d_model, cfg.d_ff, cfg.n_heads
    S = 268
    P = cfg.head_dim_
    h_loc = max(1, H // n_chips)
    w_bytes = ((4 * E * P * H) / n_chips + (2 * E * F) / n_chips) * INT8
    proj = (4 * E * P * H) / n_chips * S
    attn = 2 * (h_loc * P) * S * S
    ffn = (2 * E * F) / n_chips * S
    act = 6 * S * E * INT8 + 2 * S * (F / n_chips) * INT8
    sync_payload = S * E * ACC
    rows = min((F / n_chips) / n_cores, (H * P / n_chips) / n_cores)
    return BlockWorkload(proj + attn + ffn, w_bytes, act, 0.0, sync_payload,
                         2, max(rows, 1))
