"""Layout of the model on one device: the tp=1 part of the JAX package's
``core/partition.py``.

``ShardingPlan`` keeps the storage choices the paged-serving slices read
(KV pool dtype: float, or int8 with per-row scales; SSM slab dtype: float32,
or int8 with per-(slab, head) scales; weight dtype: float only);
``head_layout`` keeps the grouped-query head layout that
``blocks._group_q`` uses, computed for tp=1, and ``ModelLayout.ssm`` the
SSD heads' (one state per head, no grouping).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name -> torch dtype."""
    if name not in _DTYPES:
        raise NotImplementedError(
            f"dtype '{name}' is not ported; have {sorted(_DTYPES)}")
    return _DTYPES[name]


def kv_pool_is_quantized(plan) -> bool:
    """True when the paged KV pools store int8 payloads with per-(page,
    row) float32 scales (``plan.kv_cache_dtype == "int8"``)."""
    return torch_dtype(plan.kv_cache_dtype) == torch.int8


def ssm_pool_is_quantized(plan) -> bool:
    """True when the SSM state slabs store int8 payloads with per-(slab,
    head) float32 scales (``plan.ssm_cache_dtype == "int8"``)."""
    return bool(plan.ssm_cache_dtype) and \
        torch_dtype(plan.ssm_cache_dtype) == torch.int8


@dataclass(frozen=True)
class ShardingPlan:
    """Storage choices of a one-device deployment."""
    kv_cache_dtype: str = "bfloat16"  # page-pool dtype ("int8": quantized)
    ssm_cache_dtype: str = ""         # "" -> float32 slabs; "int8": quantized
    weight_dtype: str = ""            # "" -> cfg.dtype


@dataclass(frozen=True)
class HeadLayout:
    n_q: int                 # q heads
    n_kv: int                # kv heads
    hq_loc: int              # q heads on this device (all of them at tp=1)
    r: int                   # q heads per kv slot
    n_kv_loc: int            # kv slots on this device
    kv_map: tuple            # kv head held by each slot


def head_layout(n_q: int, n_kv: int) -> HeadLayout:
    """Grouped-query layout at tp=1, by the JAX package's rule: the largest
    r in n_q, n_q // 2, n_q // 4, ... such that every run of r consecutive
    q heads shares one kv head; each of the n_q // r slots holds that kv
    head (a kv head is repeated when r comes out below the group size)."""
    assert n_q % n_kv == 0, (n_q, n_kv)
    group = n_q // n_kv
    r = n_q
    while r > 1 and not all(len({(s * r + j) // group for j in range(r)}) == 1
                            for s in range(n_q // r)):
        r //= 2
    n_kv_loc = n_q // r
    return HeadLayout(n_q=n_q, n_kv=n_kv, hq_loc=n_q, r=r, n_kv_loc=n_kv_loc,
                      kv_map=tuple(s * r // group for s in range(n_kv_loc)))


@dataclass(frozen=True)
class ModelLayout:
    attn: HeadLayout
    ssm: Optional[HeadLayout]        # SSD heads (configs with ssm_state)


def model_layout(cfg: ModelConfig, plan: ShardingPlan) -> ModelLayout:
    ssm = None
    if cfg.ssm_state:
        n_ssm_heads = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
        ssm = head_layout(n_ssm_heads, n_ssm_heads)
    return ModelLayout(attn=head_layout(cfg.n_heads, cfg.n_kv_heads), ssm=ssm)
