"""Decoder parameters and forward passes over the contiguous or the paged
cache.

Port of the JAX package's ``core/model.py`` for dense attention-only
decoders and pure-SSM (mamba2) decoders at tp=1.  The parameter tree has
the JAX tree's paths, with the tp axis stripped (what the JAX package's
``blocks._lo`` returns) and the stacked ``reps`` axis kept:

    {"embed": {"table": (V, E)},
     "stacks": [[layer tree per pattern entry] per layer group],
     "final_norm": {"scale": (E,)}}

with, per layer, ``ln1`` ``{"scale": (reps, E)}`` and either

- attention layers: ``attn`` ``{"wq": (reps, E, H, D), "wk"/"wv": (reps,
  E, n_kv_loc, D), "wo": (reps, H, D, E)}``, ``ln2`` and ``ffn``
  ``{"w_gate"/"w_up": (reps, E, F), "w_down": (reps, F, E)}``, or
- SSM layers: ``ssm`` ``{"in_z"/"in_x": (reps, E, H, P), "in_dt": (reps, E,
  H), "in_B"/"in_C": (reps, E, N), "conv_x": (reps, H, P, K),
  "conv_B"/"conv_C": (reps, N, K), "A_log"/"D"/"dt_bias": (reps, H),
  "norm_scale": (reps, H * P), "out": (reps, H, P, E)}`` (no FFN).

``A_log`` and ``dt_bias`` stay float32 whatever the weight dtype, as in
JAX.  ``_run_stack`` loops over ``reps`` in Python where JAX scans, and
carries the residual stream as (x, pending delta) so that every residual
add runs inside the norm after it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn

from repro_torch.configs.base import (FFN_DENSE, FFN_MOE, MIX_ATTN,
                                     MIX_HYBRID, MIX_SSM, ModelConfig)
from repro_torch.core.blocks import layer_forward
from repro_torch.core.device import resolve_device
from repro_torch.core.layers import apply_norm, embed, logits
from repro_torch.core.partition import ShardingPlan, model_layout, torch_dtype


@dataclass(frozen=True)
class ParamSpec:
    full: tuple                # canonical shape (JAX's ``ParamSpec.full``)
    init: str = "normal"       # normal | zeros | ones | a_log | dt_bias
    scale: float = 0.02
    kv_heads: bool = False     # gathered through the head layout's kv_map


def check_supported(cfg: ModelConfig):
    """The port serves dense attention-only decoders with RMSNorm, a gated
    SiLU FFN and tied embeddings, and pure-SSM (mamba2) decoders; the rest
    waits for its slice."""
    specs = cfg.layer_specs()
    missing = [name for name, bad in (
        ("qk_norm", cfg.qk_norm), ("sandwich_norm", cfg.sandwich_norm),
        ("scale_embed", cfg.scale_embed), ("layernorm", cfg.norm != "rmsnorm"),
        ("untied LM head", not cfg.tie_embeddings),
        ("a plain (ungated) or non-silu FFN",
         not cfg.gated_ffn or cfg.act != "silu"),
        ("encoder-decoder (ROADMAP Queue 1 item 11)", cfg.is_encdec),
        ("frontend", cfg.frontend),
        ("hybrid attention + SSM layers (hymba-1.5b, ROADMAP Queue 1 item "
         "10)", any(s.mixer == MIX_HYBRID for s in specs)),
        ("MoE layers (ROADMAP Queue 1 item 12)",
         any(s.ffn == FFN_MOE for s in specs))) if bad]
    if missing:
        raise NotImplementedError(
            f"arch '{cfg.name}' needs {', '.join(missing)}, which the PyTorch "
            f"port does not serve yet (ROADMAP Queue 1)")


def _ssm_template(cfg, out_scale):
    """JAX's ``_ssm_t`` at tp=1: ``norm_scale`` is stored flat, (H * P,), as
    the JAX package's ``ssm_flat_heads`` sharding leaves it."""
    E, Pd, N, K = cfg.d_model, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv
    H = cfg.ssm_expand * E // Pd
    return {
        "in_z": ParamSpec((E, H, Pd)),
        "in_x": ParamSpec((E, H, Pd)),
        "in_dt": ParamSpec((E, H)),
        "in_B": ParamSpec((E, N)),
        "in_C": ParamSpec((E, N)),
        "conv_x": ParamSpec((H, Pd, K), scale=0.2),
        "conv_B": ParamSpec((N, K), scale=0.2),
        "conv_C": ParamSpec((N, K), scale=0.2),
        "A_log": ParamSpec((H,), "a_log"),
        "D": ParamSpec((H,), "ones"),
        "dt_bias": ParamSpec((H,), "dt_bias"),
        "norm_scale": ParamSpec((H * Pd,), "zeros"),
        "out": ParamSpec((H, Pd, E), scale=out_scale),
    }


def layer_template(cfg, spec, n_layers_total):
    E, d = cfg.d_model, cfg.head_dim_
    out_scale = 0.02 / math.sqrt(2 * n_layers_total)
    t = {"ln1": {"scale": ParamSpec((E,), "zeros")}}
    if spec.mixer == MIX_ATTN:
        t["attn"] = {"wq": ParamSpec((E, cfg.n_heads, d)),
                     "wk": ParamSpec((E, cfg.n_kv_heads, d), kv_heads=True),
                     "wv": ParamSpec((E, cfg.n_kv_heads, d), kv_heads=True),
                     "wo": ParamSpec((cfg.n_heads, d, E), scale=out_scale)}
    elif spec.mixer == MIX_SSM:
        t["ssm"] = _ssm_template(cfg, out_scale)
    if spec.ffn == FFN_DENSE:
        t["ln2"] = {"scale": ParamSpec((E,), "zeros")}
        t["ffn"] = {"w_up": ParamSpec((E, spec.d_ff)),
                    "w_down": ParamSpec((spec.d_ff, E), scale=out_scale),
                    "w_gate": ParamSpec((E, spec.d_ff))}
    return t


def model_template(cfg: ModelConfig):
    """The parameter tree of ``ParamSpec`` leaves, in the JAX package's
    leaf order (which fixes the order of random draws)."""
    check_supported(cfg)
    return {
        "embed": {"table": ParamSpec((cfg.vocab_size, cfg.d_model))},
        "stacks": [[layer_template(cfg, s, cfg.n_layers) for s in g.pattern]
                   for g in cfg.layer_groups()],
        "final_norm": {"scale": ParamSpec((cfg.d_model,), "zeros")},
    }


def map_template(cfg, fn):
    """Map ``fn(spec, reps)`` over the template; ``reps`` is the group's
    repetition count inside ``stacks`` and 0 elsewhere."""
    def walk(node, reps):
        if isinstance(node, ParamSpec):
            return fn(node, reps)
        return {k: walk(v, reps) for k, v in node.items()}

    tmpl = model_template(cfg)
    out = {}
    for key, val in tmpl.items():
        if key == "stacks":
            out[key] = [[walk(pt, g.n_reps) for pt in sub]
                        for g, sub in zip(cfg.layer_groups(), val, strict=True)]
        else:
            out[key] = walk(val, 0)
    return out


def _deterministic_init(spec):
    """JAX's ``_init_full`` for the leaves that draw nothing: ``ones``, and
    the SSD heads' decay and step-size grids (``A_log = log(linspace(1,
    16))``; ``dt_bias`` the inverse softplus of dt log-spaced over [1e-3,
    0.1]).  Computed in float64 and rounded once to float32, which is
    within float32 rounding of JAX's values (XLA's fused ``linspace`` and
    its own exp/log round differently from every other implementation)."""
    n = spec.full[0]
    if spec.init == "ones":
        return torch.ones(spec.full)
    if spec.init == "a_log":
        v = np.log(np.linspace(1.0, 16.0, n))
    else:
        dts = np.exp(np.linspace(math.log(1e-3), math.log(0.1), n))
        v = np.log(np.expm1(dts))
    return torch.from_numpy(v.astype(np.float32))


def init_params(cfg, plan: ShardingPlan, generator=None, device="cuda",
                dtype=None):
    """Scaled-normal init with the JAX package's scheme (``model.py``:
    ``scale * normal`` per leaf, zeros for norm scales, wo/w_down/out scaled
    by ``0.02 / sqrt(2 * n_layers)``, the SSD heads' ``A_log``/``D``/
    ``dt_bias`` deterministic), one draw per random leaf and repetition
    from ``generator`` (a CPU ``torch.Generator``; seed 0 when None).  The
    draws are made on the CPU, so one seed gives the same weights on every
    device.  The numbers differ from JAX's (another generator): tests that
    compare with JAX load JAX's weights through ``bridge.params_from_jax``."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype or plan.weight_dtype or cfg.dtype)
    if not dt.is_floating_point:
        raise NotImplementedError(
            f"{dt} weights (the JAX package's W8_SCALE int8 weights) are not "
            f"ported yet: the port stores float weights")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    kv_map = torch.tensor(model_layout(cfg, plan).attn.kv_map)

    def one(spec):
        if spec.init == "zeros":
            full = torch.zeros(spec.full)
        elif spec.init == "normal":
            full = spec.scale * torch.randn(spec.full, generator=generator)
        else:
            full = _deterministic_init(spec)
        if spec.kv_heads:
            full = full.index_select(1, kv_map)
        return full

    def mk(spec, reps):
        t = torch.stack([one(spec) for _ in range(reps)]) if reps else one(spec)
        keep_f32 = spec.init in ("a_log", "dt_bias")
        return t.to(device=dev, dtype=torch.float32 if keep_f32 else dt)

    return map_template(cfg, mk)


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_paths(tree, prefix=""):
    """(path, leaf) pairs; path segments joined by '.' ("stacks.0.0.attn.wq")."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    return [pl for k, v in items
            for pl in tree_paths(v, f"{prefix}.{k}" if prefix else str(k))]


class Decoder(nn.Module):
    """The model as a module: each leaf is a frozen ``nn.Parameter``
    registered under its tree path ('.' -> '__'), so ``state_dict``,
    ``parameters()`` and ``.to()`` work on the model as a module.  The
    forward functions take the plain tree, ``Decoder.tree()``, whose leaves
    are these same parameters."""

    def __init__(self, params):
        super().__init__()
        self._tree = tree_map(lambda t: nn.Parameter(t, requires_grad=False),
                              params)
        for path, leaf in tree_paths(self._tree):
            self.register_parameter(path.replace(".", "__"), leaf)

    def tree(self):
        return self._tree


def _run_stack(x, stack_params, groups, cfg, plan, lay, mode, positions,
               pos=None, cache=None, pages=None):
    """Every layer group, each repetition in turn; the pools in ``cache``
    (aligned with ``groups``) are updated in place.  The residual stream
    is carried as a pair (x, pending delta), each add fused into the norm
    after it (``layer_forward``) -> ((x, delta), cache): the stack's output
    is ``x + delta``, which the caller folds into the final norm
    (``final_norm``)."""
    delta = None
    for group, gparams, gcache in zip(groups, stack_params, cache, strict=True):
        for r in range(group.n_reps):
            for pi, spec in enumerate(group.pattern):
                p_rep = tree_map(lambda a, r=r: a[r], gparams[pi])
                c_rep = tree_map(lambda a, r=r: a[r], gcache[pi])
                (x, delta), _ = layer_forward(x, p_rep, c_rep, cfg, plan,
                                              lay, spec, mode, positions,
                                              pos, pages, delta)
    return (x, delta), cache


def final_norm(params, x, delta, cfg):
    """The final norm of the stack's output ``x + delta``, the last
    residual add fused into it."""
    return apply_norm(x, params["final_norm"], cfg, delta)[1]


def embed_tokens(params, tokens):
    return embed(tokens, params["embed"]["table"])


def final_logits(params, x):
    """Tied LM head: x @ table^T, reading the table as stored."""
    return logits(x, params["embed"]["table"])


def forward_prefill(params, tokens, cache, cfg, plan, lay):
    """Prefill a whole prompt into a contiguous cache (JAX
    ``forward_prefill`` for token decoders, without context parallelism).
    tokens: (B, S); cache: lanes of ``kvcache.cache_template`` with a ring
    of at least S, filled in place -> (logits of the last position (B, V),
    cache)."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device,
                             dtype=torch.int32).expand(B, S)
    x = embed_tokens(params, tokens)
    (x, delta), cache = _run_stack(x, params["stacks"], cfg.layer_groups(),
                                   cfg, plan, lay, "prefill", positions,
                                   cache=cache)
    x = final_norm(params, x[:, -1:], delta[:, -1:], cfg)
    return final_logits(params, x)[:, 0], cache


def forward_decode(params, cache, tokens, pos, cfg, plan, lay, pages=None):
    """One decode step over contiguous lanes (``pages`` None) or the page
    pools.  tokens: (B, 1); pos: (B,) -> (logits (B, V), cache)."""
    positions = pos[:, None]
    x = embed_tokens(params, tokens)
    (x, delta), cache = _run_stack(x, params["stacks"], cfg.layer_groups(),
                                   cfg, plan, lay, "decode", positions,
                                   pos=pos, cache=cache, pages=pages)
    x = final_norm(params, x, delta, cfg)
    return final_logits(params, x)[:, 0], cache


def forward_verify(params, cache, tokens, pos, qlen, cfg, plan, lay, pages):
    """Speculative verify: score Q consecutive positions per slot at once.

    tokens: (B, Q) — column 0 is the slot's last accepted token, columns
    1..Q-1 are drafted continuations; pos: (B,) absolute position of
    column 0; qlen: (B,) live columns per row (columns at or past qlen are
    padding: their position is -1, so their KV lands on the scratch page
    and their logits are garbage the caller ignores).  -> (logits (B, Q,
    V), cache): row i is the next-token distribution after tokens[:, :i+1],
    as feeding them to ``forward_decode`` one at a time would give."""
    B, Q = tokens.shape
    cols = torch.arange(Q, device=tokens.device, dtype=torch.int32)
    positions = torch.where(cols[None, :] < qlen[:, None],
                            pos[:, None] + cols[None, :],
                            torch.full_like(cols, -1)[None, :])
    x = embed_tokens(params, tokens)
    (x, delta), cache = _run_stack(x, params["stacks"], cfg.layer_groups(),
                                   cfg, plan, lay, "verify", positions,
                                   pos=pos, cache=cache, pages=pages)
    x = final_norm(params, x, delta, cfg)
    return final_logits(params, x), cache


def forward_prefill_chunk(params, cache, tokens, chunk_start, last_idx, cfg,
                          plan, lay, pages):
    """One fixed-size prefill chunk against the paged cache.

    tokens: (B, C) chunk of the prompt (zero-padded past its end);
    chunk_start: (1,) int32 tensor, absolute position of the chunk's first
    token; last_idx: (1,) int32 tensor, in-chunk index of the prompt's
    final token (callers use the logits only on the chunk that holds it;
    SSM layers also mask the recurrence past it and cut their conv tails
    there).  Both are device data, as JAX's traced scalars are: nothing
    here reads them on the host, so a CUDA graph of the step serves every
    chunk.  -> (logits (B, V), cache).  Prompt lengths reach this function
    only as data, never as shapes."""
    B, C = tokens.shape
    positions = chunk_start.reshape(1, 1) + torch.arange(
        C, device=tokens.device, dtype=torch.int32).expand(B, C)
    pages = {**pages, "chunk_start": chunk_start, "last_idx": last_idx}
    x = embed_tokens(params, tokens)
    (x, delta), cache = _run_stack(x, params["stacks"], cfg.layer_groups(),
                                   cfg, plan, lay, "prefill", positions,
                                   cache=cache, pages=pages)
    keep = last_idx.reshape(1).long()
    x = final_norm(params, x.index_select(1, keep), delta.index_select(1, keep),
                   cfg)
    return final_logits(params, x)[:, 0], cache
