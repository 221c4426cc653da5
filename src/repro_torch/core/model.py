"""Model parameters and forward passes over the contiguous or the paged
cache.

Port of the JAX package's ``core/model.py`` for dense attention-only
decoders (with gemma3's sandwich norms, scaled embedding and gelu FFN,
and mistral's untied LM head), pure-SSM (mamba2) decoders, hybrid (hymba)
decoders and encoder-decoders (seamless: layernorm, a plain gelu FFN, the
encoder and cross-attention) at tp=1.  The parameter tree has the JAX
tree's paths, with the tp axis stripped (what the JAX package's
``blocks._lo`` returns) and the stacked ``reps`` axis kept:

    {"embed": {"table": (V, E)},
     "stacks": [[layer tree per pattern entry] per layer group],
     "final_norm": {"scale": (E,)},
     "lm_head": {"w": (V, E)},          # untied heads only (mistral)
     "encoder": {"stacks": [[...]], "final_norm": {...}}}   # enc-dec only

with, per layer, ``ln1`` ``{"scale": (reps, E)}`` (layernorm: also
``"bias"``, and the scale initialised to ones) and

- attention layers: ``attn`` ``{"wq": (reps, E, H, D), "wk"/"wv": (reps,
  E, n_kv_loc, D), "wo": (reps, H, D, E)}`` (with qk-norm also
  ``"q_norm"``/``"k_norm"``: (reps, D)), ``ln2`` and ``ffn``
  ``{"w_up": (reps, E, F), "w_down": (reps, F, E)}``, gated FFNs also
  ``"w_gate"`` (with sandwich norms also ``post_ln1`` and ``post_ln2``,
  ``{"scale": (reps, E)}``), and an enc-dec decoder's ``ln_x`` and
  ``xattn`` (the attention tree) between them, or
- SSM layers: ``ssm`` ``{"in_z"/"in_x": (reps, E, H, P), "in_dt": (reps, E,
  H), "in_B"/"in_C": (reps, E, N), "conv_x": (reps, H, P, K),
  "conv_B"/"conv_C": (reps, N, K), "A_log"/"D"/"dt_bias": (reps, H),
  "norm_scale": (reps, H * P), "out": (reps, H, P, E)}`` (no FFN), or
- hybrid layers: both ``attn`` and ``ssm``, in that order, then ``ln2``
  and ``ffn``.

``A_log`` and ``dt_bias`` stay float32 whatever the weight dtype, as in
JAX.  ``_run_stack`` loops over ``reps`` in Python where JAX scans, and
carries the residual stream as (x, pending delta) so that every residual
add runs inside the norm after it.  The encoder (``encode``) runs JAX's
``"train"`` mode over the frames: causal flash attention with ``cfg.causal``
(True for seamless, as JAX computes it), RoPE over ``arange(S_enc)``, no
cache.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn

from repro_torch.configs.base import (FFN_DENSE, FFN_MOE, MIX_ATTN,
                                     MIX_HYBRID, MIX_SSM, ModelConfig)
from repro_torch.core.blocks import cross_kv, layer_forward
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
    """The port serves dense attention-only decoders (GQA, optional
    qk-norm, sliding windows, sandwich norms, a scaled embedding) with
    RMSNorm or layernorm, a gated or plain SiLU or gelu FFN and a tied or
    untied LM head, pure-SSM (mamba2) decoders, hybrid attention + SSM
    decoders (hymba) and encoder-decoders over precomputed audio frames
    (seamless); the rest waits for its slice.  A vision frontend (pixtral)
    is refused for JAX's reason (``core/kvcache.py::
    paged_cache_supported``): its image embeds need injection at prefill,
    which token-only prompts cannot carry.  An encoder (mobilebert, the
    paper's other workload, registered for the sim) is refused for JAX's
    reason too (``paged_cache_supported``): it has no decode path."""
    if cfg.is_encoder_only:
        raise ValueError(f"serving unsupported for arch '{cfg.name}': "
                         f"encoder-only arch has no decode path to serve")
    specs = cfg.layer_specs()
    missing = [name for name, bad in (
        ("a norm other than rmsnorm or layernorm",
         cfg.norm not in ("rmsnorm", "layernorm")),
        ("an FFN activation other than silu or gelu",
         cfg.act not in ("silu", "gelu")),
        ("a vision frontend, whose image embeds need injection at prefill: "
         "the token-only chunked prefill step cannot carry them (ROADMAP "
         "Queue 1 items 5 and 13)", cfg.frontend == "vision_patches"),
        ("a frontend other than an enc-dec arch's audio frames",
         cfg.frontend not in (None, "vision_patches") and
         not (cfg.frontend == "audio_frames" and cfg.is_encdec)),
        ("MoE layers (ROADMAP Queue 1 item 10)",
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


def _norm_template(cfg):
    """JAX's ``_norm_t``: RMSNorm's ``(1 + scale)`` starts at zeros;
    layernorm's scale at ones, with a zero ``bias``."""
    E = cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": ParamSpec((E,), "ones"),
                "bias": ParamSpec((E,), "zeros")}
    return {"scale": ParamSpec((E,), "zeros")}


def _attn_template(cfg, out_scale):
    """JAX's ``_attn_t``: self-attention's and cross-attention's weights."""
    E, d = cfg.d_model, cfg.head_dim_
    t = {"wq": ParamSpec((E, cfg.n_heads, d)),
         "wk": ParamSpec((E, cfg.n_kv_heads, d), kv_heads=True),
         "wv": ParamSpec((E, cfg.n_kv_heads, d), kv_heads=True),
         "wo": ParamSpec((cfg.n_heads, d, E), scale=out_scale)}
    if cfg.qk_norm:
        t["q_norm"] = ParamSpec((d,), "zeros")
        t["k_norm"] = ParamSpec((d,), "zeros")
    return t


def layer_template(cfg, spec, n_layers_total):
    E = cfg.d_model
    out_scale = 0.02 / math.sqrt(2 * n_layers_total)
    t = {"ln1": _norm_template(cfg)}
    if spec.mixer in (MIX_ATTN, MIX_HYBRID):
        t["attn"] = _attn_template(cfg, out_scale)
    if spec.mixer in (MIX_SSM, MIX_HYBRID):
        t["ssm"] = _ssm_template(cfg, out_scale)
    if cfg.sandwich_norm:
        t["post_ln1"] = _norm_template(cfg)
    if spec.cross_attn:
        t["ln_x"] = _norm_template(cfg)
        t["xattn"] = _attn_template(cfg, out_scale)
    if spec.ffn == FFN_DENSE:
        t["ln2"] = _norm_template(cfg)
        t["ffn"] = {"w_up": ParamSpec((E, spec.d_ff)),
                    "w_down": ParamSpec((spec.d_ff, E), scale=out_scale)}
        if cfg.gated_ffn:
            t["ffn"]["w_gate"] = ParamSpec((E, spec.d_ff))
        if cfg.sandwich_norm:
            t["post_ln2"] = _norm_template(cfg)
    return t


def model_template(cfg: ModelConfig):
    """The parameter tree of ``ParamSpec`` leaves, in the JAX package's
    leaf order (which fixes the order of random draws).  The out
    projections' init scale counts the encoder's layers too, as JAX's."""
    check_supported(cfg)
    nl = cfg.n_layers + cfg.n_enc_layers
    t = {
        "embed": {"table": ParamSpec((cfg.vocab_size, cfg.d_model))},
        "stacks": [[layer_template(cfg, s, nl) for s in g.pattern]
                   for g in cfg.layer_groups()],
        "final_norm": _norm_template(cfg),
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = {"w": ParamSpec((cfg.vocab_size, cfg.d_model))}
    if cfg.is_encdec:
        t["encoder"] = {
            "stacks": [[layer_template(cfg, s, nl) for s in g.pattern]
                       for g in cfg.layer_groups(cfg.encoder_layer_specs())],
            "final_norm": _norm_template(cfg),
        }
    return t


def map_template(cfg, fn):
    """Map ``fn(spec, reps)`` over the template; ``reps`` is the group's
    repetition count inside ``stacks`` (the decoder's and the encoder's)
    and 0 elsewhere."""
    def walk(node, reps):
        if isinstance(node, ParamSpec):
            return fn(node, reps)
        return {k: walk(v, reps) for k, v in node.items()}

    def stacks(groups, val):
        return [[walk(pt, g.n_reps) for pt in sub]
                for g, sub in zip(groups, val, strict=True)]

    tmpl = model_template(cfg)
    out = {}
    for key, val in tmpl.items():
        if key == "stacks":
            out[key] = stacks(cfg.layer_groups(), val)
        elif key == "encoder":
            out[key] = {"stacks": stacks(
                cfg.layer_groups(cfg.encoder_layer_specs()), val["stacks"]),
                "final_norm": walk(val["final_norm"], 0)}
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
    ``dt_bias`` deterministic), one float32 draw per random leaf and
    repetition from ``generator`` (seed 0 on the CPU when None), each
    written into its leaf in the weight dtype as it is drawn.  A CPU
    generator draws on the CPU, so one seed gives the same weights on
    every device; a CUDA generator (``torch.Generator(device="cuda")``)
    draws on the card, the same scheme with other numbers, which is what
    full-width models need (gemma3-12b's 11.8 B draws).  The numbers differ
    from JAX's (another generator): tests that compare with JAX load JAX's
    weights through ``bridge.params_from_jax``."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype or plan.weight_dtype or cfg.dtype)
    if not dt.is_floating_point:
        raise NotImplementedError(
            f"{dt} weights (the JAX package's W8_SCALE int8 weights) are not "
            f"ported yet: the port stores float weights")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    gdev = generator.device
    kv_map = torch.tensor(model_layout(cfg, plan).attn.kv_map, device=gdev)

    def one(spec):
        if spec.init == "zeros":
            full = torch.zeros(spec.full, device=gdev)
        elif spec.init == "normal":
            full = spec.scale * torch.randn(spec.full, generator=generator,
                                            device=gdev)
        else:
            full = _deterministic_init(spec)
        if spec.kv_heads:
            full = full.index_select(1, kv_map.to(full.device))
        return full

    def mk(spec, reps):
        keep_f32 = spec.init in ("a_log", "dt_bias")
        out_dt = torch.float32 if keep_f32 else dt
        if not reps:
            return one(spec).to(device=dev, dtype=out_dt)
        first = one(spec)
        t = torch.empty((reps,) + tuple(first.shape), dtype=out_dt,
                        device=dev)
        t[0] = first
        for r in range(1, reps):
            t[r] = one(spec)
        return t

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
               pos=None, cache=None, pages=None, enc_memory=None):
    """Every layer group, each repetition in turn; the pools in ``cache``
    (aligned with ``groups``; None for the encoder, which keeps no cache)
    are updated in place.  ``enc_memory`` (B, S_enc, E) is what an enc-dec
    decoder's cross-attention projects in a whole-prompt prefill.  The
    residual stream is carried as a pair (x, pending delta), each add
    fused into the norm after it (``layer_forward``) -> ((x, delta),
    cache): the stack's output is ``x + delta``, which the caller folds
    into the final norm (``final_norm``)."""
    delta = None
    if cache is None:
        cache = [[{} for _ in g.pattern] for g in groups]
    for group, gparams, gcache in zip(groups, stack_params, cache, strict=True):
        for r in range(group.n_reps):
            for pi, spec in enumerate(group.pattern):
                p_rep = tree_map(lambda a, r=r: a[r], gparams[pi])
                c_rep = tree_map(lambda a, r=r: a[r], gcache[pi])
                (x, delta), _ = layer_forward(x, p_rep, c_rep, cfg, plan,
                                              lay, spec, mode, positions,
                                              pos, pages, delta, enc_memory)
    return (x, delta), cache


def final_norm(params, x, delta, cfg):
    """The final norm of the stack's output ``x + delta``, the last
    residual add fused into it."""
    return apply_norm(x, params["final_norm"], cfg, delta)[1]


def embed_tokens(params, tokens, cfg):
    """The token embeddings, times sqrt(d_model) rounded to the table's
    dtype when the config scales them (gemma3), as JAX's ``embed_tokens``."""
    return embed(tokens, params["embed"]["table"],
                 math.sqrt(cfg.d_model) if cfg.scale_embed else 0.0)


def final_logits(params, x):
    """The LM head, x @ head^T, reading the head as stored: the untied
    ``lm_head.w`` (V, E) when the model has one, else the embedding table
    (JAX's ``final_logits``)."""
    head = params["lm_head"]["w"] if "lm_head" in params else \
        params["embed"]["table"]
    return logits(x, head)


def encode(params, frames, cfg, plan, lay):
    """The encoder stack over precomputed frame embeddings (the audio
    stub), in JAX's ``"train"`` mode: flash attention with ``cfg.causal``
    over every frame, RoPE over ``arange(S_enc)``, no cache; then the
    encoder's final norm.  frames: (B, S_enc, E) in the weights' dtype ->
    the encoder memory (B, S_enc, E)."""
    B, S = frames.shape[:2]
    positions = torch.arange(S, device=frames.device,
                             dtype=torch.int32).expand(B, S)
    enc = params["encoder"]
    (x, delta), _ = _run_stack(frames, enc["stacks"],
                               cfg.layer_groups(cfg.encoder_layer_specs()),
                               cfg, plan, lay, "train", positions)
    return apply_norm(x, enc["final_norm"], cfg, delta)[1]


def forward_cross_kv(params, enc_memory, cfg, plan, lay):
    """Every cross-attention layer's K/V of the encoder memory -> a list
    aligned with ``cfg.layer_groups()``: per group, per pattern entry,
    None (no cross-attention) or ``{"k", "v"}`` of shape (reps, B, G,
    S_enc, D), the grouped layout ``blocks.cross_attn_mixer`` attends over
    (JAX's ``forward_cross_kv``).  The paged engine scatters these into
    the cross pools once per encode (``steps.make_cross_kv_write_step``)."""
    out = []
    for group, gparams in zip(cfg.layer_groups(), params["stacks"],
                              strict=True):
        per_pat = []
        for pi, spec in enumerate(group.pattern):
            if not spec.cross_attn:
                per_pat.append(None)
                continue
            kvs = [cross_kv(enc_memory,
                            tree_map(lambda a, r=r: a[r],
                                     gparams[pi]["xattn"]), cfg)
                   for r in range(group.n_reps)]
            per_pat.append({"k": torch.stack([k for k, _ in kvs]),
                            "v": torch.stack([v for _, v in kvs])})
        out.append(per_pat)
    return out


def frames_dtype(params):
    """The dtype an enc-dec model takes its frames in: the weights', which
    is ``cfg.dtype`` unless the caller chose another (JAX casts frames to
    ``cfg.dtype`` before ``encode``)."""
    return params["embed"]["table"].dtype


def forward_prefill(params, tokens, cache, cfg, plan, lay, frames=None):
    """Prefill a whole prompt into a contiguous cache (JAX
    ``forward_prefill`` for token decoders and enc-decs, without context
    parallelism).  tokens: (B, S); cache: lanes of
    ``kvcache.cache_template`` with a ring of at least S, filled in place;
    ``frames`` (B, S_enc, E), an enc-dec arch's encoder input (cast to the
    weights' dtype, encoded, and projected into every layer's cross lane)
    -> (logits of the last position (B, V), cache)."""
    B, S = tokens.shape
    enc_memory = None
    if cfg.is_encdec:
        enc_memory = encode(params, frames.to(frames_dtype(params)), cfg,
                            plan, lay)
    positions = torch.arange(S, device=tokens.device,
                             dtype=torch.int32).expand(B, S)
    x = embed_tokens(params, tokens, cfg)
    (x, delta), cache = _run_stack(x, params["stacks"], cfg.layer_groups(),
                                   cfg, plan, lay, "prefill", positions,
                                   cache=cache, enc_memory=enc_memory)
    x = final_norm(params, x[:, -1:], delta[:, -1:], cfg)
    return final_logits(params, x)[:, 0], cache


def forward_decode(params, cache, tokens, pos, cfg, plan, lay, pages=None):
    """One decode step over contiguous lanes (``pages`` None) or the page
    pools.  tokens: (B, 1); pos: (B,) -> (logits (B, V), cache)."""
    positions = pos[:, None]
    x = embed_tokens(params, tokens, cfg)
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
    x = embed_tokens(params, tokens, cfg)
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
    x = embed_tokens(params, tokens, cfg)
    (x, delta), cache = _run_stack(x, params["stacks"], cfg.layer_groups(),
                                   cfg, plan, lay, "prefill", positions,
                                   cache=cache, pages=pages)
    keep = last_idx.reshape(1).long()
    x = final_norm(params, x.index_select(1, keep), delta.index_select(1, keep),
                   cfg)
    return final_logits(params, x)[:, 0], cache
