"""One transformer layer over the contiguous or the paged cache, at tp=1.

Port of the parts of the JAX package's ``core/blocks.py`` that serving of
attention-only, pure-SSM and hybrid decoders runs at dp=1: ``attn_mixer``
over a contiguous lane (decode, and whole-prompt prefill; ``_kv_q``/``_kv_dq``
with the fixed ``KVQ`` int8 scale, the card's decode kernel reading int8
lanes in place, ``_kv_write``, ``_kv_fill``) or over
the page pools (decode, speculative-verify and prefill-chunk modes, over
float or int8 pools; ``_row_quant``, ``_page_write``), ``dense_ffn`` and
``ffn_sublayer`` (a dense FFN, or an MoE layer's routed and shared experts),
``ssm_mixer`` (decode, whole-sequence prefill from a zero state, and
chunked prefill) over a contiguous lane or, through ``_paged_ssm``, over
float32 or int8 state slabs, the encoder-decoder's ``cross_attn_mixer``
(over a contiguous cross lane, or read-only cross pages through the
cross block table) and ``layer_forward``.  Caches are updated
in place where JAX returns new arrays.  On one device every ``psum`` of
the two-sync contract is the identity.  Every matrix product goes through
``kernels.ops.matmul``.

Parameters arrive with the tp axis already stripped (``bridge`` and
``model.init_params`` store what the JAX package's ``_lo`` returns).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import (FFN_MOE, FFN_NONE, MIX_ATTN,
                                     MIX_HYBRID, MIX_SSM)
from repro_torch.core import moe
from repro_torch.core import ssm as ssd
from repro_torch.core.attention import (decode_attention, flash_attention,
                                        gather_kv, paged_decode_attention,
                                        paged_verify_attention)
from repro_torch.core.layers import activation, apply_norm, apply_rope, \
    gated_rmsnorm, rmsnorm
from repro_torch.kernels import ops

KVQ = {"scale": 16.0}  # fixed-point int8 scale of the contiguous KV lanes


def _kv_q(x, dtype):
    """K/V for a contiguous lane: int8 fixed point (x * 16, rounded half to
    even as ``jnp.round`` does, clipped at +-127, so |x| > 7.94 saturates)
    or a plain cast."""
    if dtype == torch.int8:
        return torch.round(x.float() * KVQ["scale"]).clamp(-127, 127).to(
            torch.int8)
    return x.to(dtype)


def _kv_dq(x, compute_dtype):
    """A lane back in ``compute_dtype`` (int8 through the fixed scale)."""
    if x.dtype == torch.int8:
        return (x.float() * (1.0 / KVQ["scale"])).to(compute_dtype)
    return x.to(compute_dtype)


def _row_quant(x):
    """Per-token-row int8 quantization for the paged pools.

    x: (..., G, D), one token row per leading index.  Each row gets its own
    scale ``amax / 127`` over its (G, D) values, so the stored bytes are a
    function of the row's values alone (write order, speculation and
    chunking cannot change them); a zero row gets scale 0 and dequantizes
    to exact zeros.  ``torch.round`` rounds half to even, as ``jnp.round``
    does.  -> (int8 like x, scale (...,) float32)."""
    xf = x.float()
    amax = xf.abs().amax(dim=(-2, -1))
    inv = torch.where(amax > 0, 127.0 / amax.clamp_min(1e-30),
                      torch.zeros_like(amax))
    q = torch.round(xf * inv[..., None, None]).clamp(-127, 127)
    return q.to(torch.int8), amax * (1.0 / 127.0)


def _mm(x, w):
    """x: (..., K) @ w: (K, ...) -> (..., w.shape[1:])."""
    K = x.shape[-1]
    out = ops.matmul(x.reshape(-1, K).contiguous(), w.reshape(K, -1))
    return out.reshape(*x.shape[:-1], *w.shape[1:])


def _project_qkv(xn, pa, cfg):
    """q (B, S, H, D), k and v (B, S, G, D); with qk-norm, q and k are
    RMS-normed per head over head_dim (``layers.rmsnorm``, the norm kernel
    on the card), before RoPE, as JAX's ``_project_qkv``."""
    q, k, v = _mm(xn, pa["wq"]), _mm(xn, pa["wk"]), _mm(xn, pa["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, pa["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, pa["k_norm"], cfg.norm_eps)
    return q, k, v


def _rope_qk(q, k, positions, cfg):
    if cfg.rope_theta > 0:
        q = _rope_heads(q, positions, cfg)
        k = _rope_heads(k, positions, cfg)
    return q, k


def _rope_heads(x, positions, cfg):
    # x: (B, S, H, D); positions: (B, S)
    xt = x.transpose(1, 2)                           # (B, H, S, D)
    xt = apply_rope(xt, positions[:, None, :], cfg.rope_theta)
    return xt.transpose(1, 2)


def _group_q(q, lay):
    """(B, S, hq_loc, D) -> (B, G, R, S, D)"""
    B, S, _, D = q.shape
    hl = lay.attn
    q = q.reshape(B, S, hl.n_kv_loc, hl.r, D)
    return q.permute(0, 2, 3, 1, 4)


def _ungroup(o, lay):
    """(B, G, R, S, D) -> (B, S, hq_loc * D)"""
    B, G, R, S, D = o.shape
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, G * R * D)


def attn_mixer(xn, pa, cfg, plan, lay, spec, mode, kv_cache, positions, pos,
               pages=None):
    """Attention sublayer over a contiguous lane ({"k", "v", "pos"}) or the
    page pools ({"kp", "vp", ...}) -> (output (B, S, E), kv_cache updated
    in place)."""
    paged = kv_cache is not None and "kp" in kv_cache
    # "train" is JAX's mode for the encoder: a whole sequence, no cache
    if mode not in (("decode", "verify", "prefill") if paged
                    else ("decode", "prefill", "train")) or \
            (mode == "decode" and kv_cache is None) or \
            (mode == "train" and kv_cache is not None):
        raise NotImplementedError(
            f"attn_mixer mode '{mode}' over a "
            f"{'paged' if paged else 'contiguous'} cache is not ported")
    window = cfg.window_for(spec)
    q, k, v = _project_qkv(xn, pa, cfg)
    q, k = _rope_qk(q, k, positions, cfg)
    qg = _group_q(q, lay)                            # (B, G, R, S, D)
    kg = k.transpose(1, 2)                           # (B, G, S, D)
    vg = v.transpose(1, 2)
    if paged:
        out, kv_cache = _paged_attn(qg, kg, vg, kv_cache, pages, mode,
                                    positions, pos, window, cfg)
    elif mode == "decode":
        _kv_write(kv_cache, kg, vg, pos)
        k, v, dq = kv_cache["k"], kv_cache["v"], {}
        if k.dtype == torch.int8 and qg.is_cuda:     # read as int8 on the card
            dq = dict(kv_scale=1.0 / KVQ["scale"])
        else:
            k, v = _kv_dq(k, qg.dtype), _kv_dq(v, qg.dtype)
        out = decode_attention(qg[:, :, :, 0], k, v, kv_cache["pos"], pos,
                               window=window, scale=cfg.attn_scale, **dq)
        out = out[:, :, :, None, :]                  # (B, G, R, 1, D)
    else:
        out = flash_attention(qg, kg, vg, causal=cfg.causal, window=window,
                              scale=cfg.attn_scale)
        if kv_cache is not None:
            _kv_fill(kv_cache, kg, vg, positions)
    return _mm(_ungroup(out, lay), pa["wo"].reshape(-1, xn.shape[-1])), \
        kv_cache


def _kv_write(kv, kg, vg, pos):
    """Decode-step write into a contiguous lane, in place (JAX's
    ``.at[].set``): token b goes to ring slot ``pos[b] % W``.  kg/vg: (B, G,
    1, D); pos: (B,)."""
    B, G, W, D = kv["k"].shape
    slot = (pos % W).long()
    bidx = torch.arange(B, device=pos.device)
    kv["k"][bidx, :, slot] = _kv_q(kg[:, :, 0], kv["k"].dtype)
    kv["v"][bidx, :, slot] = _kv_q(vg[:, :, 0], kv["v"].dtype)
    kv["pos"][bidx, slot] = pos.to(torch.int32)
    return kv


def _kv_fill(kv, kg, vg, positions):
    """Prefill write into a contiguous lane, in place: the last W tokens at
    their ring slots.  kg/vg: (B, G, S, D); positions: (B, S), equal rows."""
    W = kv["k"].shape[2]
    S = kg.shape[2]
    n = min(W, S)
    p_tail = positions[:, S - n:]
    slots = (p_tail[0] % W).long()
    kv["k"][:, :, slots] = _kv_q(kg[:, :, S - n:], kv["k"].dtype)
    kv["v"][:, :, slots] = _kv_q(vg[:, :, S - n:], kv["v"].dtype)
    kv["pos"][:, slots] = p_tail.to(torch.int32)
    return kv


def _paged_attn(qg, kg, vg, kv, pages, mode, positions, pos, window, cfg):
    """Paged-cache attention (decode token, verify block or prefill chunk).

    kv: {"kp", "vp"} page pools (n_pages, G, psz, D), plus {"ksp", "vsp"}
    (n_pages, psz) scales when the pools are int8; pages: {"block_table",
    "chunk_start"}.  Token t of a slot lives at page block_table[t // psz],
    offset t % psz, so the gathered stream holds absolute position s at
    slot s and validity is s <= cur_pos (decode), s <= cur_pos + i (verify
    query i) / causal masking (chunk).  Garbage between a prompt's end and
    its chunk boundary is never read: every later position is written
    before it first becomes visible.  int8 pools are read through their
    scales: in the decode and verify kernels, and by a dequantizing gather
    before the prefill chunk's flash attention."""
    bt = pages["block_table"]
    # decode writes its one token at pos (positions == pos[:, None]); verify
    # writes its block at pos + i, padded columns at -1 (the scratch page);
    # a chunk writes its tokens — always before attending
    kv = _page_write(kv, kg, vg, positions, bt, kv["kp"].shape[2])
    if "ksp" in kv:
        kp, vp = kv["kp"], kv["vp"]
        scales = dict(k_scale=kv["ksp"], v_scale=kv["vsp"])
    else:
        kp, vp = kv["kp"].to(qg.dtype), kv["vp"].to(qg.dtype)
        scales = {}
    if mode == "decode":
        out = paged_decode_attention(qg[:, :, :, 0], kp, vp, bt, pos,
                                     window=window, scale=cfg.attn_scale,
                                     **scales)
        return out[:, :, :, None, :], kv
    if mode == "verify":
        # query i sits at pos + i; rejected drafts' KV needs no rollback:
        # validity masks it until the next step overwrites it
        out = paged_verify_attention(qg, kp, vp, bt, pos, window=window,
                                     scale=cfg.attn_scale, **scales)
        return out, kv
    # prefill chunk: attend to the gathered prefix
    k_all, v_all = gather_kv(kp, vp, bt, qg.dtype, **scales)  # (B,G,L,D)
    out = flash_attention(qg, k_all, v_all, causal=True, window=window,
                          scale=cfg.attn_scale, q_offset=pages["chunk_start"])
    return out, kv


def _page_write(kv, kg, vg, positions, bt, psz):
    """Scatter new K/V into the page pools, in place (JAX's donated
    ``.at[].set``).  kg/vg: (B, G, C, D); positions: (B, C) absolute token
    positions (C = 1 for decode).  Negative positions (padded verify
    columns) route to the scratch page 0, whose contents no live slot
    reads, and so do positions past the block table (the padding rows of a
    chunk that resumes mid-prompt after a prefix hit can run past the
    sequence budget; JAX's gather fills them out of bounds and its scatter
    drops them).  int8 pools: each token row is quantized with its own scale
    (``_row_quant``), and payload and scale are written in the same step."""
    B, G, C, D = kg.shape
    limit = bt.shape[1] * psz
    safe = positions.clamp(0, limit - 1)
    pid = torch.gather(bt, 1, (safe // psz).long())              # (B, C)
    # rows outside [0, limit) go to page 0: as many kernels as the old
    # test of position >= 0 alone
    pid = pid * (positions // limit == 0)
    flat_pid = pid.reshape(-1).long()
    flat_off = (safe % psz).reshape(-1).long()
    for name, x in (("k", kg), ("v", vg)):
        pool = kv[name + "p"]
        rows = x.permute(0, 2, 1, 3)                             # (B, C, G, D)
        if name + "sp" in kv:
            rows, row_scale = _row_quant(rows)
            kv[name + "sp"][flat_pid, flat_off] = row_scale.reshape(B * C)
        pool[flat_pid, :, flat_off] = rows.to(pool.dtype).reshape(B * C, G, D)
    return kv


def dense_ffn(xn, pf, cfg):
    """Gated FFN, down(act(x @ gate) * (x @ up)), or the plain one,
    down(act(x @ up)) (``cfg.gated_ffn`` False: seamless)."""
    if cfg.gated_ffn:
        h = activation(_mm(xn, pf["w_gate"]), cfg.act) * _mm(xn, pf["w_up"])
    else:
        h = activation(_mm(xn, pf["w_up"]), cfg.act)
    return _mm(h, pf["w_down"])


def ffn_sublayer(xn, pf, cfg, plan, spec):
    """JAX's ``ffn_sublayer``: an MoE layer's routed experts
    (``moe.moe_ffn_ep`` when ``plan.moe_mode`` is "ep", else
    ``moe.moe_ffn_tp``, at ``plan.moe_capacity``) plus its shared experts'
    dense FFN, or the dense FFN."""
    if spec.ffn == FFN_MOE:
        if plan.moe_mode == "ep":
            y = moe.moe_ffn_ep(xn, pf, cfg, 0, 1,
                               capacity_factor=plan.moe_capacity)
        else:
            y = moe.moe_ffn_tp(xn, pf, cfg, capacity_factor=plan.moe_capacity)
        if cfg.n_shared_experts:
            y = y + dense_ffn(xn, pf["shared"], cfg)
        return y
    return dense_ffn(xn, pf, cfg)


def cross_kv(enc_memory, pa, cfg):
    """One cross-attention layer's K/V of the encoder memory, (B, G,
    S_enc, D) each: no RoPE (JAX's ``forward_cross_kv``), k RMS-normed
    with qk-norm."""
    k, v = _mm(enc_memory, pa["wk"]), _mm(enc_memory, pa["wv"])
    if cfg.qk_norm:
        k = rmsnorm(k, pa["k_norm"], cfg.norm_eps)
    return k.transpose(1, 2), v.transpose(1, 2)


def cross_lane_cast(x, dtype):
    """The contiguous cross lane's store: JAX's bare ``astype``.  For an
    int8 lane that is no ``_kv_q`` and no scale: a truncation toward zero,
    saturating at the int8 range as XLA's conversion does (a trap of the
    JAX package, kept: ROADMAP, "Known traps")."""
    if dtype == torch.int8:
        return x.float().trunc().clamp(-128, 127).to(torch.int8)
    return x.to(dtype)


def cross_attn_mixer(xn, pa, cfg, lay, mode, cross, enc_memory=None,
                     pages=None):
    """Cross-attention: q from x (no RoPE), K/V of the encoder memory ->
    (output (B, S, E), cross cache).

    Paged (``cross`` holds the ``ckp``/``cvp`` pools, and ``cksp``/
    ``cvsp`` scales when int8): the K/V were written once at admission
    (``steps.make_cross_kv_write_step``) and are read-only here, through
    the slot's ``pages["cross_block_table"]``.  A decode token runs the
    paged decode attention over that table in place at ``cur_pos =
    S_enc - 1`` (every key of the memory visible: no gather); a prefill
    chunk gathers the pages once and runs flash attention without the
    causal mask over the first ``S_enc`` keys, as JAX does.

    Contiguous (``cross`` holds the lanes ``k``/``v``, (B, G, S_enc, D)):
    a whole-prompt prefill projects ``enc_memory`` and stores it into the
    lane (``cross_lane_cast``), attending without the causal mask; a
    decode token reads the lane cast to q's dtype (int8 lanes by a bare
    cast, as JAX's ``astype``) with every key valid (JAX's ``cur_pos =
    S_enc``: the decode kernel's length ``min(cur_pos + 1, S_enc)``).  The
    encoder (``"train"``) keeps no cache."""
    B, S, E = xn.shape
    q = _mm(xn, pa["wq"])
    if cfg.qk_norm:
        q = rmsnorm(q, pa["q_norm"], cfg.norm_eps)
    qg = _group_q(q, lay)                            # (B, G, R, S, D)
    S_enc = cfg.enc_seq_len
    scale = cfg.attn_scale
    if cross is not None and "ckp" in cross:         # paged, read-only
        cbt = pages["cross_block_table"]
        if "cksp" in cross:
            kp, vp = cross["ckp"], cross["cvp"]
            scales = dict(k_scale=cross["cksp"], v_scale=cross["cvsp"])
        else:
            kp, vp = cross["ckp"].to(qg.dtype), cross["cvp"].to(qg.dtype)
            scales = {}
        if mode == "decode":
            last = torch.full((B,), S_enc - 1, dtype=torch.int32,
                              device=xn.device)
            out = paged_decode_attention(qg[:, :, :, 0], kp, vp, cbt, last,
                                         scale=scale, **scales)
            out = out[:, :, :, None, :]
        else:
            k_all, v_all = gather_kv(kp, vp, cbt, qg.dtype, **scales)
            out = flash_attention(qg, k_all[:, :, :S_enc], v_all[:, :, :S_enc],
                                  causal=False, scale=scale)
    elif mode == "decode":
        k, v = cross["k"].to(qg.dtype), cross["v"].to(qg.dtype)
        slot_pos = torch.arange(S_enc, dtype=torch.int32,
                                device=xn.device).expand(B, S_enc)
        every = torch.full((B,), S_enc, dtype=torch.int32, device=xn.device)
        out = decode_attention(qg[:, :, :, 0], k, v, slot_pos, every,
                               scale=scale)
        out = out[:, :, :, None, :]
    else:
        kg, vg = cross_kv(enc_memory, pa, cfg)
        out = flash_attention(qg, kg, vg, causal=False, scale=scale)
        if mode == "prefill" and cross is not None:
            cross["k"].copy_(cross_lane_cast(kg, cross["k"].dtype))
            cross["v"].copy_(cross_lane_cast(vg, cross["v"].dtype))
    return _mm(_ungroup(out, lay), pa["wo"].reshape(-1, E)), cross


def ssm_mixer(xn, ps, cfg, lay, mode, ssm_cache, chunk_last_idx=None):
    """The SSD mixer for one decode token (``mode == "decode"``), a whole
    prompt (``mode == "prefill"``: the conv and the scan start from zeros,
    and ``ssm_cache`` is not read), or one prefill chunk carried on from
    ``ssm_cache`` (``chunk_last_idx`` given: rows past it are padding
    beyond the prompt's end; their dt is zeroed, so they leave the state
    untouched, and the conv tails are cut at it).
    ssm_cache: {"state" (B, H, P, N) float32, or int8 with "state_scale"
    (B, H), "conv_x" (B, K-1, H*P), "conv_B"/"conv_C" (B, K-1, N)}.
    -> (out (B, S, E), new cache with a float32 state).  The gated norm
    over d_inner, JAX's ``rmsnorm_from_sumsq`` at tp=1, runs as one call of
    ``layers.gated_rmsnorm`` (the rmsnorm kernel's gated variant with n =
    H*P), which writes the out projection's input dtype directly."""
    if mode not in ("decode", "prefill"):
        raise NotImplementedError(f"ssm_mixer mode '{mode}' is not ported")
    whole = mode == "prefill" and chunk_last_idx is None
    prev = {} if whole else ssm_cache      # a whole prompt starts from zeros
    B, S, E = xn.shape
    H, Pd = lay.ssm.hq_loc, cfg.ssm_head_dim
    z = _mm(xn, ps["in_z"])                                     # (B,S,H,P)
    xi = _mm(xn, ps["in_x"])
    dt_raw = _mm(xn, ps["in_dt"])                               # (B,S,H)
    Bm = _mm(xn, ps["in_B"])                                    # (B,S,N)
    Cm = _mm(xn, ps["in_C"])
    tail = None if mode == "decode" else chunk_last_idx
    xi_f, cs_x = ssd.causal_conv(xi.reshape(B, S, H * Pd),
                                 ps["conv_x"].reshape(H * Pd, -1),
                                 prev.get("conv_x"), tail)
    Bm, cs_B = ssd.causal_conv(Bm, ps["conv_B"], prev.get("conv_B"), tail)
    Cm, cs_C = ssd.causal_conv(Cm, ps["conv_C"], prev.get("conv_C"), tail)
    xi = F.silu(xi_f).reshape(B, S, H, Pd)
    Bm, Cm = F.silu(Bm), F.silu(Cm)
    dt = F.softplus(dt_raw.float() + ps["dt_bias"].float())
    A = -torch.exp(ps["A_log"].float())
    if mode == "decode":
        y, state = ssd.ssd_decode_step(xi[:, 0], dt[:, 0], Bm[:, 0], Cm[:, 0],
                                       A, ps["D"], ssm_cache["state"])
        y = y[:, None]                                          # (B,1,H,P)
    elif whole:
        y, state = ssd.ssd_chunked(xi, dt, Bm, Cm, A, ps["D"])
    else:
        # padding past the prompt must not advance the recurrence: dt = 0
        # makes a padded position's decay exp(0) = 1 and contribution 0
        keep = torch.arange(S, device=dt.device)[None, :, None] <= \
            chunk_last_idx
        dt = torch.where(keep, dt, torch.zeros_like(dt))
        y, state = ssd.ssd_chunked(xi, dt, Bm, Cm, A, ps["D"],
                                   state0=ssm_cache["state"],
                                   state0_scale=ssm_cache.get("state_scale"))
    g = gated_rmsnorm(y.reshape(B, S, H * Pd), z.reshape(B, S, H * Pd),
                      ps["norm_scale"], cfg.norm_eps, xn.dtype)
    out = _mm(g, ps["out"].reshape(H * Pd, E))
    return out, {"state": state, "conv_x": cs_x, "conv_B": cs_B,
                 "conv_C": cs_C}


def _paged_ssm(xn, ps, cfg, lay, mode, slab_pool, pages):
    """The SSM mixer against the slab pools, updated in place.

    slab_pool: {"statep", "conv_xp", "conv_Bp", "conv_Cp"} with a leading
    ``n_slabs`` dim, plus "sscalep" (n_slabs, H) when the state slabs are
    int8; pages["slab_ids"]: (B,) slab id per batch row.  Each row gathers
    its slab, runs one decode token or one prefill chunk and scatters the
    new state back.  Idle decode lanes all point at scratch slab 0: their
    scatter to it races, harmlessly, since no live slot reads slab 0.
    int8 slabs: a decode step dequantizes the state on gather (as JAX
    does); a prefill chunk hands the int8 state and its scales to the SSD
    kernel, which dequantizes in registers (the same float32 product); the
    whole new state is re-quantized per (slot, head) on scatter
    (``_row_quant`` over (P, N))."""
    sid = pages["slab_ids"].long()
    quant = "sscalep" in slab_pool
    view = {k: slab_pool[k + "p"][sid] for k in ("conv_x", "conv_B", "conv_C")}
    state = slab_pool["statep"][sid]
    if quant and mode == "decode":
        state = state.float() * slab_pool["sscalep"][sid][:, :, None, None]
    elif quant:
        view["state_scale"] = slab_pool["sscalep"][sid]
    view["state"] = state
    out, new = ssm_mixer(xn, ps, cfg, lay, mode, view,
                         chunk_last_idx=(pages.get("last_idx")
                                         if mode != "decode" else None))
    for k in ("conv_x", "conv_B", "conv_C"):
        pool = slab_pool[k + "p"]
        pool[sid] = new[k].to(pool.dtype)
    if quant:
        q, scale = _row_quant(new["state"])                 # (B,H,P,N), (B,H)
        slab_pool["statep"][sid] = q
        slab_pool["sscalep"][sid] = scale
    else:
        slab_pool["statep"][sid] = new["state"]
    return out, slab_pool


def layer_forward(x, p, cache, cfg, plan, lay, spec, mode, positions,
                  pos=None, pages=None, delta=None, enc_memory=None):
    """One layer: an attention or SSM mixer, or both on the same normed
    input fused as ``0.5 * (attention + SSM)`` (a hybrid layer, JAX's
    ``partial = 0.5 * (pa + ps_)``), then an enc-dec decoder's
    cross-attention (its own norm ``ln_x``, ``cross_attn_mixer`` over
    ``cache["cross"]`` or ``enc_memory``), then the FFN sublayer (dense,
    or MoE: ``ffn_sublayer``) unless the layer has none.  The residual stream is carried as ``x`` and a pending
    ``delta`` (None before the first layer): each residual add is fused
    into the norm after it (``layers.add_rmsnorm``), so the layer opens
    with the norm of ``x + delta``, and the add of its last sublayer's
    output is left pending for the next layer or the final norm.  With
    sandwich norms (gemma3) each sublayer's output goes through its
    ``post_ln1``/``post_ln2`` (the plain norm kernel) before it becomes
    the pending delta, as JAX normalizes it before the residual add.
    -> ((x, delta), cache updated in place); ``x + delta`` is the layer's
    output."""
    if spec.mixer not in (MIX_ATTN, MIX_SSM, MIX_HYBRID):
        raise NotImplementedError(f"mixer '{spec.mixer}' is not ported")
    x, h = apply_norm(x, p["ln1"], cfg, delta)
    partial = None
    if spec.mixer in (MIX_ATTN, MIX_HYBRID):
        partial, kv = attn_mixer(h, p["attn"], cfg, plan, lay, spec, mode,
                                 cache.get("kv"), positions, pos, pages)
        cache = {**cache, "kv": kv}
    if spec.mixer in (MIX_SSM, MIX_HYBRID):
        if "statep" in cache["ssm"]:                  # slab pools
            ps, slabs = _paged_ssm(h, p["ssm"], cfg, lay, mode,
                                   cache["ssm"], pages)
            cache = {**cache, "ssm": slabs}
        else:                                         # a contiguous lane
            ps, new = ssm_mixer(h, p["ssm"], cfg, lay, mode, cache["ssm"])
            for name, t in new.items():
                cache["ssm"][name].copy_(t)
        # hybrid: the attention and SSD heads fuse before the one
        # residual add, as JAX fuses them before the mixer's one psum
        partial = ps if partial is None else 0.5 * (partial + ps)
    if cfg.sandwich_norm:
        partial = rmsnorm(partial, p["post_ln1"]["scale"], cfg.norm_eps)
    if spec.cross_attn:
        x, h = apply_norm(x, p["ln_x"], cfg, partial)
        partial, cross = cross_attn_mixer(h, p["xattn"], cfg, lay, mode,
                                          cache.get("cross"), enc_memory,
                                          pages)
        cache = {**cache, "cross": cross}
    if spec.ffn == FFN_NONE:
        return (x, partial), cache
    x, h = apply_norm(x, p["ln2"], cfg, partial)
    out = ffn_sublayer(h, p["ffn"], cfg, plan, spec)
    if cfg.sandwich_norm:
        out = rmsnorm(out, p["post_ln2"]["scale"], cfg.norm_eps)
    return (x, out), cache
