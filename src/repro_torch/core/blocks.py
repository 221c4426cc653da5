"""One transformer layer over the paged cache, at tp=1.

Port of the parts of the JAX package's ``core/blocks.py`` that paged
serving of attention-only decoders runs: the paged branch of
``attn_mixer`` (decode, speculative-verify and prefill-chunk modes, over
float or int8 pools), ``_row_quant``, ``_page_write``, ``dense_ffn`` and
``layer_forward``.  On one device every ``psum`` of the
two-sync contract is the identity.  Every matrix product goes through
``kernels.ops.matmul``.

Parameters arrive with the tp axis already stripped (``bridge`` and
``model.init_params`` store what the JAX package's ``_lo`` returns).
"""
from __future__ import annotations

import torch

from repro_torch.core.attention import (flash_attention, gather_kv,
                                        paged_decode_attention,
                                        paged_verify_attention)
from repro_torch.core.layers import activation, apply_norm, apply_rope
from repro_torch.kernels import ops


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


def _project_qkv(xn, pa):
    return _mm(xn, pa["wq"]), _mm(xn, pa["wk"]), _mm(xn, pa["wv"])


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
               pages):
    """Paged attention sublayer -> (output (B, S, E), kv_cache updated in
    place)."""
    if mode not in ("decode", "verify", "prefill") or kv_cache is None \
            or "kp" not in kv_cache:
        raise NotImplementedError(
            f"attn_mixer mode '{mode}': the port runs paged decode, verify "
            f"and prefill chunks; the contiguous cache comes with a later "
            f"slice")
    window = cfg.window_for(spec)
    q, k, v = _project_qkv(xn, pa)
    q, k = _rope_qk(q, k, positions, cfg)
    qg = _group_q(q, lay)                            # (B, G, R, S, D)
    kg = k.transpose(1, 2)                           # (B, G, S, D)
    vg = v.transpose(1, 2)
    out, kv_cache = _paged_attn(qg, kg, vg, kv_cache, pages, mode, positions,
                                pos, window, cfg)
    return _mm(_ungroup(out, lay), pa["wo"].reshape(-1, xn.shape[-1])), \
        kv_cache


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
    reads.  int8 pools: each token row is quantized with its own scale
    (``_row_quant``), and payload and scale are written in the same step."""
    B, G, C, D = kg.shape
    safe = positions.clamp_min(0)
    pid = torch.gather(bt, 1, (safe // psz).long())              # (B, C)
    pid = torch.where(positions >= 0, pid, torch.zeros_like(pid))
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
    """Gated FFN: down(act(x @ gate) * (x @ up))."""
    h = activation(_mm(xn, pf["w_gate"]), cfg.act) * _mm(xn, pf["w_up"])
    return _mm(h, pf["w_down"])


def layer_forward(x, p, cache, cfg, plan, lay, spec, mode, positions,
                  pos=None, pages=None):
    """One attention + dense-FFN layer.  -> (x, cache updated in place)."""
    h = apply_norm(x, p["ln1"], cfg)
    partial, kv = attn_mixer(h, p["attn"], cfg, plan, lay, spec, mode,
                             cache["kv"], positions, pos, pages)
    x = x + partial
    h = apply_norm(x, p["ln2"], cfg)
    x = x + dense_ffn(h, p["ffn"], cfg)
    return x, {**cache, "kv": kv}
