"""Sliding windows, head_dim 256 and gemma3 in the port, against the JAX
package on the same numpy inputs: the plain paged decode and verify with a
window (R = 2, head dims 32 and 256, float and int8 pools, lengths on both
sides of the window) against ``repro.core.attention``; the contiguous
decode over a window's ring read by a clamped prefix length against JAX's
``slot_pos`` mask; the card route handing the window and the clamped
length to the kernels; the head_dim 256 plans within shared memory; the
bridge, the bf16 embedding scale and gelu; and reduced gemma3-12b (6
layers, 5 window layers and 1 full, d_model 128, 4 q over 2 kv heads x 32,
window 16, so short requests cross it) through the bridge: prefill-chunk and
decode logits and the engines' greedy tokens against JAX's paged engine
(float pools, int8 pools, speculative=3) and contiguous engine (a ring
shorter than the budget).  Tolerances: fp32 1e-4 (``tests/test_kernels.py``),
bf16 2e-2."""
import contextlib
import dataclasses
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from paged_cases import paged_case, quant_pool_case

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import ShapeConfig
from repro.core import attention as jattn
from repro.core import model as jmodel
from repro.core import steps as jsteps
from repro.core.partition import ShardingPlan as JaxPlan
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.core import attention as tattn
from repro_torch.core import layers, model, steps
from repro_torch.core.partition import ShardingPlan
from repro_torch.kernels import build, ops
from repro_torch.kernels import decode_attention as k_decode
from repro_torch.kernels import flash_attention as k_flash
from repro_torch.launch import serve
from repro_torch.serving import Request, ServingEngine

TOL = dict(rtol=1e-4, atol=1e-4)
G, R = 2, 2                          # kv heads, q heads per kv head
H = G * R
WIN = 16                             # the reduced model's sliding window
SMEM_MAX = 232448


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _source(name):
    return (Path(k_decode.__file__).parent / "csrc" / name).read_text()


# --------------------------------------------------------------- configs
def test_gemma3_configs_are_jax_s():
    shape = lambda c: (c.n_layers, c.d_model, c.n_heads,  # noqa: E731
                       c.n_kv_heads, c.head_dim_, c.d_ff, c.vocab_size,
                       c.qk_norm, c.sandwich_norm, c.scale_embed,
                       c.local_global_ratio, c.sliding_window, c.rope_theta,
                       c.act, c.gated_ffn, c.tie_embeddings)
    for name in ("gemma3-12b", "gemma3-27b"):
        assert shape(get_config(name)) == shape(jax_get_config(name))
        assert get_config(name).source == jax_get_config(name).source
    assert shape(get_config("gemma3-12b"))[:8] == \
        (48, 3840, 16, 8, 256, 15360, 262144, True)
    cfg = reduced(get_config("gemma3-12b"), sliding_window=WIN)
    assert shape(cfg) == shape(jax_reduced(jax_get_config("gemma3-12b"),
                                           sliding_window=WIN))
    assert [s.attn for s in cfg.layer_specs()] == ["window"] * 5 + ["full"]
    full = get_config("gemma3-12b")
    assert [(g.n_reps, len(g.pattern)) for g in full.layer_groups()] == \
        [(8, 6)]


# ------------------------------------------------- plain versions vs JAX
def _pools(rng, quant, n_pages, psz, d):
    if quant:
        kp, ks = quant_pool_case(rng, n_pages, G, psz, d)
        vp, vs = quant_pool_case(rng, n_pages, G, psz, d)
        return ((torch.from_numpy(kp), torch.from_numpy(vp)),
                dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs)),
                (jnp.asarray(kp), jnp.asarray(vp)),
                dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    kp, vp = (rng.randn(n_pages, G, psz, d).astype(np.float32)
              for _ in range(2))
    return (_t(kp), _t(vp)), {}, (jnp.asarray(kp), jnp.asarray(vp)), {}


@pytest.mark.parametrize("nq", [1, 5], ids=["decode", "verify-Q5"])
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("d", [32, 256])
def test_paged_plain_window_matches_jax_core(d, quant, nq):
    """Paged decode and verify with a window of 16 over a shuffled block
    table: lengths 3 and 16 (inside it), 17 and 40 (past it, the deepest
    query of the last near n_max * psz), R = 2 q heads per kv head."""
    rng = np.random.RandomState(d + 10 * nq + quant)
    B, psz, n_max = 4, 8, 6
    n_pages = B * n_max + 1
    bt = paged_case(rng, B, n_max, n_pages)
    bt[-1] = rng.permutation(n_pages - 1)[:n_max] + 1   # every row live
    length = np.asarray([3, 16, 17, 40], np.int32)
    q = rng.randn(B, G, R, nq, d).astype(np.float32)
    pools_t, sc_t, pools_j, sc_j = _pools(rng, quant, n_pages, psz, d)
    args_t = (*pools_t, torch.from_numpy(bt), torch.from_numpy(length))
    args_j = (*pools_j, jnp.asarray(bt), jnp.asarray(length - 1))
    if nq == 1:
        got = ops.paged_decode_attention(_t(q[:, :, :, 0]).reshape(B, H, d),
                                         *args_t, window=WIN, **sc_t)
        want = jattn.paged_decode_attention(jnp.asarray(q[:, :, :, 0]),
                                            *args_j, window=WIN, **sc_j)
        _close(got.reshape(B, G, R, d), want)
        unwindowed = ops.paged_decode_attention(
            _t(q[:, :, :, 0]).reshape(B, H, d), *args_t, **sc_t)
    else:
        got = ops.paged_verify_attention(_t(q).reshape(B, H, nq, d), *args_t,
                                         window=WIN, **sc_t)
        want = jattn.paged_verify_attention(jnp.asarray(q), *args_j,
                                            window=WIN, **sc_j)
        _close(got.reshape(B, G, R, nq, d), want)
        unwindowed = ops.paged_verify_attention(_t(q).reshape(B, H, nq, d),
                                                *args_t, **sc_t)
    # rows inside the window read every key; the window bites past it
    np.testing.assert_allclose(got[0].numpy(), unwindowed[0].numpy(),
                               **TOL)
    assert not np.allclose(got[3].numpy(), unwindowed[3].numpy(), atol=1e-3)


def _ring(rng, B, W, d, upto):
    """A contiguous lane ring of W slots after writing positions 0..upto
    (slot p % W), as ``blocks._kv_write`` does -> (k, v, slot_pos)."""
    k = np.zeros((B, G, W, d), np.float32)
    v = np.zeros((B, G, W, d), np.float32)
    slot_pos = np.full((B, W), -1, np.int32)
    for p in range(upto + 1):
        k[:, :, p % W] = rng.randn(B, G, d)
        v[:, :, p % W] = rng.randn(B, G, d)
        slot_pos[:, p % W] = p
    return k, v, slot_pos


@pytest.mark.parametrize("W,window", [(8, 8), (8, 20)],
                         ids=["ring-is-the-window", "ring-is-the-budget"])
def test_ring_read_by_clamped_length_matches_jax_mask(W, window):
    """Finding 1: a ring of W slots read as the prefix of ``min(cur_pos +
    1, W)`` slots gives JAX's ``decode_attention`` with its ``slot_pos``
    mask and the window, for every position up to 3 W (the ring wrapped
    three times) when the ring is the window, and for every position the
    budget allows when the ring is the budget, shorter than the window."""
    rng = np.random.RandomState(W + window)
    B, d = 2, 32
    last = 3 * W if W == window else W - 1
    for cur in range(last + 1):
        k, v, slot_pos = _ring(rng, B, W, d, cur)
        q = rng.randn(B, G, R, d).astype(np.float32)
        length = np.full(B, min(cur + 1, W), np.int32)
        got = ops.decode_attention(_t(q).reshape(B, H, d), _t(k), _t(v),
                                   torch.from_numpy(length))
        want = jattn.decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(slot_pos), jnp.full((B,), cur, jnp.int32),
            window=window)
        _close(got.reshape(B, G, R, d), want)


# ------------------------------------------------------- the card route
class _Calls:
    def __init__(self, fn):
        self.fn, self.kw = fn, []

    def __call__(self, *a, **kw):
        self.kw.append(dict(kw, args=a))
        return self.fn(*a, **kw)


@contextlib.contextmanager
def _card_route(monkeypatch, *names):
    """``core.attention``'s card branch on CPU tensors (``is_cuda``
    patched), with the ``kernels.ops`` entries ``names`` recording what
    they are handed (and running their plain versions)."""
    calls = {n: _Calls(getattr(ops, n)) for n in names}
    for n, c in calls.items():
        monkeypatch.setattr(ops, n, c)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    try:
        yield calls
    finally:
        monkeypatch.undo()


@pytest.mark.parametrize("entry", ["paged_decode", "paged_verify"])
def test_card_route_hands_the_window_to_the_paged_kernels(entry,
                                                          monkeypatch):
    """The card route takes a window (no refusal), hands it to the
    kernel's wrapper with the prefix length ``cur_pos + 1``, and its output
    is the plain path's."""
    rng = np.random.RandomState(3)
    B, psz, n_max, d, Q = 3, 8, 4, 32, 5
    n_pages = B * n_max + 1
    kp, vp = (_t(rng.randn(n_pages, G, psz, d)) for _ in range(2))
    bt = torch.from_numpy(paged_case(rng, B, n_max, n_pages))
    cur = torch.tensor([2, 20, 26], dtype=torch.int32)
    if entry == "paged_decode":
        q = _t(rng.randn(B, G, R, d))
        call = lambda: tattn.paged_decode_attention(  # noqa: E731
            q, kp, vp, bt, cur, window=WIN)
    else:
        q = _t(rng.randn(B, G, R, Q, d))
        call = lambda: tattn.paged_verify_attention(  # noqa: E731
            q, kp, vp, bt, cur, window=WIN)
    want = call()
    name = entry + "_attention"
    with _card_route(monkeypatch, name) as calls:
        got = call()
    (kw,) = calls[name].kw
    assert kw["window"] == WIN
    assert kw["args"][4].tolist() == (cur + 1).tolist()
    _close(got, want.numpy(), dict(rtol=1e-5, atol=1e-5))


def test_card_route_reads_a_ring_by_its_clamped_length(monkeypatch):
    """The contiguous decode on the card hands the kernel ``min(cur_pos +
    1, W)`` for a ring of W slots and no window (finding 1), and gives the
    plain path's masked answer on a wrapped ring."""
    rng = np.random.RandomState(4)
    B, W, d = 2, 8, 32
    k, v, slot_pos = _ring(rng, B, W, d, 19)          # wrapped twice
    slot_pos[1] = -1                                   # row 1: a fresh lane
    slot_pos[1, :3] = np.arange(3)
    q = _t(rng.randn(B, G, R, d))
    cur = torch.tensor([19, 2], dtype=torch.int32)
    args = (q, _t(k), _t(v), torch.from_numpy(slot_pos), cur)
    want = tattn.decode_attention(*args, window=W)
    with _card_route(monkeypatch, "decode_attention") as calls:
        got = tattn.decode_attention(*args, window=W)
    (kw,) = calls["decode_attention"].kw
    assert kw["args"][3].tolist() == [8, 3] and "window" not in kw
    _close(got, want.numpy(), dict(rtol=1e-5, atol=1e-5))


class _Entry:
    """A C entry that records its arguments instead of launching."""

    def __call__(self, *args):
        self.args = args
        return 0


@pytest.fixture
def card_stub(monkeypatch):
    call = _Entry()

    def check(t, name, ndim, dtypes):
        if t.dim() != ndim or t.dtype not in dtypes or not t.is_contiguous():
            raise ValueError(f"{name}: {t.dim()} dims, {t.dtype}")

    monkeypatch.setattr(build, "check_cuda_tensor", check)
    monkeypatch.setattr(build, "kernel_function", lambda *a: call)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    return call


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("nq", [1, 5])
def test_wrappers_hand_window_and_head_dim_256_to_the_kernel(card_stub, nq,
                                                             quant):
    """gemma3's decode (B 8, 16 q over 8 kv heads, D 256, pages of 16,
    n_max 128, window 1024): the window is the last int before the plan's
    scale, whose nw, split and smem are the windowed plan's."""
    B, Hq, Hk, d, psz, n_max = 8, 16, 8, 256, 16, 128
    bf = torch.bfloat16
    q = torch.zeros(B, Hq, nq, d, dtype=bf)
    pool_dt = torch.int8 if quant else bf
    pools = [torch.zeros(B * n_max + 1, Hk, psz, d, dtype=pool_dt)
             for _ in range(2)]
    sc = dict(k_scale=torch.zeros(B * n_max + 1, psz),
              v_scale=torch.zeros(B * n_max + 1, psz)) if quant else {}
    bt = torch.zeros(B, n_max, dtype=torch.int32)
    length = torch.ones(B, dtype=torch.int32)
    if nq == 1:
        k_decode.paged_decode_attention(q[:, :, 0].contiguous(), *pools, bt,
                                        length, window=1024, **sc)
    else:
        k_decode.paged_verify_attention(q, *pools, bt, length, window=1024,
                                        **sc)
    p = k_decode.plan(B, Hq, nq, d, psz, n_max, bf, quant, 2, 1024)
    tail = card_stub.args[-9:]
    assert tail[:4] == (psz, n_max, 1024, 256 ** -0.5)
    assert tail[-4:-1] == (p.nw, p.split, p.smem)
    assert card_stub.args[-10] == d


# --------------------------------------------------------------- plans
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("window", [0, 64, 1024])
@pytest.mark.parametrize("nq", [1, 5, 8])
def test_paged_plan_at_head_dim_256_fits_and_sizes_by_window(nq, window,
                                                             quant):
    """gemma3's paged decode and verify (B 8, 16 q over 8 kv heads, D 256,
    pages of 16, n_max 128): shared memory within 227 KB with the staged
    query rows, and the split sized from the keys a slot's queries can see
    (the window's span), never from a length."""
    B, Hq, d, psz, n_max = 8, 16, 256, 16, 128
    p = k_decode.plan(B, Hq, nq, d, psz, n_max, torch.bfloat16, quant, 2,
                      window)
    span = n_max * psz // 16
    if window:
        span = min(span, (window + nq - 2) // 16 + 2)
    assert p.kernel == "mma" and p.split <= span
    assert p.nw == min(4, -(-span // p.split))
    assert p.smem == k_decode._smem_bytes(d, quant, 2 * nq, p.nw, p.split)
    assert p.smem <= SMEM_MAX
    if p.split < 8 and 2 * p.split <= span:
        assert B * 8 * p.split >= 132          # 8 kv heads x B slots


@pytest.mark.parametrize("d,quant,rows,nw,split,want", [
    # per warp two stages of 16-key K and V tiles at 33 (17 int8) chunks,
    # the 16 staged query rows at 33 chunks, then the inbox
    (256, False, 2, 4, 8, 4 * 2 * (2 * 16 * 33 * 16) + 16 * 33 * 16
     + 4 * (32 * 1 * 258 + 33 * 1)),
    (256, True, 10, 4, 2, 4 * 2 * (2 * 16 * 17 * 16 + 128) + 16 * 33 * 16
     + 4 * (8 * 5 * 258 + 9 * 5)),
])
def test_paged_smem_at_head_dim_256(d, quant, rows, nw, split, want):
    assert k_decode._smem_bytes(d, quant, rows, nw, split) == want


@pytest.mark.parametrize("sq,skv,window", [(128, 2048, 1024), (128, 2048, 0),
                                           (512, 512, 1024), (512, 512, 0),
                                           (16, 16, 0), (23, 200, 64)])
def test_flash_plan_at_head_dim_256_fits(sq, skv, window):
    """gemma3's prefill chunk (16 q over 8 kv heads, Sq 128 over 2048
    gathered keys, window 1024) and whole prompts at D 256: 32-key tiles,
    shared memory within 227 KB with the staged query rows, a split no
    wider than the tiles the rows can see."""
    p = k_flash.plan(16, sq, skv, 256, torch.bfloat16, window, 2)
    n_tiles = -(-skv // 32)
    assert k_flash.kv_tile(256) == 32 and k_flash.kv_tile(128) == 64
    assert p.kernel == "mma" and p.split <= max(1, n_tiles)
    assert p.smem == k_flash._smem_bytes(256, p.wq, p.split) <= SMEM_MAX
    if window:
        wr = p.wq // k_flash.heads_per_block(2)
        assert p.split <= (window + 16 * wr - 2) // 32 + 2
    for wq in (1, 2, 4):
        for split in (1, 2, 4, 8):
            assert k_flash._smem_bytes(256, wq, split) <= SMEM_MAX


def test_head_dim_256_plans_mirror_the_sources():
    """The head dims, the wide tile and the staged query rows are the ones
    csrc/paged_decode.cu and csrc/flash_attention.cu compile."""
    src = _source("paged_decode.cu")
    # head_dim 8 (tinyllama-42m-64h) joined the head dims after 256
    assert k_decode.HEAD_DIMS == (8, 32, 64, 128, 256)
    assert "return D == 8 || D == 32 || D == 64 || D == 128 || D == 256;" in src
    assert "d > 128 ? 16 * (d / 8 + 1) * 16 : 0" in src
    assert re.search(r"ring_bytes\(d, quant, nw\) \+ q_stage_bytes\(d\) \+", src)
    fsrc = _source("flash_attention.cu")
    assert k_flash.HEAD_DIMS == (8, 32, 64, 128, 256)
    assert re.search(rf"constexpr int KV_TILE_WIDE = {k_flash.KV_TILE_WIDE};",
                     fsrc)
    assert "d > 128 ? KV_TILE_WIDE : KV_TILE" in fsrc
    assert "d > 128 ? wq * 16 * kv_stride(d) * 16 : 0" in fsrc
    assert "case 128:" in fsrc and "launch_mma<256>" in fsrc
    for name in ("repro_paged_decode", "repro_paged_verify"):
        for sym in (name, name + "_i8"):
            sig = re.search(rf'extern "C" int {sym}\((.+?)\)', src,
                            re.S).group(1)
            assert "int n_max, int window, float scale" in " ".join(
                sig.split())
            assert len(k_decode._ARGTYPES[sym]) == sig.count(",") + 1


# ------------------------------------------------- layers and the bridge
def test_gelu_is_jax_tanh_approximation():
    x = np.linspace(-8, 8, 1001).astype(np.float32)
    _close(layers.activation(_t(x), "gelu"),
           jax.nn.gelu(jnp.asarray(x), approximate=True), dict(rtol=1e-6,
                                                               atol=1e-6))


def test_bf16_embedding_scale_is_rounded_first():
    """sqrt(3840) = 61.97 is 62.0 in bf16, and the scaled bf16 embedding
    is bitwise JAX's ``emb * jnp.asarray(sqrt(E), emb.dtype)``."""
    assert layers.rounded(math.sqrt(3840), torch.bfloat16) == 62.0
    rng = np.random.RandomState(0)
    table = jnp.asarray(rng.randn(64, 3840), jnp.bfloat16)
    toks = rng.randint(0, 64, (2, 5)).astype(np.int32)
    want = jnp.take(table, jnp.asarray(toks), axis=0) * \
        jnp.asarray(math.sqrt(3840), jnp.bfloat16)
    t_table = torch.from_numpy(np.asarray(table).view(np.int16).copy()).view(
        torch.bfloat16)
    got = layers.embed(torch.from_numpy(toks).long(), t_table,
                       math.sqrt(3840))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.fixture(scope="module")
def gemma3():
    """Reduced gemma3-12b (window 16) in fp32 from JAX's init, weights x12
    but the embedding table at its init (greedy decoding does not collapse
    onto one token: a larger table makes the scaled embedding dominate the
    tied head's input), random q_norm/k_norm and post-norm scales (JAX
    inits them to zeros), through the bridge."""
    jcfg = jax_reduced(jax_get_config("gemma3-12b"), sliding_window=WIN,
                       dtype="float32")
    jplan = JaxPlan(tp=1, kv_cache_dtype="float32")
    jp0 = jmodel.init_params(jcfg, jplan)
    jp = jax.tree_util.tree_map(lambda a: a * 12, jp0)
    jp["embed"]["table"] = jp0["embed"]["table"]
    rng = np.random.RandomState(5)
    for group in jp["stacks"]:
        for layer in group:
            for name in ("q_norm", "k_norm"):
                shape = layer["attn"][name].shape
                layer["attn"][name] = jnp.asarray(
                    0.3 * rng.randn(*shape).astype(np.float32))
            for name in ("post_ln1", "post_ln2"):
                shape = layer[name]["scale"].shape
                layer[name]["scale"] = jnp.asarray(
                    0.3 * rng.randn(*shape).astype(np.float32))
    cfg = reduced(get_config("gemma3-12b"), sliding_window=WIN,
                  dtype="float32")
    plan = ShardingPlan(kv_cache_dtype="float32")
    return jcfg, jp, cfg, params_from_jax(cfg, plan, _np_tree(jp),
                                          device="cpu")


def test_params_from_jax_carry_the_sandwich_norms(gemma3):
    """The bridge carries post_ln1 and post_ln2 with the template alone:
    the port's tree has JAX's paths and shapes, leaf for leaf."""
    jcfg, jp, cfg, p = gemma3
    layer = p["stacks"][0][0]
    assert list(layer) == ["ln1", "attn", "post_ln1", "ln2", "ffn",
                           "post_ln2"]
    for name in ("post_ln1", "post_ln2"):
        assert tuple(layer[name]["scale"].shape) == (1, 128)
        np.testing.assert_array_equal(
            layer[name]["scale"].numpy(),
            np.asarray(jp["stacks"][0][0][name]["scale"]))
    ours = model.init_params(cfg, ShardingPlan(), device="cpu")
    assert [(k, tuple(v.shape)) for k, v in model.tree_paths(ours)] == \
        [(k, tuple(v.shape)) for k, v in model.tree_paths(p)]
    flat = dict(model.tree_paths(p))
    jflat = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path): v
             for path, v in jax.tree_util.tree_leaves_with_path(jp)}
    assert set(flat) == set(jflat)


def test_check_supported_takes_gemma3_and_names_what_waits():
    model.check_supported(get_config("gemma3-12b"))
    model.check_supported(get_config("gemma3-27b"))
    cfg = get_config("gemma3-12b")
    model.check_supported(dataclasses.replace(cfg, tie_embeddings=False))
    # layernorm and the plain FFN came with the enc-dec slice
    model.check_supported(dataclasses.replace(cfg, norm="layernorm"))
    model.check_supported(dataclasses.replace(cfg, gated_ffn=False))
    for bad, what in ((dict(norm="groupnorm"), "a norm other than rmsnorm"),
                      (dict(frontend="vision_patches"), "vision frontend")):
        with pytest.raises(NotImplementedError, match=re.escape(what)):
            model.check_supported(dataclasses.replace(cfg, **bad))


# --------------------------------------------------------------- model
PSZ, CHUNK, N_MAX, N_PAGES = 8, 16, 6, 13


@pytest.mark.parametrize("kvd", ["float32", "int8"])
def test_gemma3_prefill_chunks_then_decode_match_jax(gemma3, mesh1, kvd):
    """forward_prefill_chunk over a 37-token prompt (three chunks, the
    later ones past the window of 16), then four decode steps, through the
    steps JAX jits, float32 or int8 pools."""
    jcfg, jp, cfg, p = gemma3
    jplan, plan = JaxPlan(tp=1, kv_cache_dtype=kvd), \
        ShardingPlan(kv_cache_dtype=kvd)
    jchunk, _, _ = jsteps.make_prefill_chunk_step(jcfg, jplan, mesh1, CHUNK,
                                                  N_PAGES, PSZ, N_MAX)
    jdec, _, _ = jsteps.make_paged_decode_step(jcfg, jplan, mesh1, 2, N_PAGES,
                                               PSZ, N_MAX)
    jchunk, jdec = jax.jit(jchunk), jax.jit(jdec)
    jcache = jsteps.zero_paged_cache_for(jcfg, jplan, mesh1, N_PAGES, PSZ)
    chunk = steps.make_prefill_chunk_step(cfg, plan, CHUNK, N_MAX)
    dec = steps.make_paged_decode_step(cfg, plan, 2, N_MAX)
    cache = steps.zero_paged_cache_for(cfg, plan, N_PAGES, PSZ, "cpu")
    rng = np.random.RandomState(0)
    prompt = rng.randint(2, cfg.vocab_size, 37).astype(np.int32)
    bt_row = np.asarray([7, 2, 11, 4, 9, 1], np.int32)
    L = len(prompt)
    tol = TOL if kvd == "float32" else dict(rtol=1e-3, atol=2e-3)
    for c0 in range(0, L, CHUNK):
        toks = np.zeros((1, CHUNK), np.int32)
        toks[0, :min(CHUNK, L - c0)] = prompt[c0:c0 + CHUNK]
        last = min(L - 1 - c0, CHUNK - 1)
        jl, jcache = jchunk(jp, jcache, jnp.asarray(toks),
                            jnp.asarray([c0], jnp.int32),
                            jnp.asarray([last], jnp.int32),
                            jnp.asarray(bt_row[None]))
        tl, cache = chunk(p, cache, torch.from_numpy(toks).long(), c0, last,
                          torch.from_numpy(bt_row[None]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    bt = np.stack([bt_row, np.zeros(N_MAX, np.int32)])
    tok, pos = int(np.argmax(np.asarray(jl[0]))), L
    for _ in range(4):
        toks = np.asarray([[tok], [0]], np.int32)
        pos_v = np.asarray([pos, 0], np.int32)
        jl, jcache = jdec(jp, jcache, jnp.asarray(toks), jnp.asarray(pos_v),
                          jnp.asarray(bt))
        tl, cache = dec(p, cache, torch.from_numpy(toks).long(),
                        torch.from_numpy(pos_v), torch.from_numpy(bt))
        np.testing.assert_allclose(tl[0:1].numpy(), np.asarray(jl[0:1]),
                                   **tol)
        tok, pos = int(np.argmax(np.asarray(jl[0]))), pos + 1


def test_gemma3_head_dim_256_logits_match_jax(mesh1):
    """The head_dim 256 variant (4 q over 2 kv heads x 256 at d_model
    128): a 21-token prompt in two chunks and two decode steps, float32
    pools, logits against JAX's."""
    over = dict(sliding_window=WIN, head_dim=256, dtype="float32")
    jcfg = jax_reduced(jax_get_config("gemma3-12b"), **over)
    jplan = JaxPlan(tp=1, kv_cache_dtype="float32")
    jp = jax.tree_util.tree_map(lambda a: a * 8,
                                jmodel.init_params(jcfg, jplan))
    cfg = reduced(get_config("gemma3-12b"), **over)
    plan = ShardingPlan(kv_cache_dtype="float32")
    p = params_from_jax(cfg, plan, _np_tree(jp), device="cpu")
    jchunk, _, _ = jsteps.make_prefill_chunk_step(jcfg, jplan, mesh1, CHUNK,
                                                  N_PAGES, PSZ, N_MAX)
    jdec, _, _ = jsteps.make_paged_decode_step(jcfg, jplan, mesh1, 1, N_PAGES,
                                               PSZ, N_MAX)
    jchunk, jdec = jax.jit(jchunk), jax.jit(jdec)
    jcache = jsteps.zero_paged_cache_for(jcfg, jplan, mesh1, N_PAGES, PSZ)
    chunk = steps.make_prefill_chunk_step(cfg, plan, CHUNK, N_MAX)
    dec = steps.make_paged_decode_step(cfg, plan, 1, N_MAX)
    cache = steps.zero_paged_cache_for(cfg, plan, N_PAGES, PSZ, "cpu")
    prompt = np.random.RandomState(1).randint(2, 512, 21).astype(np.int32)
    bt = np.asarray([[3, 8, 1, 12, 5, 6]], np.int32)
    for c0 in (0, CHUNK):
        toks = np.zeros((1, CHUNK), np.int32)
        toks[0, :min(CHUNK, 21 - c0)] = prompt[c0:c0 + CHUNK]
        last = min(20 - c0, CHUNK - 1)
        jl, jcache = jchunk(jp, jcache, jnp.asarray(toks),
                            jnp.asarray([c0], jnp.int32),
                            jnp.asarray([last], jnp.int32), jnp.asarray(bt))
        tl, cache = chunk(p, cache, torch.from_numpy(toks).long(), c0, last,
                          torch.from_numpy(bt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    tok, pos = int(np.argmax(np.asarray(jl[0]))), 21
    for _ in range(2):
        jl, jcache = jdec(jp, jcache, jnp.asarray([[tok]], jnp.int32),
                          jnp.asarray([pos], jnp.int32), jnp.asarray(bt))
        tl, cache = dec(p, cache, torch.tensor([[tok]]),
                        torch.tensor([pos], dtype=torch.int32),
                        torch.from_numpy(bt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok, pos = int(np.argmax(np.asarray(jl[0]))), pos + 1


# --------------------------------------------------------------- engines
SB, SLOTS = 64, 3
# (prompt length, max_new_tokens): lengths on both sides of the window of
# 16, the 8-token page and the 16-token chunk, more requests than slots
REQS = [(5, 9), (17, 6), (9, 14), (24, 8), (33, 7)]


def _prompts(vocab, spec):
    rng = np.random.RandomState(3)
    if not spec:
        return [(rng.randint(2, vocab, L).astype(np.int32), m)
                for L, m in REQS]
    shared = rng.randint(2, vocab, 8)
    out = []
    for i, (L, m) in enumerate(REQS):
        motif = rng.randint(2, vocab, 3 + i % 2)
        out.append((np.concatenate([shared, np.tile(motif, 12)[:L]])
                    .astype(np.int32), m))
    return out


def _serve(eng, cls, prompts):
    reqs = [cls(rid=i, prompt=p.copy(), max_new_tokens=m)
            for i, (p, m) in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_ticks=2000)
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs]


@pytest.mark.parametrize("kvd,k", [("float32", 0), ("int8", 0),
                                   ("float32", 3)],
                         ids=["float-pools", "int8-pools", "speculative-3"])
def test_gemma3_paged_engine_matches_jax(gemma3, mesh1, kvd, k):
    """Greedy tokens and ticks against JAX's paged engine in its serial
    loop (no prefix cache); requests run past the window of 16."""
    jcfg, jp, cfg, p = gemma3
    jplan, plan = JaxPlan(tp=1, kv_cache_dtype=kvd), \
        ShardingPlan(kv_cache_dtype=kvd)
    prompts = _prompts(cfg.vocab_size, spec=bool(k))
    assert max(len(pr) + m for pr, m in prompts) > 2 * WIN
    kw = dict(page_size=PSZ, prefill_chunk=CHUNK, speculative=k,
              overlap=False)
    jeng = JaxEngine.build_paged(jcfg, jplan, mesh1, SLOTS, SB, jp,
                                 prefix_cache=False, **kw)
    want = _serve(jeng, JaxRequest, prompts)
    eng = ServingEngine.build_paged(cfg, plan, SLOTS, SB, p, device="cpu",
                                    **kw)
    got = _serve(eng, Request, prompts)
    assert got == want
    assert len({t for r in got for t in r}) > 10            # not degenerate
    assert eng.stats.ticks == jeng.stats.ticks
    if k:
        st, jst = eng.stats, jeng.stats
        assert st.spec_steps > 0
        assert (st.spec_drafted, st.spec_accepted) == \
            (jst.spec_drafted, jst.spec_accepted)
    assert eng.drain() == 0
    assert eng.allocator.n_free == eng.allocator.n_pages - 1


def test_gemma3_contiguous_engine_matches_jax(gemma3, mesh1):
    """The contiguous engine keeps a ring of 16 slots (the window) on the
    window layers, shorter than the budget of 64: greedy tokens, ticks and
    prefills against JAX's contiguous engine."""
    jcfg, jp, cfg, p = gemma3
    plan = ShardingPlan(kv_cache_dtype="float32")
    lanes = steps.zero_cache_for(cfg, plan, SLOTS, SB, "cpu")
    assert [e["kv"]["k"].shape[3] for e in lanes[0]] == [WIN] * 5 + [SB]
    jplan = JaxPlan(tp=1, kv_cache_dtype="float32")
    dec, _, _ = jsteps.make_decode_step(jcfg, jplan, mesh1,
                                        ShapeConfig("s", "decode", SB, SLOTS))
    pre, _, _ = jsteps.make_prefill_step(jcfg, jplan, mesh1,
                                         ShapeConfig("p", "decode", SB, 1))
    jeng = JaxEngine(jcfg, jplan, mesh1, SLOTS, SB, jp, jax.jit(pre),
                     jax.jit(dec))
    prompts = _prompts(cfg.vocab_size, spec=False)
    want = _serve(jeng, JaxRequest, prompts)
    eng = ServingEngine(cfg, plan, SLOTS, SB, p, device="cpu")
    got = _serve(eng, Request, prompts)
    assert got == want
    assert (eng.stats.ticks, eng.stats.prefills) == \
        (jeng.stats.ticks, jeng.stats.prefills)


def test_launcher_serves_gemma3_smoke_on_cpu(capsys):
    serve.main(["--arch", "gemma3-12b", "--smoke", "--device", "cpu",
                "--kv-dtype", "fp32", "--requests", "3", "--slots", "2",
                "--seq-budget", "128", "--paged", "--page-size", "8",
                "--prefill-chunk", "16", "--prompt-len", "80",
                "--max-new", "4"])
    out = capsys.readouterr().out
    assert "arch=gemma3-12b-smoke" in out and "engine=paged" in out
    assert "tokens=12" in out
