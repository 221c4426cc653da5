"""The port's SSM slice against the JAX package: the plain version of the
SSD-scan kernel against the Pallas kernel (interpret mode, float and int8
initial state) and ``kernels/ref.py``, ``core/ssm`` (``causal_conv``,
``ssd_chunked``, ``ssd_decode_step``), ``ssm_mixer`` and the slab scatter
of ``_paged_ssm`` against ``repro.core``, the deterministic SSD-head
inits, the slab pools and allocator, reduced ``mamba2-370m``'s logits and
slabs over prefill chunks and decode steps, and the engine's greedy tokens
against the JAX paged engine, for float32 and int8 slabs.  Also the
refusals (speculation with an SSM arch, an untied head and MoE archs, no
card).

Tolerances: the SSD scan 1e-3 (``tests/test_kernels.py``'s SSD tolerance:
the chunked and sequential forms sum in other orders); fp32 1e-4
elsewhere."""
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import blocks as jblocks
from repro.core import model as jmodel
from repro.core import ssm as jssm
from repro.core import steps as jsteps
from repro.core.kvcache import SlabAllocator as JaxSlabAllocator
from repro.core.partition import ShardingPlan as JaxPlan
from repro.core.partition import model_layout as jax_model_layout
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as pl_ssd_scan
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.core import blocks, model, ssm, steps
from repro_torch.core.kvcache import SlabAllocator, paged_cache_template
from repro_torch.core.partition import (ShardingPlan, model_layout,
                                        ssm_pool_is_quantized)
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as k_ssd
from repro_torch.launch import serve
from repro_torch.serving import Request, ServingEngine

SSD_TOL = dict(rtol=1e-3, atol=1e-3)
FP32_TOL = dict(rtol=1e-4, atol=1e-4)
SLAB_DTYPES = ["", "int8"]       # ShardingPlan.ssm_cache_dtype


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **tol)


def _ssd_case(rng, Bt, S, H, P, N, pad=0):
    """x, dt, B, C, A as float32 numpy; the last ``pad`` rows have dt = 0
    (padding past a prompt's end)."""
    x = rng.randn(Bt, S, H, P).astype(np.float32)
    dt = (np.abs(rng.randn(Bt, S, H)) * 0.1).astype(np.float32)
    if pad:
        dt[:, -pad:] = 0.0
    B = rng.randn(Bt, S, N).astype(np.float32)
    C = rng.randn(Bt, S, N).astype(np.float32)
    A = -(np.abs(rng.rand(H)) * 2 + 0.5).astype(np.float32)
    return x, dt, B, C, A


# ------------------------------------------------------------------ kernel
@pytest.mark.parametrize("S,H,P,N,chunk,pad", [
    (96, 4, 16, 32, 32, 0),        # 3 Pallas chunks; 1.5 of the kernel's 64
    (80, 2, 32, 16, 16, 7),        # 5 Pallas chunks, padded tail rows
    (160, 3, 16, 16, 32, 0),       # 2.5 of the kernel's chunks
])
def test_ssd_scan_plain_matches_pallas_and_ref(S, H, P, N, chunk, pad):
    """y against the Pallas kernel (interpret) and JAX's sequential
    ``ref_ssd_scan``, the final state against the latter, two batch rows."""
    rng = np.random.RandomState(S + H)
    x, dt, B, C, A = _ssd_case(rng, 2, S, H, P, N, pad)
    y, state = ops.ssd_scan(_t(x), _t(dt), _t(B), _t(C), _t(A))
    assert y.shape == (2, S, H, P) and state.shape == (2, H, P, N)
    for b in range(2):
        args = [jnp.asarray(a[b]) for a in (x, dt, B, C)] + [jnp.asarray(A)]
        _close(y[b], pl_ssd_scan(*args, chunk=chunk, interpret=True), SSD_TOL)
        wy, ws = jref.ref_ssd_scan(*args)
        _close(y[b], wy, SSD_TOL)
        _close(state[b], ws, SSD_TOL)


def test_ssd_scan_i8_state0_matches_pallas_i8():
    """An int8 initial state with per-(row, head) scales, one of them 0 (a
    reset head dequantizes to zeros), against Pallas ``_ssd_kernel_i8``
    (as ``tests/test_quantized_cache.py`` calls it) and ``ref_ssd_scan``
    from the dequantized state."""
    rng = np.random.RandomState(3)
    S, H, P, N = 64, 2, 8, 16
    x, dt, B, C, A = _ssd_case(rng, 2, S, H, P, N)
    s0 = rng.randint(-127, 128, (2, H, P, N)).astype(np.int8)
    s0s = (np.abs(rng.randn(2, H)) * 0.02).astype(np.float32)
    s0s[1, 0] = 0.0
    y, state = ops.ssd_scan_i8(_t(x), _t(dt), _t(B), _t(C), _t(A), _t(s0),
                               _t(s0s))
    for b in range(2):
        args = [jnp.asarray(a[b]) for a in (x, dt, B, C)] + [jnp.asarray(A)]
        _close(y[b], pl_ssd_scan(*args, chunk=16, interpret=True,
                                 state0=jnp.asarray(s0[b]),
                                 state0_scale=jnp.asarray(s0s[b])), SSD_TOL)
        wy, ws = jref.ref_ssd_scan(*args, state0=jref.ref_dequant_state(
            jnp.asarray(s0[b]), jnp.asarray(s0s[b])))
        _close(y[b], wy, SSD_TOL)
        _close(state[b], ws, SSD_TOL)


def test_ssd_limits_mirror_the_kernel_source():
    """The wrapper's shape limits are the ones csrc/ssd_scan.cu compiles,
    and the bf16 kernel uses the tensor-core kit of common.cuh."""
    src = (Path(k_ssd.__file__).parent / "csrc" / "ssd_scan.cu").read_text()
    assert re.search(rf"constexpr int Q = {k_ssd.Q_CHUNK};", src)
    assert re.search(rf"constexpr int MMA_MAX_N = {k_ssd.MMA_MAX_N};", src)
    assert re.search(rf"constexpr int MMA_MAX_P = {k_ssd.MMA_MAX_P};", src)
    assert re.search(rf"constexpr int TP = {k_ssd.P_TILE};", src)
    assert re.search(rf"N > {k_ssd.MAX_STATE}\)", src)
    assert "asm" not in src
    assert "mma_bf16(" in src and "ldsm_x4_trans(" in src


# The tensor-core SSD kernel feeds three float32 operands to bf16 mma
# products: W (in x^T W^T, which makes y), the carried state h (in h C^T,
# which makes y) and f o x (in the state update).  Each enters as one bf16
# term (v rounded) or two (hi = bf16(v), lo = bf16(v - hi)).  The helpers
# below emulate one chunk of the chunked form in float64 with each operand
# rounded one way or the other: arithmetic only, not the card.
_TOL_Y, _TOL_STATE = 2e-2, 1e-3


def _rounded(v, terms):
    """v as the mma sees it: one bf16 term, or hi + lo."""
    hi = v.to(torch.bfloat16).double()
    if terms == 1:
        return hi
    return hi + (v - hi).to(torch.bfloat16).double()


def _emulated_chunk(x, dt, B, C, A, h, terms_w, terms_h, terms_u):
    """One chunk, float64, with the kernel's operand rounding.  x: (S, H,
    P); dt: (S, H); B/C: (S, N); h: (H, P, N)."""
    S = x.shape[0]
    cs = torch.cumsum(dt * A[None, :], dim=0)                    # (S, H)
    G = C @ B.T                                                  # exact
    seg = cs[:, None, :] - cs[None, :, :]                        # (i, j, H)
    tri = torch.tril(torch.ones(S, S, dtype=torch.bool))[:, :, None]
    W = torch.where(tri, G[:, :, None] * torch.exp(torch.where(
        tri, seg, torch.zeros_like(seg))) * dt[None, :, :],
        torch.zeros_like(seg))
    y = torch.einsum("ijh,jhp->ihp", _rounded(W, terms_w), x)
    y = y + torch.einsum("in,hpn->ihp", C, _rounded(h, terms_h)) * \
        torch.exp(cs)[:, :, None]
    f = torch.exp(cs[-1][None, :] - cs) * dt                     # (S, H)
    u = _rounded(f[:, :, None] * x, terms_u)                     # (S, H, P)
    h = h * torch.exp(cs[-1])[:, None, None] + \
        torch.einsum("jhp,jn->hpn", u, B)
    return y, h


def _excess(got, want, tol):
    """The largest |got - want| beyond atol = rtol = tol (<= 0 passes)."""
    return ((got - want).abs() - tol - tol * want.abs()).max().item()


@pytest.mark.parametrize("terms,misses", [
    ((2, 2, 2), None),           # every float32 operand as two terms
    ((2, 1, 2), "y"),            # the state in h C^T as one term
    ((2, 2, 1), "state"),        # f o x in the update as one term
], ids=["two-terms", "state-one-term", "fx-one-term"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ssd_bf16_operands_need_two_terms(seed, terms, misses):
    """The bf16 kernel's operand rounding (csrc/ssd_scan.cu), emulated in
    float64 at the serve chunk (S 32, H 32, P 64, N 128) with chip_smoke's
    input distribution and a float32 state0 ~ N(0, 1): with every float32
    operand as two bf16 terms y meets bf16's 2e-2 and the final state
    float32's 1e-3 against the plain version; the state as one term misses
    y's tolerance, f o x as one term the final state's."""
    g = torch.Generator().manual_seed(seed)
    S, H, P, N = 32, 32, 64, 128
    x = torch.randn(1, S, H, P, generator=g).to(torch.bfloat16).double()
    dt = 0.1 * torch.randn(1, S, H, generator=g).abs().double()
    B = torch.randn(1, S, N, generator=g).to(torch.bfloat16).double()
    C = torch.randn(1, S, N, generator=g).to(torch.bfloat16).double()
    A = -(torch.randn(H, generator=g).abs() + 0.5).double()
    h0 = torch.randn(1, H, P, N, generator=g).double()
    wy, wst = ops.ssd_scan(x, dt, B, C, A, h0)
    y, st = _emulated_chunk(x[0], dt[0], B[0], C[0], A, h0[0], *terms)
    ey = _excess(y.to(torch.bfloat16).double(),
                 wy[0].to(torch.bfloat16).double(), _TOL_Y)
    es = _excess(st, wst[0], _TOL_STATE)
    assert (ey > 0) == (misses == "y")
    assert (es > 0) == (misses == "state")


@pytest.mark.parametrize("shape,dtype", [
    ((32, 64, 100), torch.bfloat16),    # N not a multiple of 16
    ((32, 64, 256), torch.bfloat16),    # N past one warp's registers
    ((32, 144, 128), torch.bfloat16),   # more than 8 warps
    ((32, 24, 128), torch.float32),     # P not a multiple of 16
    ((32, 64, 300), torch.float32),     # N past shared memory
    ((0, 64, 128), torch.float32),
    ((32, 64, 128), torch.float16),
])
def test_ssd_scan_refuses_what_the_kernels_cannot_take(shape, dtype):
    with pytest.raises(ValueError):
        k_ssd.check_shape(*shape, dtype)


# --------------------------------------------------------------- core/ssm
@pytest.mark.parametrize("quant", [False, True], ids=["f32-state0", "i8-state0"])
def test_ssd_chunked_from_state0_matches_jax(quant):
    """A prefill chunk carried on from a slab's state: y with the D skip
    term and the final state, against JAX ``ssd_chunked(state0=...)`` (the
    int8 state dequantized first, as the JAX model path does)."""
    rng = np.random.RandomState(4)
    Bt, S, H, P, N = 2, 40, 3, 16, 16
    x, dt, B, C, A = _ssd_case(rng, Bt, S, H, P, N, pad=5)
    D = rng.randn(H).astype(np.float32)
    if quant:
        s0 = rng.randint(-127, 128, (Bt, H, P, N)).astype(np.int8)
        s0s = (np.abs(rng.randn(Bt, H)) * 0.02).astype(np.float32)
        y, state = ssm.ssd_chunked(_t(x), _t(dt), _t(B), _t(C), _t(A), _t(D),
                                   state0=_t(s0), state0_scale=_t(s0s))
        j_s0 = jnp.asarray(s0, jnp.float32) * jnp.asarray(s0s)[:, :, None, None]
    else:
        s0 = rng.randn(Bt, H, P, N).astype(np.float32)
        y, state = ssm.ssd_chunked(_t(x), _t(dt), _t(B), _t(C), _t(A), _t(D),
                                   state0=_t(s0))
        j_s0 = jnp.asarray(s0)
    wy, ws = jssm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, B, C, A, D)),
                              32, state0=j_s0)
    _close(y, wy, SSD_TOL)
    _close(state, ws, SSD_TOL)


@pytest.mark.parametrize("with_state,tail", [
    (False, None), (True, None), (True, 0), (True, 5), (True, 8)])
def test_causal_conv_matches_jax(with_state, tail):
    """Zero or carried history, and the new history cut at the last valid
    row (``tail_idx``) anywhere in the chunk."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 9, 12).astype(np.float32)
    w = rng.randn(12, 4).astype(np.float32)
    st = rng.randn(2, 3, 12).astype(np.float32) if with_state else None
    y, new = ssm.causal_conv(_t(x), _t(w), None if st is None else _t(st),
                             tail)
    wy, wnew = jssm.causal_conv(jnp.asarray(x), jnp.asarray(w),
                                None if st is None else jnp.asarray(st), tail)
    _close(y, wy, FP32_TOL)
    _close(new, wnew, FP32_TOL)


def test_ssd_decode_step_matches_jax():
    rng = np.random.RandomState(6)
    Bt, H, P, N = 3, 4, 16, 8
    x, dt, B, C, A = _ssd_case(rng, Bt, 1, H, P, N)
    D = rng.randn(H).astype(np.float32)
    s0 = rng.randn(Bt, H, P, N).astype(np.float32)
    y, state = ssm.ssd_decode_step(_t(x[:, 0]), _t(dt[:, 0]), _t(B[:, 0]),
                                   _t(C[:, 0]), _t(A), _t(D), _t(s0))
    wy, ws = jssm.ssd_decode_step(*(jnp.asarray(a) for a in (
        x[:, 0], dt[:, 0], B[:, 0], C[:, 0], A, D, s0)))
    _close(y, wy, FP32_TOL)
    _close(state, ws, FP32_TOL)


# ------------------------------------------------------------------ blocks
@pytest.fixture(scope="module")
def ssm_weights():
    """JAX's init for reduced mamba2-370m in fp32 (2 layers, d_model 128,
    16 SSD heads of 16, state 16), and the port's copy through the bridge.
    The weights do not depend on the slab dtype."""
    jcfg = jax_reduced(jax_get_config("mamba2-370m"), dtype="float32")
    jp = jmodel.init_params(jcfg, JaxPlan(tp=1, kv_cache_dtype="float32"))
    cfg = reduced(get_config("mamba2-370m"), dtype="float32")
    params = params_from_jax(cfg, ShardingPlan(kv_cache_dtype="float32"),
                             jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")
    return jcfg, jp, cfg, params


def _plans(ssm_dtype):
    return (JaxPlan(tp=1, kv_cache_dtype="float32", ssm_cache_dtype=ssm_dtype),
            ShardingPlan(kv_cache_dtype="float32", ssm_cache_dtype=ssm_dtype))


def _layer0(jp, params):
    """Repetition 0 of layer group 0's SSM params: JAX's with the tp axis
    (``_lo`` strips it), the port's without."""
    jps = jax.tree_util.tree_map(lambda a: a[0], jp["stacks"][0][0]["ssm"])
    ps = model.tree_map(lambda a: a[0], params["stacks"][0][0]["ssm"])
    return jps, ps


def _mixer_case(rng, cfg, B, S):
    H = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    P, N, K = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv
    xn = rng.randn(B, S, cfg.d_model).astype(np.float32)
    cache = {"state": rng.randn(B, H, P, N).astype(np.float32) * 0.5,
             "conv_x": rng.randn(B, K - 1, H * P).astype(np.float32),
             "conv_B": rng.randn(B, K - 1, N).astype(np.float32),
             "conv_C": rng.randn(B, K - 1, N).astype(np.float32)}
    return xn, cache


@pytest.mark.parametrize("mode", ["decode", "prefill"])
def test_ssm_mixer_matches_jax(ssm_weights, mesh1, mode):
    """One decode token for three lanes, or one 8-row prefill chunk whose
    last three rows are padding (``chunk_last_idx`` 4), from a carried
    state and conv history: the output and the new state and tails."""
    jcfg, jp, cfg, params = ssm_weights
    jplan, plan = _plans("")
    jsteps.prepare_ledger(mesh1)
    jps, ps = _layer0(jp, params)
    B, S, last = (3, 1, None) if mode == "decode" else (1, 8, 4)
    xn, cache = _mixer_case(np.random.RandomState(7), cfg, B, S)
    out, new = blocks.ssm_mixer(_t(xn), ps, cfg, model_layout(cfg, plan),
                                mode, {k: _t(v) for k, v in cache.items()},
                                chunk_last_idx=last)
    jout, jnew = jblocks.ssm_mixer(
        jnp.asarray(xn), jps, jcfg, jplan, jax_model_layout(jcfg, jplan), mode,
        {k: jnp.asarray(v) for k, v in cache.items()}, chunk_last_idx=last)
    _close(out, jout, FP32_TOL)
    for k in ("conv_x", "conv_B", "conv_C"):
        _close(new[k], jnew[k], FP32_TOL)
    _close(new["state"], jnew["state"],
           FP32_TOL if mode == "decode" else SSD_TOL)


@pytest.mark.parametrize("ssm_dtype", SLAB_DTYPES, ids=["f32-slabs", "i8-slabs"])
@pytest.mark.parametrize("mode", ["decode", "prefill"])
def test_paged_ssm_slab_update_matches_jax(ssm_weights, mesh1, mode,
                                           ssm_dtype):
    """``_paged_ssm`` over slab pools: gather by slab id (a decode batch
    with an idle lane on scratch slab 0), run, scatter; the output and the
    live slabs after it (int8 payloads re-quantized per (slab, head))."""
    jcfg, jp, cfg, params = ssm_weights
    jplan, plan = _plans(ssm_dtype)
    jsteps.prepare_ledger(mesh1)
    jps, ps = _layer0(jp, params)
    rng = np.random.RandomState(8)
    n_slabs = 5
    _, pools = _mixer_case(rng, cfg, n_slabs, 1)
    pools = {k + "p": v for k, v in pools.items()}
    if ssm_dtype == "int8":
        H = pools["statep"].shape[1]
        pools["statep"] = rng.randint(-127, 128, pools["statep"].shape
                                      ).astype(np.int8)
        pools["sscalep"] = (np.abs(rng.randn(n_slabs, H)) * 0.01
                            ).astype(np.float32)
    if mode == "decode":
        sid = np.asarray([3, 0, 1], np.int32)
        xn = rng.randn(3, 1, cfg.d_model).astype(np.float32)
        pages = {"slab_ids": sid}
    else:
        sid = np.asarray([2], np.int32)
        xn = rng.randn(1, 8, cfg.d_model).astype(np.float32)
        pages = {"slab_ids": sid, "last_idx": 5}
    tpools = {k: _t(v.copy()) for k, v in pools.items()}
    out, tpools = blocks._paged_ssm(
        _t(xn), ps, cfg, model_layout(cfg, plan), mode, tpools,
        {k: _t(v) if isinstance(v, np.ndarray) else v
         for k, v in pages.items()})
    jout, jpools = jblocks._paged_ssm(
        jnp.asarray(xn), jps, jcfg, jplan, jax_model_layout(jcfg, jplan), mode,
        {k: jnp.asarray(v) for k, v in pools.items()},
        {k: jnp.asarray(v) for k, v in pages.items()})
    _close(out, jout, FP32_TOL)
    live = [s for s in sid if s != 0]
    for k, v in tpools.items():
        ours, theirs = v[live].float().numpy(), np.asarray(jpools[k])[live]
        if k == "statep" and ssm_dtype == "int8":  # a rounding tie may differ
            assert np.abs(ours - theirs.astype(np.float32)).max() <= 1
            assert (ours != theirs).mean() < 1e-3
        else:
            np.testing.assert_allclose(ours, theirs.astype(np.float32),
                                       **(SSD_TOL if k in ("statep", "sscalep")
                                          else FP32_TOL))
    untouched = [s for s in range(1, n_slabs) if s not in live]
    for k, v in tpools.items():
        np.testing.assert_array_equal(v[untouched].numpy(), pools[k][untouched])


# ------------------------------------------------------------ params, cache
def test_deterministic_ssm_inits_match_jax():
    """``D`` is exactly ones, in the weight dtype; ``A_log`` and
    ``dt_bias`` equal JAX's to within float32 rounding (atol 1e-6: XLA's
    fused ``linspace`` and its own exp/log round differently from any other
    float32 code, so bitwise equality is out of reach) and stay float32
    under bf16 weights."""
    jcfg = jax_reduced(jax_get_config("mamba2-370m"))
    cfg = reduced(get_config("mamba2-370m"))
    jp = jmodel.init_params(jcfg, JaxPlan(tp=1))
    p = model.init_params(cfg, ShardingPlan(), device="cpu")
    jssm_p = jp["stacks"][0][0]["ssm"]
    tssm_p = p["stacks"][0][0]["ssm"]
    assert tssm_p["in_x"].dtype == torch.bfloat16
    for name in ("A_log", "D", "dt_bias"):
        theirs = np.asarray(jssm_p[name])[:, 0]              # strip tp axis
        ours = tssm_p[name]
        assert ours.shape == theirs.shape
        if name == "D":
            assert ours.dtype == torch.bfloat16
            np.testing.assert_array_equal(ours.float().numpy(),
                                          theirs.astype(np.float32))
        else:
            assert ours.dtype == torch.float32
            np.testing.assert_allclose(ours.numpy(), theirs, rtol=0,
                                       atol=1e-6)


@pytest.mark.parametrize("ssm_dtype", SLAB_DTYPES, ids=["f32-slabs", "i8-slabs"])
def test_slab_pools_template(ssm_dtype):
    """A pure SSM model has slab pools and no KV pools; int8 slabs add one
    float32 scale per (slab, head)."""
    cfg = reduced(get_config("mamba2-370m"))
    plan = ShardingPlan(ssm_cache_dtype=ssm_dtype)
    assert ssm_pool_is_quantized(plan) == (ssm_dtype == "int8")
    tmpl = paged_cache_template(cfg, plan, model_layout(cfg, plan), 9, 8,
                                n_slabs=3)
    entry = tmpl[0][0]
    assert set(entry) == {"ssm"}
    L, H, P, N, K = cfg.n_layers, 16, 16, 16, cfg.ssm_conv
    want = {"statep": ((L, 3, H, P, N),
                       torch.int8 if ssm_dtype else torch.float32),
            "conv_xp": ((L, 3, K - 1, H * P), torch.bfloat16),
            "conv_Bp": ((L, 3, K - 1, N), torch.bfloat16),
            "conv_Cp": ((L, 3, K - 1, N), torch.bfloat16)}
    if ssm_dtype:
        want["sscalep"] = ((L, 3, H), torch.float32)
    assert entry["ssm"] == want
    with pytest.raises(ValueError, match="n_slabs"):
        paged_cache_template(cfg, plan, model_layout(cfg, plan), 9, 8)


def test_slab_allocator_matches_jax():
    ours, theirs = SlabAllocator(4), JaxSlabAllocator(4)

    def both(method, *args):
        a, b = getattr(ours, method)(*args), getattr(theirs, method)(*args)
        assert a == b, (method, args, a, b)
        return a

    got = [both("alloc") for _ in range(4)]
    assert got == [1, 2, 3, None]
    both("free", 2)
    assert both("alloc") == 2
    both("free", 1)
    assert ours.n_free == theirs.n_free == 1
    assert ours.total_allocated == theirs.total_allocated == 4
    with pytest.raises(AssertionError, match="reserved"):
        ours.free(0)
    with pytest.raises(AssertionError, match="double free"):
        ours.free(1)


# -------------------------------------------------------------------- model
@pytest.mark.parametrize("ssm_dtype", SLAB_DTYPES, ids=["f32-slabs", "i8-slabs"])
def test_prefill_chunks_then_decode_match_jax(ssm_weights, mesh1, ssm_dtype):
    """Logits after two prefill chunks (the second padded past the prompt)
    and three decode steps beside an idle lane, and the request's slab
    (state, conv tails, scales) after them."""
    CH, N_MAX, N_PAGES, PSZ, N_SLABS, B, SLAB = 8, 4, 9, 8, 3, 2, 2
    jcfg, jp, cfg, params = ssm_weights
    jplan, plan = _plans(ssm_dtype)
    jchunk, _, _ = jsteps.make_prefill_chunk_step(
        jcfg, jplan, mesh1, CH, N_PAGES, PSZ, N_MAX, n_slabs=N_SLABS)
    jdec, _, _ = jsteps.make_paged_decode_step(
        jcfg, jplan, mesh1, B, N_PAGES, PSZ, N_MAX, n_slabs=N_SLABS)
    jchunk, jdec = jax.jit(jchunk), jax.jit(jdec)
    jcache = jsteps.zero_paged_cache_for(jcfg, jplan, mesh1, N_PAGES, PSZ,
                                         n_slabs=N_SLABS)
    chunk = steps.make_prefill_chunk_step(cfg, plan, CH, N_MAX)
    dec = steps.make_paged_decode_step(cfg, plan, B, N_MAX)
    cache = steps.zero_paged_cache_for(cfg, plan, N_PAGES, PSZ, "cpu",
                                       N_SLABS)
    prompt = np.random.RandomState(0).randint(2, cfg.vocab_size, 13)
    L = len(prompt)
    bt = np.zeros((1, N_MAX), np.int32)
    for c0 in range(0, L, CH):
        toks = np.zeros((1, CH), np.int32)
        toks[0, :min(CH, L - c0)] = prompt[c0:c0 + CH]
        last = min(L - 1 - c0, CH - 1)
        jl, jcache = jchunk(jp, jcache, jnp.asarray(toks),
                            jnp.asarray([c0], jnp.int32),
                            jnp.asarray([last], jnp.int32), jnp.asarray(bt),
                            jnp.asarray([SLAB], jnp.int32))
        tl, cache = chunk(params, cache, _t(toks).long(), c0, last, _t(bt),
                          torch.tensor([SLAB], dtype=torch.int32))
        _close(tl, jl, FP32_TOL)
    tok, pos = int(np.argmax(np.asarray(jl[0]))), L
    sid = np.asarray([SLAB, 0], np.int32)           # lane 1 idle: scratch slab
    bt2 = np.zeros((B, N_MAX), np.int32)
    for _ in range(3):
        toks = np.asarray([[tok], [0]], np.int32)
        pos_v = np.asarray([pos, 0], np.int32)
        jl, jcache = jdec(jp, jcache, jnp.asarray(toks), jnp.asarray(pos_v),
                          jnp.asarray(bt2), jnp.asarray(sid))
        tl, cache = dec(params, cache, _t(toks).long(), _t(pos_v), _t(bt2),
                        _t(sid))
        _close(tl[0:1], jl[0:1], FP32_TOL)
        tok, pos = int(np.argmax(np.asarray(jl[0]))), pos + 1
    for name, pool in cache[0][0]["ssm"].items():
        ours = pool[:, SLAB].float().numpy()
        theirs = np.asarray(jcache[0][0]["ssm"][name])[:, 0, SLAB]
        if name == "statep" and ssm_dtype == "int8":
            assert np.abs(ours - theirs.astype(np.float32)).max() <= 1
            assert (ours != theirs).mean() < 1e-3
        else:
            np.testing.assert_allclose(ours, theirs, **FP32_TOL)


# ------------------------------------------------------------------- engine
SB, SLOTS, PSZ, CHUNK = 32, 2, 8, 8
REQS = [(5, 6), (9, 4), (17, 5), (12, 3)]       # tests/test_arch_serving.py


def _requests(vocab):
    rng = np.random.RandomState(0)
    return [(rid, rng.randint(2, vocab, L).astype(np.int32), m)
            for rid, (L, m) in enumerate(REQS)]


@pytest.fixture(scope="module")
def jax_engine_tokens(ssm_weights, mesh1):
    """The JAX paged engine (serial loop) on reduced mamba2, once per slab
    dtype: -> {ssm_cache_dtype: (tokens per request, ticks)}."""
    jcfg, jp, cfg, _ = ssm_weights
    out = {}
    for ssm_dtype in SLAB_DTYPES:
        jplan, _ = _plans(ssm_dtype)
        eng = JaxEngine.build_paged(jcfg, jplan, mesh1, SLOTS, SB, jp,
                                    page_size=PSZ, prefill_chunk=CHUNK,
                                    overlap=False)
        reqs = [JaxRequest(rid=r, prompt=p, max_new_tokens=m)
                for r, p, m in _requests(cfg.vocab_size)]
        for r in reqs:
            eng.submit(r)
        eng.run(max_ticks=2000)
        assert all(r.done for r in reqs)
        out[ssm_dtype] = ([r.out_tokens for r in reqs], eng.stats.ticks)
    return out


@pytest.mark.parametrize("ssm_dtype", SLAB_DTYPES, ids=["f32-slabs", "i8-slabs"])
def test_engine_greedy_tokens_identical_to_jax(ssm_weights, jax_engine_tokens,
                                               ssm_dtype):
    """Four requests on two slots (the queue waits for a slab), prompts
    crossing the 8-token chunk; every slab free after drain() and no page
    ever handed out (a pure SSM model has no KV pool)."""
    _, _, cfg, params = ssm_weights
    _, plan = _plans(ssm_dtype)
    eng = ServingEngine.build_paged(cfg, plan, SLOTS, SB, params,
                                    page_size=PSZ, prefill_chunk=CHUNK,
                                    overlap=False, device="cpu")
    assert eng.has_slabs and eng.n_slabs == SLOTS + 1 and not eng.quant_pools
    admitted = []
    plan_fn = eng.sched.plan

    def recording_plan(free):
        out = plan_fn(free)
        admitted.extend(out)
        return out

    eng.sched.plan = recording_plan
    reqs = [Request(rid=r, prompt=p, max_new_tokens=m)
            for r, p, m in _requests(cfg.vocab_size)]
    for r in reqs:
        eng.submit(r)
    stats = eng.run(max_ticks=2000)
    want, ticks = jax_engine_tokens[ssm_dtype]
    assert all(r.done for r in reqs)
    assert [r.out_tokens for r in reqs] == want
    assert stats.ticks == ticks
    assert len({t for r in reqs for t in r.out_tokens}) > 10
    assert len(admitted) == len(REQS)
    assert all(a.pages == [] and a.slab in (1, 2) for a in admitted)
    assert eng.drain() == 0
    assert eng.slab_allocator.n_free == eng.n_slabs - 1
    assert eng.slab_allocator.total_allocated == len(REQS)
    assert eng.allocator.n_free == eng.allocator.n_pages - 1


def test_admission_zeroes_the_slab(ssm_weights):
    """A slab reused by a new request starts from zeros: the previous
    owner's state and conv tails do not leak into it."""
    _, _, cfg, params = ssm_weights
    eng = ServingEngine.build_paged(cfg, ShardingPlan(kv_cache_dtype="float32"),
                                    1, SB, params, page_size=PSZ,
                                    prefill_chunk=CHUNK, device="cpu")
    for pool in eng.cache[0][0]["ssm"].values():
        pool[:, 1] = 1
    eng.submit(Request(rid=0, prompt=np.arange(2, 5, dtype=np.int32),
                       max_new_tokens=1))
    seen = {}
    prefill = eng.prefill_fn

    def spy(params_, cache, *args):
        seen.update({k: v[:, 1].clone() for k, v in cache[0][0]["ssm"].items()})
        return prefill(params_, cache, *args)

    eng.prefill_fn = spy
    eng.run()
    assert seen and all(not v.any() for v in seen.values())


def test_launcher_serves_mamba2_on_cpu(capsys):
    assert serve.main(["--arch", "mamba2-370m", "--smoke", "--requests", "3",
                       "--slots", "2", "--seq-budget", "64", "--prompt-len",
                       "20", "--max-new", "4", "--page-size", "8",
                       "--prefill-chunk", "16", "--kv-dtype", "int8",
                       "--paged", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "arch=mamba2-370m-smoke" in out and "tokens=12" in out
    assert "ssm_slabs: slabs=2 allocated=3 free=2" in out


# ----------------------------------------------------------------- refusals
def test_speculation_is_refused_for_ssm_archs(ssm_weights, capsys):
    _, _, cfg, params = ssm_weights
    plan = ShardingPlan(kv_cache_dtype="float32")
    with pytest.raises(ValueError, match="speculative decoding is unsupported"):
        ServingEngine.build_paged(cfg, plan, 2, SB, params, page_size=PSZ,
                                  prefill_chunk=CHUNK, speculative=2,
                                  device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        steps.make_verify_step(cfg, plan, 2, 3, 4)
    with pytest.raises(SystemExit) as e:
        serve.parse_args(["--arch", "mamba2-370m", "--speculative", "2"])
    assert e.value.code == 2
    assert "SSM recurrences" in capsys.readouterr().err


@pytest.mark.parametrize("change,slice_", [
    (dict(frontend="vision_patches"), "the token-only chunked prefill step "
                                      "cannot carry them (ROADMAP Queue 1 "
                                      "items 5 and 13)"),
    (dict(frontend="audio_frames"), "a frontend other than an enc-dec "
                                    "arch's audio frames"),
])
def test_hybrid_and_moe_archs_name_their_slice(change, slice_):
    cfg = dataclasses.replace(reduced(get_config("tinyllama-42m")), **change)
    with pytest.raises(NotImplementedError, match=re.escape(slice_)):
        model.init_params(cfg, ShardingPlan(), device="cpu")


def test_ssm_entry_points_refuse_cuda_without_a_card(ssm_weights, monkeypatch):
    _, _, cfg, params = ssm_weights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine.build_paged(cfg, ShardingPlan(), 2, SB, params,
                                  page_size=PSZ, prefill_chunk=CHUNK)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_params(cfg, ShardingPlan())
    with pytest.raises(ValueError, match="CUDA tensor"):       # no fallback
        k_ssd.ssd_scan(*(torch.zeros(s) for s in (
            (1, 4, 2, 16), (1, 4, 2), (1, 4, 8), (1, 4, 8), (2,))))
