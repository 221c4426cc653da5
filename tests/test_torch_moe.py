"""The mixture-of-experts FFN in the port against the JAX package on the
same numpy inputs: the config copies (deepseek-moe-16b, mixtral-8x22b),
the plan's and layout's MoE fields, the MoE leaves through
``bridge.params_from_jax``, every function of ``core/moe.py`` against
``repro.core.moe`` (routed indices, drops and slots exactly; a row of exact
ties routed as ``lax.top_k`` routes it; drops forced by a small capacity
factor and a skewed router; ``moe_ffn_ep`` at tp=1), the expert matmul's
plain version against ``einsum`` with NaN past the counts, its launcher
(no fallback), the logits of every step and the engines' greedy tokens:
the paged engine serial and pipelined, the contiguous engine, speculation
(k = 2, against JAX's speculative engine: capacity drops depend on the
verify step's row count), one int8-pool run, one prefix-cache run, and a
run whose prefill chunks drop pairs.  At ``reduced()``: 2 layers, d_model
128, 8 experts of 64, top-2 (deepseek: the first layer dense, 1 shared
expert; mixtral: a window of 64, no shared expert), JAX's weights x10.
Tolerances: fp32 1e-4, bf16 2e-2 (``tests/test_kernels.py``)."""
import contextlib
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import ShapeConfig
from repro.core import model as jmodel
from repro.core import moe as jmoe
from repro.core import steps as jsteps
from repro.core.partition import ShardingPlan as JaxPlan
from repro.core.partition import model_layout as jax_model_layout
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.core import model, moe, steps
from repro_torch.core.partition import ShardingPlan, model_layout
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import matmul as k_matmul
from repro_torch.launch import serve
from repro_torch.serving import Request, ServingEngine

TOL = dict(rtol=1e-4, atol=1e-4)
BF_TOL = dict(rtol=2e-2, atol=2e-2)
ARCHS = ("deepseek-moe-16b", "mixtral-8x22b")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _shape(c):
    return {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}


@pytest.fixture(scope="module")
def moe_weights():
    """Each arch reduced in fp32 from JAX's init, weights x10 (greedy
    decoding does not collapse onto one token), and the port's copy
    through the bridge."""
    out = {}
    for arch in ARCHS:
        jcfg = jax_reduced(jax_get_config(arch), dtype="float32")
        jp = jax.tree_util.tree_map(
            lambda a: a * 10,
            jmodel.init_params(jcfg, JaxPlan(tp=1, kv_cache_dtype="float32")))
        cfg = reduced(get_config(arch), dtype="float32")
        out[arch] = (jcfg, jp, cfg, params_from_jax(
            cfg, ShardingPlan(kv_cache_dtype="float32"), _np_tree(jp),
            device="cpu"))
    return out


def _moe_leaves(jp, cfg):
    """The MoE layer's FFN leaves of the last pattern entry, first rep:
    JAX's (tp axis stripped, as its ``ffn_sublayer`` does) and the port's."""
    jf = jp["stacks"][0][-1]["ffn"]
    pf = {"router": {"w": jnp.asarray(jf["router"]["w"][0])},
          "experts": {k: jnp.asarray(v[0, 0]) for k, v in jf["experts"].items()}}
    tf = {"router": {"w": torch.from_numpy(np.array(pf["router"]["w"]))},
          "experts": {k: torch.from_numpy(np.array(v))
                      for k, v in pf["experts"].items()}}
    return pf, tf


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_copies_of_jax_s(arch):
    """Every field the port's config has equals JAX's, full and reduced,
    and the layer specs agree (deepseek's first layer dense)."""
    for ours, theirs in ((get_config(arch), jax_get_config(arch)),
                         (reduced(get_config(arch)),
                          jax_reduced(jax_get_config(arch)))):
        want = _shape(theirs)
        assert {k: want[k] for k in _shape(ours)} == _shape(ours)
        assert [(s.ffn, s.d_ff, s.attn) for s in ours.layer_specs()] == \
            [(s.ffn, s.d_ff, s.attn) for s in theirs.layer_specs()]


def test_deepseek_fits_one_card_whole():
    """deepseek-moe-16b's template counts JAX's ``param_count``,
    16,375,728,128 parameters (16,375,611,392 besides the 57 norm scales;
    32.75 GB of bf16), 29.90 GB of them the routed experts of its 27 MoE
    layers: counted from the template, nothing allocated."""
    cfg = get_config("deepseek-moe-16b")
    leaves = {path: math.prod(spec.full) * max(reps, 1)
              for path, (spec, reps) in _template_leaves(cfg)}
    assert sum(leaves.values()) == jax_get_config(cfg.name).param_count() \
        == 16_375_728_128
    assert sum(v for k, v in leaves.items() if "ln" not in k and
               "norm" not in k) == 16_375_611_392
    routed = sum(v for k, v in leaves.items() if ".experts." in k)
    assert routed == 27 * 64 * 3 * 2048 * 1408
    assert 2 * routed / 1e9 == pytest.approx(29.90, abs=0.005)
    assert 2 * sum(leaves.values()) / 1e9 == pytest.approx(32.75, abs=0.005)


def _template_leaves(cfg):
    out = []

    def walk(node, path):
        if isinstance(node, tuple):
            out.append((path, node))
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}")
        else:
            for i, v in enumerate(node):
                walk(v, f"{path}.{i}")

    walk(model.map_template(cfg, lambda s, r: (s, r)), "")
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["tp", "ep"])
def test_plan_and_layout_match_jax_at_tp1(arch, mode):
    """``moe_mode``/``moe_capacity`` default as JAX's; the layout's FFN
    widths are JAX's tp=1 ones (the experts' count only in "ep")."""
    assert (ShardingPlan().moe_mode, ShardingPlan().moe_capacity) == \
        (JaxPlan().moe_mode, JaxPlan().moe_capacity)
    cfg = get_config(arch)
    ours = model_layout(cfg, ShardingPlan(moe_mode=mode))
    theirs = jax_model_layout(jax_get_config(arch), JaxPlan(tp=1,
                                                            moe_mode=mode))
    for f in ("ffn", "moe_ffn", "shared_ffn", "dense_override_ffn",
              "experts"):
        a, b = getattr(ours, f), getattr(theirs, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert (a.n, a.tp, a.n_pad, a.loc) == (b.n, b.tp, b.n_pad, b.loc)
    with pytest.raises(ValueError, match="moe_mode 'a2a'"):
        ShardingPlan(moe_mode="a2a")


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_maps_the_moe_leaves(moe_weights, arch):
    """JAX's (reps, 1, n, E, F) expert leaves lose their tp axis; the
    router (reps, E, n) and the shared experts map as they are; the
    port's own init builds the same tree."""
    jcfg, jp, cfg, p = moe_weights[arch]
    n, E, F = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    jf, tf = jp["stacks"][0][-1]["ffn"], p["stacks"][0][-1]["ffn"]
    reps = cfg.layer_groups()[0].n_reps
    assert np.asarray(jf["experts"]["w_gate"]).shape == (reps, 1, n, E, F)
    assert tuple(tf["experts"]["w_gate"].shape) == (reps, n, E, F)
    assert tuple(tf["experts"]["w_down"].shape) == (reps, n, F, E)
    assert tuple(tf["router"]["w"].shape) == (reps, E, n)
    np.testing.assert_array_equal(tf["experts"]["w_down"].numpy(),
                                  np.asarray(jf["experts"]["w_down"])[:, 0])
    assert ("shared" in tf) == bool(cfg.n_shared_experts)
    if cfg.n_shared_experts:
        assert tuple(tf["shared"]["w_up"].shape) == (reps, E, F)
    ours = model.init_params(cfg, ShardingPlan(), device="cpu")
    assert [(k, tuple(v.shape)) for k, v in model.tree_paths(ours)] == \
        [(k, tuple(v.shape)) for k, v in model.tree_paths(p)]


# -------------------------------------------------------------- functions
def test_capacity_matches_jax():
    for T in (1, 5, 8, 16, 17, 32, 40, 64, 160, 1000):
        for k, n in ((6, 64), (2, 8), (1, 4)):
            for f in (1.25, 0.3, 2.0):
                assert moe._capacity(T, k, n, f) == jmoe._capacity(T, k, n, f)
    # deepseek: decode at 8 slots, a chunk of 32, a verify of 8 x 5 rows
    assert [moe._capacity(T, 6, 64, 1.25) for T in (8, 32, 40)] == [8, 16, 16]


@pytest.mark.parametrize("arch", ARCHS)
def test_router_topk_matches_jax(moe_weights, arch):
    jcfg, jp, cfg, _ = moe_weights[arch]
    pf, tf = _moe_leaves(jp, cfg)
    x = np.random.RandomState(1).randn(37, cfg.d_model).astype(np.float32)
    jg, ji = jmoe.router_topk(jnp.asarray(x), pf["router"]["w"], cfg.top_k,
                              cfg.n_experts)
    tg, ti = moe.router_topk(torch.from_numpy(x), tf["router"]["w"],
                             cfg.top_k, cfg.n_experts)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)
    assert tg.dtype == torch.float32


def test_router_topk_takes_the_lowest_index_among_exact_ties():
    """Experts 2, 5 and 7 have the same router column, so every row's
    probabilities tie exactly there; a zero row ties all n.  Both sides
    take the lowest index first (``lax.top_k``), at k 2 and 6."""
    rng = np.random.RandomState(3)
    E, n = 16, 8
    w = rng.randn(E, n).astype(np.float32)
    w[:, 2] *= 3.0
    w[:, 5] = w[:, 2]
    w[:, 7] = w[:, 2]
    x = rng.randn(6, E).astype(np.float32)
    x[:, :] = np.sign(x @ w[:, 2])[:, None] * x      # the tie column on top
    x[0] = 0.0                                       # every expert ties
    for k in (2, 6):
        jg, ji = jmoe.router_topk(jnp.asarray(x), jnp.asarray(w), k, n)
        tg, ti = moe.router_topk(torch.from_numpy(x), torch.from_numpy(w), k, n)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                                   atol=1e-6)
        assert ti[0].tolist() == list(range(k))
    probs = torch.softmax(torch.from_numpy(x @ w), -1)
    tied = probs[:, 2] == probs[:, 5]
    assert bool(tied.all()) and bool((probs[:, 5] == probs[:, 7]).all())
    top = [r for r in range(1, 6) if int(probs[r].argmax()) in (2, 5, 7)]
    assert top and all(ti[r, :3].tolist() == [2, 5, 7] for r in top)


def _skewed_router(w, boost):
    """A router whose columns 0 and 1 lean along the same direction, so
    most rows send a pair to them (drops at a small capacity)."""
    w = np.array(w, np.float32)
    d = np.random.RandomState(9).randn(w.shape[0]).astype(np.float32)
    w[:, 0] += boost * d
    w[:, 1] += boost * d
    return w


@pytest.mark.parametrize("case", ["default", "drops"])
def test_bucket_by_expert_matches_jax(case):
    """Slots, gates, keep flags (per pair, in JAX's sorted order) and
    buckets equal JAX's exactly (pure data movement), and ``fill`` counts
    each bucket's rows; the combine of given expert outputs too.  In
    "drops", 30 rows route mostly to experts 0 and 1 at capacity 5: the
    lower flat index keeps its slot, as JAX's stable sort gives it."""
    rng = np.random.RandomState(0)
    T, E, n, k = 30, 16, 8, 2
    x = rng.randn(T, E).astype(np.float32)
    if case == "drops":
        idx = np.where(rng.rand(T, k) < 0.8, np.arange(k)[None, :],
                       rng.randint(2, n, (T, k)))
        cap = 5
    else:
        idx = np.argsort(rng.rand(T, n), axis=1)[:, :k]
        cap = moe._capacity(T, k, n, 1.25)
    gates = rng.rand(T, k).astype(np.float32)
    jb, ji = jmoe._bucket_by_expert(jnp.asarray(x), jnp.asarray(idx, jnp.int32),
                                    jnp.asarray(gates), n, cap)
    tb, ti = moe._bucket_by_expert(torch.from_numpy(x), torch.from_numpy(idx),
                                   torch.from_numpy(gates), n, cap)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    # JAX lists the pairs in its stable sort by expert, the port in flat
    # order (token, then rank)
    order = np.argsort(idx.reshape(-1), kind="stable")
    for key in ("slot", "gate", "keep"):
        np.testing.assert_array_equal(ti[key].numpy()[order],
                                      np.asarray(ji[key]))
    np.testing.assert_array_equal(order // k, np.asarray(ji["src_t"]))
    counts = np.bincount(idx.reshape(-1), minlength=n)
    np.testing.assert_array_equal(ti["fill"].numpy(), np.minimum(counts, cap))
    dropped = int((~ti["keep"]).sum())
    assert (dropped > 0) == (case == "drops")
    assert dropped == int(counts.sum() - np.minimum(counts, cap).sum())
    out = np.random.RandomState(2).randn(n, cap, E).astype(np.float32)
    np.testing.assert_array_equal(
        moe._combine(torch.from_numpy(out), ti, E,
                     torch.from_numpy(idx)).numpy(),
        np.asarray(jmoe._combine(jnp.asarray(out), ji, E)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("factor", [1.25, 0.3])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_tp_matches_jax(moe_weights, arch, factor, dtype):
    """The whole routed FFN at 3 x 11 rows under a skewed router: pairs
    are dropped at both factors (capacity 16 and 2 for 66 pairs), the same
    ones as JAX's, counted on the device; outputs within the dtype's
    tolerance.  bf16 takes the experts' weights x5, not x10: at x10 the
    outputs reach ~3 and cancel in the k-sum, where one bf16 ulp of a
    term is near the 2e-2 tolerance."""
    jcfg, jp, cfg, _ = moe_weights[arch]
    pf, _ = _moe_leaves(jp, cfg)
    w = _skewed_router(pf["router"]["w"], 2.0)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    s = 1.0 if dtype == "float32" else 0.5
    pf = {"router": {"w": jnp.asarray(w)},
          "experts": {k: (v * s).astype(jdt)
                      for k, v in pf["experts"].items()}}
    tf = {"router": {"w": torch.from_numpy(w)},
          "experts": {k: torch.from_numpy(np.array(v.astype(jnp.float32)))
                      .to(tdt) for k, v in pf["experts"].items()}}
    x = np.random.RandomState(4).randn(3, 11, cfg.d_model).astype(np.float32)
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    moe.reset_dropped_pairs()
    jy = jax.jit(jmoe.moe_ffn_tp, static_argnums=(2, 3))(jx, pf, jcfg, factor)
    ty = moe.moe_ffn_tp(tx, tf, cfg, capacity_factor=factor)
    assert ty.dtype == tdt and ty.shape == (3, 11, cfg.d_model)
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               **(TOL if dtype == "float32" else BF_TOL))
    # the drops: JAX's keep flags at the same routing
    T, k = 33, cfg.top_k
    _, ji = jmoe.router_topk(jx.reshape(T, -1), pf["router"]["w"], k,
                             cfg.n_experts)
    cap = jmoe._capacity(T, k, cfg.n_experts, factor)
    _, info = jmoe._bucket_by_expert(jx.reshape(T, -1), ji, ji.astype(
        jnp.float32), cfg.n_experts, cap)
    want = int((~np.asarray(info["keep"])).sum())
    assert moe.dropped_pairs() == want > 0


def test_moe_ffn_ep_at_tp1_matches_jax(moe_weights):
    jcfg, jp, cfg, _ = moe_weights["deepseek-moe-16b"]
    pf, tf = _moe_leaves(jp, cfg)
    x = np.random.RandomState(5).randn(2, 9, cfg.d_model).astype(np.float32)
    jy = jmoe.moe_ffn_ep(jnp.asarray(x), pf, jcfg, 0, 1, capacity_factor=0.5)
    ty = moe.moe_ffn_ep(torch.from_numpy(x), tf, cfg, 0, 1,
                        capacity_factor=0.5)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_array_equal(
        ty.numpy(), moe.moe_ffn_tp(torch.from_numpy(x), tf, cfg,
                                   capacity_factor=0.5).numpy())
    with pytest.raises(NotImplementedError, match="item 12"):
        moe.moe_ffn_ep(torch.from_numpy(x), tf, cfg, 1, 2)


def test_combine_repeats_bitwise_and_sums_in_expert_order():
    """The combine gathers each token's pairs and adds them in ascending
    expert order in the outputs' dtype, so bf16 sums equal JAX's
    scatter-add (which applies the sorted pairs in turn) bit for bit, and
    a second call repeats the first."""
    rng = np.random.RandomState(6)
    T, E, n, k = 12, 32, 8, 3
    idx = np.argsort(rng.rand(T, n), axis=1)[:, :k]
    gates = rng.rand(T, k).astype(np.float32)
    out = rng.randn(n, 6, E).astype(np.float32)
    x = rng.randn(T, E).astype(np.float32)
    _, ji = jmoe._bucket_by_expert(jnp.asarray(x), jnp.asarray(idx, jnp.int32),
                                   jnp.asarray(gates), n, 6)
    _, ti = moe._bucket_by_expert(torch.from_numpy(x), torch.from_numpy(idx),
                                  torch.from_numpy(gates), n, 6)
    ti_ = torch.from_numpy(idx)
    jo = jmoe._combine(jnp.asarray(out, jnp.bfloat16), ji, E)
    to = moe._combine(torch.from_numpy(out).to(torch.bfloat16), ti, E, ti_)
    np.testing.assert_array_equal(to.float().numpy(),
                                  np.asarray(jo.astype(jnp.float32)))
    assert torch.equal(to, moe._combine(torch.from_numpy(out).to(
        torch.bfloat16), ti, E, ti_))


# --------------------------------------------------------- expert matmul
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_expert_matmul_matches_einsum_with_nan_past_counts(dtype):
    """``ref_expert_matmul`` (the wrapper's CPU path) is JAX's ``einsum(
    "nce,nef->ncf")`` over zero-padded buckets: rows past each count hold
    NaN in the input and come out exactly zero; empty, partly filled and
    full experts."""
    rng = np.random.RandomState(7)
    n, C, K, N = 5, 8, 48, 40
    counts = np.asarray([0, 3, 8, 1, 5], np.int32)
    x = rng.randn(n, C, K).astype(np.float32)
    w = (0.1 * rng.randn(n, K, N)).astype(np.float32)
    live = np.arange(C)[None, :] < counts[:, None]
    jx = jnp.asarray(np.where(live[..., None], x, 0.0)).astype(dtype)
    want = np.asarray(jnp.einsum("nce,nef->ncf", jx, jnp.asarray(w).astype(
        dtype)).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(np.where(live[..., None], x, np.nan)).to(tdt)
    got = ops.expert_matmul(tx, torch.from_numpy(w).to(tdt),
                            torch.from_numpy(counts))
    assert got.dtype == tdt and got.shape == (n, C, N)
    np.testing.assert_allclose(got.float().numpy(), want,
                               **(TOL if dtype == "float32" else BF_TOL))
    assert not got[torch.from_numpy(~live)].any()
    assert bool(torch.isfinite(got).all())


class _Call:
    def __init__(self):
        self.args = None

    def __call__(self, *args):
        self.args = args
        return 0


@pytest.fixture
def card_stub(monkeypatch):
    """The launcher with the card taken out: every check and the plan run,
    and the C entry records its arguments instead of launching."""
    call = _Call()

    def check(t, name, ndim, dtypes):
        if t.dim() != ndim or t.dtype not in dtypes:
            raise ValueError(f"{name}: {t.dim()} dims, {t.dtype}")

    monkeypatch.setattr(build, "check_cuda_tensor", check)
    monkeypatch.setattr(build, "kernel_function", lambda *a: call)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    return call


@pytest.mark.parametrize("shape", [(64, 8, 2048, 1408), (64, 16, 1408, 2048),
                                   (8, 16, 6144, 16384), (8, 16, 16384, 6144)])
def test_expert_launcher_hands_the_plan_to_the_kernel(card_stub, shape):
    """deepseek's and mixtral's expert products: the C entry gets the
    expert count, the bucket shape and ``expert_plan(C, N, K)``: the widest
    tile, one a block, the smallest split whose block fits two to an SM
    (mixtral's w_down fits none: its smallest split), within the card's
    shared memory."""
    n, C, K, N = shape
    x = torch.zeros(n, C, K, dtype=torch.bfloat16)
    w = torch.zeros(1, dtype=torch.bfloat16).expand(n, K, N)   # no storage
    counts = torch.zeros(n, dtype=torch.int32)
    k_matmul.expert_matmul(x, w, counts)
    p = k_matmul.expert_plan(C, N, K, torch.bfloat16)
    assert p.kernel == "mma" and p.smem <= k_matmul.SMEM_MAX
    assert (p.bn, p.grid_n) == (64, p.n_tiles)
    wide = sorted((c for c in k_matmul._mma_candidates(C, N, K, p.bm, True,
                                                       False)
                   if c.bn == 64 and c.grid_n == c.n_tiles),
                  key=lambda c: c.split)
    two = [c for c in wide if 2 * (c.smem + 1024) <= k_matmul.SMEM_SM]
    assert p == (two or wide)[0]
    assert bool(two) == (shape != (8, 16, 16384, 6144))
    assert card_stub.args[4:10] == (n, C, N, K, 1, p.bm)
    assert card_stub.args[10:15] == (p.bn, p.split, p.grid_n, p.smem,
                                     int(p.vec))


@pytest.mark.parametrize("M", [8, 32, 40, 160])
def test_router_plans_split_k_over_a_cluster(M):
    """The routers' float32 products, a single column tile over K 2048
    (deepseek) or 6144 (mixtral), split K over a cluster of 8 (each rank
    16 or more steps of 16 rows); a float32 product with more tiles or a
    shorter K does not split (mamba2's in_dt, tinyllama's heads)."""
    for K, N in ((2048, 64), (6144, 8)):
        p = k_matmul.plan(M, N, K, torch.float32, False)
        assert (p.kernel, p.split, p.n_tiles, p.smem) == ("simt", 8, 1, 0)
        assert p.split * p.kt * 16 >= K and p.kt >= 16
    for shape in ((M, 32, 1024), (M, 32000, 512), (M, 512, 2048)):
        assert k_matmul.plan(*shape, torch.float32, False).split == 1


def test_expert_launcher_never_falls_back(monkeypatch):
    """A kernel that fails to build raises out of the expert products: no
    ``torch.bmm``, no plain version, no CPU."""
    def check(t, name, ndim, dtypes):
        return None

    def broken(*a):
        raise RuntimeError("kernel build failed")

    def never(*a, **k):
        raise AssertionError("fell back")

    monkeypatch.setattr(build, "check_cuda_tensor", check)
    monkeypatch.setattr(build, "kernel_function", broken)
    monkeypatch.setattr(torch, "bmm", never)
    monkeypatch.setattr(ref, "ref_expert_matmul", never)
    x = torch.zeros(4, 8, 64, dtype=torch.bfloat16)
    w = torch.zeros(4, 64, 32, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        k_matmul.expert_matmul(x, w, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="do not match"):
        k_matmul.expert_matmul(x, w[:3], torch.zeros(4, dtype=torch.int32))


# ----------------------------------------------------------------- logits
SB, PSZ, CHUNK, N_MAX, N_PAGES = 64, 8, 16, 8, 17


def test_whole_prompt_prefill_then_decode_logits_match_jax(moe_weights,
                                                           mesh1):
    """mixtral: the contiguous engine's steps, a 19-token prompt (T 19),
    then two decode steps over its lane (T 1), window layers throughout
    (deepseek's are held through its chunk, decode and verify steps and
    its engines below)."""
    jcfg, jp, cfg, p = moe_weights["mixtral-8x22b"]
    jplan, plan = JaxPlan(tp=1, kv_cache_dtype="float32"), \
        ShardingPlan(kv_cache_dtype="float32")
    jpre, _, _ = jsteps.make_prefill_step(jcfg, jplan, mesh1,
                                          ShapeConfig("p", "decode", SB, 1))
    jdec, _, _ = jsteps.make_decode_step(jcfg, jplan, mesh1,
                                         ShapeConfig("s", "decode", SB, 1))
    jpre, jdec = jax.jit(jpre), jax.jit(jdec)
    pre = steps.make_prefill_step(cfg, plan, SB)
    dec = steps.make_decode_step(cfg, plan, 1, SB)
    prompt = np.random.RandomState(1).randint(2, cfg.vocab_size, (1, 19))
    jl, jlane = jpre(jp, jnp.asarray(prompt, jnp.int32),
                     jsteps.zero_cache_for(jcfg, jplan, mesh1, 1, SB))
    tl, lane = pre(p, torch.from_numpy(prompt).long(),
                   steps.zero_cache_for(cfg, plan, 1, SB, "cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    tok, pos = int(np.argmax(np.asarray(jl)[0])), 19
    for _ in range(2):
        jl, jlane = jdec(jp, jlane, jnp.asarray([[tok]], jnp.int32),
                         jnp.asarray([pos], jnp.int32))
        tl, lane = dec(p, lane, torch.tensor([[tok]]),
                       torch.tensor([pos], dtype=torch.int32))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok, pos = int(np.argmax(np.asarray(jl)[0])), pos + 1


def _prefill_paged(jchunk, jp, jcache, chunk, p, cache, prompt, bt_row):
    L = len(prompt)
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
    return jl, jcache, tl, cache


def test_chunks_decode_and_verify_logits_match_jax(moe_weights, mesh1):
    """deepseek: two rows prefilled in chunks of 16 (their padding rows
    route too), one paged decode step over both (T 2), then one verify
    step of Q = 3 (T 6, the second row with 2 live columns): every live
    logit (mixtral's steps are held through its engines below)."""
    jcfg, jp, cfg, p = moe_weights["deepseek-moe-16b"]
    jplan, plan = JaxPlan(tp=1, kv_cache_dtype="float32"), \
        ShardingPlan(kv_cache_dtype="float32")
    Q = 3
    jchunk, _, _ = jsteps.make_prefill_chunk_step(jcfg, jplan, mesh1, CHUNK,
                                                  N_PAGES, PSZ, N_MAX)
    jdec, _, _ = jsteps.make_paged_decode_step(jcfg, jplan, mesh1, 2, N_PAGES,
                                               PSZ, N_MAX)
    jver, _, _ = jsteps.make_verify_step(jcfg, jplan, mesh1, 2, Q, N_PAGES,
                                         PSZ, N_MAX)
    jchunk, jdec, jver = jax.jit(jchunk), jax.jit(jdec), jax.jit(jver)
    chunk = steps.make_prefill_chunk_step(cfg, plan, CHUNK, N_MAX)
    dec = steps.make_paged_decode_step(cfg, plan, 2, N_MAX)
    ver = steps.make_verify_step(cfg, plan, 2, Q, N_MAX)
    rng = np.random.RandomState(4)
    bt = np.asarray([[7, 2, 11, 4, 9, 1, 13, 15],
                     [3, 5, 6, 8, 10, 12, 14, 16]], np.int32)
    jcache = jsteps.zero_paged_cache_for(jcfg, jplan, mesh1, N_PAGES, PSZ)
    cache = steps.zero_paged_cache_for(cfg, plan, N_PAGES, PSZ, "cpu")
    lens = (21, 13)
    first = []
    for row, L in enumerate(lens):
        prompt = rng.randint(2, cfg.vocab_size, L)
        jl, jcache, tl, cache = _prefill_paged(jchunk, jp, jcache, chunk, p,
                                               cache, prompt, bt[row])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        first.append(int(np.argmax(np.asarray(jl)[0])))
    toks = np.asarray(first, np.int32)[:, None]
    pos = np.asarray(lens, np.int32)
    jl, jcache = jdec(jp, jcache, jnp.asarray(toks), jnp.asarray(pos),
                      jnp.asarray(bt))
    tl, cache = dec(p, cache, torch.from_numpy(toks).long(),
                    torch.from_numpy(pos), torch.from_numpy(bt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    vt = rng.randint(2, cfg.vocab_size, (2, Q)).astype(np.int32)
    qlen = np.asarray([Q, 2], np.int32)
    jl, _ = jver(jp, jcache, jnp.asarray(vt), jnp.asarray(pos + 1),
                 jnp.asarray(qlen), jnp.asarray(bt))
    tl, _ = ver(p, cache, torch.from_numpy(vt).long(),
                torch.from_numpy(pos + 1), torch.from_numpy(qlen),
                torch.from_numpy(bt))
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl[0].numpy(), jl[0], **TOL)
    np.testing.assert_allclose(tl[1, :2].numpy(), jl[1, :2], **TOL)


# ---------------------------------------------------------------- engines
SLOTS = 3
# (prompt length, max_new_tokens): both sides of the page and the chunk,
# more requests than slots
REQS = [(5, 7), (17, 6), (9, 8), (24, 5)]


def _prompts(vocab):
    rng = np.random.RandomState(3)
    return [(rng.randint(2, vocab, L).astype(np.int32), m) for L, m in REQS]


def _serve(eng, cls, prompts):
    reqs = [cls(rid=i, prompt=p.copy(), max_new_tokens=m)
            for i, (p, m) in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_ticks=2000)
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs]


def _paged_engine(cfg, plan, p, **kw):
    return ServingEngine.build_paged(cfg, plan, SLOTS, SB, p, device="cpu",
                                     **kw)


def _plans(kvd="float32"):
    return JaxPlan(tp=1, kv_cache_dtype=kvd), ShardingPlan(kv_cache_dtype=kvd)


@pytest.mark.parametrize("overlap", [False, True], ids=["serial", "overlap"])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_matches_jax(moe_weights, mesh1, arch, overlap):
    """Greedy tokens and ticks against JAX's paged engine, the serial loop
    and the pipelined tick on both sides."""
    jcfg, jp, cfg, p = moe_weights[arch]
    jplan, plan = _plans()
    kw = dict(page_size=PSZ, prefill_chunk=CHUNK, overlap=overlap)
    prompts = _prompts(cfg.vocab_size)
    want = _serve(JaxEngine.build_paged(jcfg, jplan, mesh1, SLOTS, SB, jp,
                                        **kw), JaxRequest, prompts)
    eng = _paged_engine(cfg, plan, p, **kw)
    got = _serve(eng, Request, prompts)
    assert got == want
    assert len({t for r in got for t in r}) > 8            # not degenerate
    assert eng.drain() == 0
    assert eng.allocator.n_free == eng.allocator.n_pages - 1


@pytest.mark.parametrize("arch", ARCHS)
def test_contiguous_engine_matches_jax(moe_weights, mesh1, arch):
    jcfg, jp, cfg, p = moe_weights[arch]
    jplan, plan = _plans()
    dec, _, _ = jsteps.make_decode_step(jcfg, jplan, mesh1,
                                        ShapeConfig("s", "decode", SB, SLOTS))
    pre, _, _ = jsteps.make_prefill_step(jcfg, jplan, mesh1,
                                         ShapeConfig("p", "decode", SB, 1))
    jeng = JaxEngine(jcfg, jplan, mesh1, SLOTS, SB, jp, jax.jit(pre),
                     jax.jit(dec))
    # one prompt length: JAX's contiguous engine compiles its prefill per
    # length
    rng = np.random.RandomState(3)
    prompts = [(rng.randint(2, cfg.vocab_size, 13).astype(np.int32), m)
               for m in (7, 6, 8, 5)]
    want = _serve(jeng, JaxRequest, prompts)
    eng = ServingEngine(cfg, plan, SLOTS, SB, p, device="cpu")
    got = _serve(eng, Request, prompts)
    assert got == want
    assert (eng.stats.ticks, eng.stats.prefills) == \
        (jeng.stats.ticks, jeng.stats.prefills)


@pytest.mark.parametrize("arch", ARCHS)
def test_speculative_engine_matches_jax_s(moe_weights, mesh1, arch):
    """speculative=2 against JAX's speculative engine (not the port's
    greedy one: the verify step's row count sets the capacity): tokens,
    ticks and drafting counters, serial loop, no prefix cache.  Weights x5
    and prompts P + G + P, G the greedy continuation of P: prompt lookup
    then drafts, and some drafts are accepted (at x10 none are)."""
    jcfg, jp, cfg, _ = moe_weights[arch]
    jp = jax.tree_util.tree_map(lambda a: a * 0.5, jp)
    jplan, plan = _plans()
    p = params_from_jax(cfg, plan, _np_tree(jp), device="cpu")
    kw = dict(page_size=PSZ, prefill_chunk=CHUNK, overlap=False)
    base = _prompts(cfg.vocab_size)
    cont = _serve(_paged_engine(cfg, plan, p, **kw), Request,
                  [(pr, 6) for pr, _ in base])
    prompts = [(np.concatenate([pr, np.asarray(g, np.int32), pr]), m)
               for (pr, m), g in zip(base, cont, strict=True)]
    kw["speculative"] = 2
    jeng = JaxEngine.build_paged(jcfg, jplan, mesh1, SLOTS, SB, jp,
                                 prefix_cache=False, **kw)
    want = _serve(jeng, JaxRequest, prompts)
    eng = _paged_engine(cfg, plan, p, **kw)
    got = _serve(eng, Request, prompts)
    st, jst = eng.stats, jeng.stats
    assert got == want
    assert (st.ticks, st.spec_steps, st.spec_drafted, st.spec_accepted) == \
        (jst.ticks, jst.spec_steps, jst.spec_drafted, jst.spec_accepted)
    assert st.spec_accepted > 0


def test_int8_pool_engine_matches_jax(moe_weights, mesh1):
    """deepseek over int8 pools, weights x4 (at x10 the K/V rows' float32
    sums on the two sides put some value on an int8 rounding boundary)."""
    jcfg, jp, cfg, _ = moe_weights["deepseek-moe-16b"]
    jp = jax.tree_util.tree_map(lambda a: a * 0.4, jp)
    jplan, plan = _plans("int8")
    p = params_from_jax(cfg, plan, _np_tree(jp), device="cpu")
    kw = dict(page_size=PSZ, prefill_chunk=CHUNK, overlap=False)
    prompts = _prompts(cfg.vocab_size)
    jeng = JaxEngine.build_paged(jcfg, jplan, mesh1, SLOTS, SB, jp,
                                 prefix_cache=False, **kw)
    want = _serve(jeng, JaxRequest, prompts)
    eng = _paged_engine(cfg, plan, p, **kw)
    assert eng.quant_pools
    got = _serve(eng, Request, prompts)
    assert got == want and eng.stats.ticks == jeng.stats.ticks
    assert len({t for r in got for t in r}) > 8


def test_prefix_cache_engine_matches_jax(moe_weights, mesh1):
    """deepseek behind a shared 21-token prefix with ``prefix_cache=True``
    on both sides: tokens, prefix hits, skipped prefill tokens and COW
    copies; a chunk that resumes after a hit routes its own rows only."""
    jcfg, jp, cfg, p = moe_weights["deepseek-moe-16b"]
    jplan, plan = _plans()
    rng = np.random.RandomState(0)
    base = rng.randint(2, cfg.vocab_size, 21).astype(np.int32)
    prompts = [(np.concatenate([base, rng.randint(2, cfg.vocab_size, 3 + i)])
                .astype(np.int32), 5) for i in range(4)]
    kw = dict(page_size=PSZ, prefill_chunk=CHUNK, overlap=False,
              prefix_cache=True)
    jeng = JaxEngine.build_paged(jcfg, jplan, mesh1, 2, SB, jp, **kw)
    want = _serve(jeng, JaxRequest, prompts)
    eng = ServingEngine.build_paged(cfg, plan, 2, SB, p, device="cpu", **kw)
    got = _serve(eng, Request, prompts)
    st, jst = eng.stats, jeng.stats
    assert got == want
    fields = ("ticks", "prefix_hits", "prefill_tokens_skipped", "cow_copies")
    assert [getattr(st, f) for f in fields] == [getattr(jst, f) for f in fields]
    assert st.prefill_tokens_skipped > 0


def test_capacity_drops_in_prefill_chunks_match_jax(moe_weights, mesh1):
    """Chunks of 32 (capacity 16 for 64 pairs) over prompts of one
    repeated token: the MoE layer's rows route alike, past 16 pairs an
    expert, and the dropped pairs (counted on the device) leave the
    tokens equal to JAX's."""
    jcfg, jp, cfg, p = moe_weights["deepseek-moe-16b"]
    jplan, plan = _plans()
    rng = np.random.RandomState(8)
    prompts = [(np.full(40, 7, np.int32), 4),
               (np.concatenate([np.full(30, 11), rng.randint(2, 500, 6)])
                .astype(np.int32), 4)]
    kw = dict(page_size=PSZ, prefill_chunk=32, overlap=False)
    want = _serve(JaxEngine.build_paged(jcfg, jplan, mesh1, 2, SB, jp,
                                        prefix_cache=False, **kw),
                  JaxRequest, prompts)
    eng = ServingEngine.build_paged(cfg, plan, 2, SB, p, device="cpu", **kw)
    moe.reset_dropped_pairs()
    got = _serve(eng, Request, prompts)
    assert got == want
    assert moe.dropped_pairs() > 0


# --------------------------------------------------------------- launcher
@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_moe_smoke_on_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--kv-dtype", "fp32", "--requests", "3", "--slots", "2",
                       "--seq-budget", "64", "--page-size", "8",
                       "--prefill-chunk", "16", "--max-new", "4",
                       "--paged"]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke" in out and "tokens=12" in out
