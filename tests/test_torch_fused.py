"""The fused norm variants and the contiguous decode over int8 lanes.

The residual add before each norm and mamba2's gated norm run inside the
rmsnorm kernel's variants (``ops.rmsnorm_residual``, ``ops.rmsnorm_gated``),
and the contiguous decode reads fixed-scale int8 lanes in place
(``ops.decode_attention_i8``).  On the CPU each wrapper runs its plain
version, held here against the JAX package on the same numpy inputs at
``tests/test_kernels.py``'s tolerances; the model's residual stream,
carried as (x, pending delta), gives bitwise the logits and caches of the
unfused layer loop written out below, with 2L (tinyllama) or 5L (mamba2)
fewer PyTorch ops dispatched outside the kernel wrappers per decode step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import blocks as jblocks
from repro.core import layers as jlayers
from repro.kernels.decode_attention import decode_attention as pl_decode
from repro.kernels.rmsnorm import rmsnorm as pl_rmsnorm
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import FFN_NONE, MIX_ATTN
from repro_torch.core import blocks, layers, model, steps
from repro_torch.core.partition import ShardingPlan, model_layout
from repro_torch.kernels import ops

DTYPES = [("float32", jnp.float32, torch.float32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16)]
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
EPS = 1e-6


def _tol(dt):
    return dict(rtol=2e-2, atol=2e-2) if dt == torch.bfloat16 else \
        dict(rtol=1e-4, atol=1e-4)


def _both(a, tdt):
    """A float64 numpy array in the same dtype on both sides."""
    a = a.astype(np.float32)
    return torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(JDT[tdt])


def _close(got, want, tdt):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(tdt))


# ------------------------------------------------------------------ norms
@pytest.mark.parametrize("t,e", [(8, 512), (33, 256), (160, 1024)])
@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_rmsnorm_residual_plain_matches_jax(t, e, name, jdt, tdt):
    """The sum is bitwise JAX's x + r; the norm of it within tolerance of
    ``repro.core.layers.rmsnorm`` and the Pallas kernel (interpret)."""
    rng = np.random.RandomState(t + e)
    x, xj = _both(rng.randn(t, e), tdt)
    r, rj = _both(rng.randn(t, e), tdt)
    sc, scj = _both(0.1 * rng.randn(e), tdt)
    s, y = ops.rmsnorm_residual(x, r, sc, EPS)
    sj = xj + rj
    assert s.dtype == tdt and y.dtype == tdt
    np.testing.assert_array_equal(s.float().numpy(), np.asarray(sj, np.float32))
    _close(y, jlayers.rmsnorm(sj, scj, EPS), tdt)
    _close(y, pl_rmsnorm(sj, scj, bs=32, eps=EPS, interpret=True), tdt)


@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_rmsnorm_residual_is_the_add_then_the_norm(name, jdt, tdt):
    """Bitwise the two ops it replaces on the CPU: ``x + r``, then
    ``ops.rmsnorm`` of the sum."""
    g = torch.Generator().manual_seed(3)
    x, r = (torch.randn(8, 128, generator=g).to(tdt) for _ in range(2))
    sc = (0.1 * torch.randn(128, generator=g)).to(tdt)
    s, y = ops.rmsnorm_residual(x, r, sc)
    assert torch.equal(s, x + r)
    assert torch.equal(y, ops.rmsnorm(x + r, sc))


@pytest.mark.parametrize("odt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("zdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ydt", [torch.float32, torch.bfloat16])
def test_rmsnorm_gated_plain_matches_jax_gated_norm(ydt, zdt, odt):
    """Against the JAX gated-norm lines of ``ssm_mixer`` at tp=1: g = y *
    silu(float(z)), its sum of squares, ``rmsnorm_from_sumsq`` over the
    full d_inner, cast to the out projection's dtype."""
    rng = np.random.RandomState(5)
    T, n = 6, 128
    y, yj = _both(rng.randn(T, n), ydt)
    z, zj = _both(2.0 * rng.randn(T, n), zdt)
    sc, scj = _both(0.1 * rng.randn(n), torch.float32)
    g = yj * jax.nn.silu(zj.astype(jnp.float32))
    sumsq = jnp.sum(jnp.square(g).astype(jnp.float32), axis=-1, keepdims=True)
    want = jlayers.rmsnorm_from_sumsq(g, sumsq, n, scj, EPS).astype(JDT[odt])
    got = ops.rmsnorm_gated(y, z, sc, EPS, odt)
    assert got.dtype == odt
    _close(got, want, odt)


def test_rmsnorm_gated_is_the_lines_it_replaces():
    """Bitwise the five PyTorch ops of the unfused gate on the CPU: the
    cast of z, silu, the product, ``ops.rmsnorm`` and the cast out."""
    g = torch.Generator().manual_seed(4)
    y, z = (torch.randn(2, 3, 64, generator=g).to(torch.bfloat16)
            for _ in range(2))
    sc = 0.1 * torch.randn(64, generator=g)
    want = layers.rmsnorm(y * F.silu(z.float()), sc, EPS).to(torch.bfloat16)
    got = layers.gated_rmsnorm(y, z, sc, EPS, torch.bfloat16)
    assert got.shape == y.shape and torch.equal(got, want)


# ----------------------------------------------- decode over int8 lanes
@pytest.mark.parametrize("S,bkv", [(300, 128), (128, 512)])
@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_decode_attention_i8_plain_matches_pallas_on_dequantized_lanes(
        S, bkv, name, jdt, tdt):
    """int8 lanes at the fixed scale 16: the plain version against the
    Pallas ``decode_attention`` (interpret) on the lanes dequantized by
    ``repro.core.blocks._kv_dq``, lengths >= 1 (the Pallas kernel and
    JAX's ref disagree at 0; ``test_torch_contiguous.py`` covers it)."""
    rng = np.random.RandomState(S)
    B, H, D = 3, 2, 32
    q, qj = _both(rng.randn(B, H, D), tdt)
    k8, v8 = (rng.randint(-127, 128, (B, H, S, D)).astype(np.int8)
              for _ in range(2))
    length = np.array([1, S // 2 + 3, S], np.int32)
    want = pl_decode(qj, jblocks._kv_dq(jnp.asarray(k8), jdt),
                     jblocks._kv_dq(jnp.asarray(v8), jdt), jnp.asarray(length),
                     bkv=bkv, interpret=True)
    kvs = 1.0 / blocks.KVQ["scale"]
    got = ops.decode_attention_i8(q, torch.from_numpy(k8), torch.from_numpy(v8),
                                  torch.from_numpy(length), kvs)
    assert got.dtype == tdt
    _close(got, want, tdt)
    # the dispatching entry hands the lanes to the i8 variant
    assert torch.equal(got, ops.decode_attention(
        q, torch.from_numpy(k8), torch.from_numpy(v8),
        torch.from_numpy(length), kv_scale=kvs))


def test_decode_attention_plain_path_takes_no_kv_scale():
    """The plain (CPU) attention takes lanes already in q's dtype: the int8
    lanes go to the card's kernel only, and ``_kv_dq`` serves the CPU."""
    from repro_torch.core import attention
    q = torch.zeros(1, 1, 1, 32)
    lanes = torch.zeros(1, 1, 8, 32, dtype=torch.int8)
    with pytest.raises(ValueError, match="kv_scale"):
        attention.decode_attention(q, lanes, lanes, torch.zeros(1, 8),
                                   torch.zeros(1, dtype=torch.int32),
                                   kv_scale=1 / 16)


# --------------------------------------------- the carried residual stream
def _setup(arch, dtype):
    cfg = reduced(get_config(arch), dtype=dtype)
    plan = ShardingPlan(kv_cache_dtype="float32")
    params = model.init_params(cfg, plan, torch.Generator().manual_seed(0),
                               device="cpu", dtype=dtype)
    return cfg, plan, model_layout(cfg, plan), params


def _old_gate(y, z, scale, eps, out_dtype):
    """The gated norm as five PyTorch ops, as ``ssm_mixer`` ran it before
    the gate was fused into the norm."""
    g = y * F.silu(z.float())
    return layers.rmsnorm(g, scale, eps).to(out_dtype)


def _unfused_forward(params, tokens, cache, cfg, plan, lay, mode, pos=None):
    """The layer loop with every residual add as its own op, each norm on
    the sum: ``x = x + partial``, ``x = x + ffn(norm(x))``, then the final
    norm.  -> logits of the last position (B, V)."""
    B, S = tokens.shape
    if pos is None:
        positions = torch.arange(S, dtype=torch.int32).expand(B, S)
    else:
        positions = pos[:, None]
    x = model.embed_tokens(params, tokens, cfg)
    for group, gparams, gcache in zip(cfg.layer_groups(), params["stacks"],
                                      cache, strict=True):
        for r in range(group.n_reps):
            for pi, spec in enumerate(group.pattern):
                p = model.tree_map(lambda a, r=r: a[r], gparams[pi])
                c = model.tree_map(lambda a, r=r: a[r], gcache[pi])
                h = layers.rmsnorm(x, p["ln1"]["scale"], cfg.norm_eps)
                if spec.mixer == MIX_ATTN:
                    partial, _ = blocks.attn_mixer(h, p["attn"], cfg, plan,
                                                   lay, spec, mode, c["kv"],
                                                   positions, pos)
                else:
                    partial, new = blocks.ssm_mixer(h, p["ssm"], cfg, lay,
                                                    mode, c["ssm"])
                    for name, t in new.items():
                        c["ssm"][name].copy_(t)
                x = x + partial
                if spec.ffn != FFN_NONE:
                    h = layers.rmsnorm(x, p["ln2"]["scale"], cfg.norm_eps)
                    x = x + blocks.dense_ffn(h, p["ffn"], cfg)
    x = layers.rmsnorm(x[:, -1:], params["final_norm"]["scale"], cfg.norm_eps)
    return model.final_logits(params, x)[:, 0]


def _clone(cache):
    return model.tree_map(lambda t: t.clone(), cache)


def _caches_equal(a, b):
    leaves_a = [t for _, t in model.tree_paths(a)]
    leaves_b = [t for _, t in model.tree_paths(b)]
    return len(leaves_a) == len(leaves_b) and \
        all(torch.equal(x, y) for x, y in zip(leaves_a, leaves_b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["tinyllama-42m", "mamba2-370m"])
def test_carried_delta_gives_the_unfused_logits_bitwise(arch, dtype,
                                                        monkeypatch):
    """A whole-prompt prefill of two rows, then three decode steps, through
    ``forward_prefill``/``forward_decode`` (the residual stream carried as
    (x, pending delta), each add inside the next norm) and through the
    unfused loop above (with the unfused gate): logits and caches bitwise
    equal after every call."""
    cfg, plan, lay, params = _setup(arch, dtype)
    B, S, budget = 2, 11, 32
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        2, cfg.vocab_size, (B, S)))
    fused = steps.zero_cache_for(cfg, plan, B, budget, "cpu")
    plain = _clone(fused)
    got, fused = model.forward_prefill(params, tokens, fused, cfg, plan, lay)
    with monkeypatch.context() as m:
        m.setattr(blocks, "gated_rmsnorm", _old_gate)
        want = _unfused_forward(params, tokens, plain, cfg, plan, lay,
                                "prefill")
    assert torch.equal(got, want) and _caches_equal(fused, plain)
    tok, pos = got.argmax(-1, keepdim=True), torch.full((B,), S,
                                                         dtype=torch.int32)
    for _ in range(3):
        got, fused = model.forward_decode(params, fused, tok, pos, cfg, plan,
                                          lay)
        with monkeypatch.context() as m:
            m.setattr(blocks, "gated_rmsnorm", _old_gate)
            want = _unfused_forward(params, tok, plain, cfg, plan, lay,
                                    "decode", pos)
        assert torch.equal(got, want) and _caches_equal(fused, plain)
        tok, pos = got.argmax(-1, keepdim=True), pos + 1


class _CountOps(TorchDispatchMode):
    """Counts the PyTorch ops dispatched outside the kernel wrappers (while
    ``depth`` is 0), views excluded: the ops that launch device work of
    their own, apart from the kernels."""

    def __init__(self):
        super().__init__()
        self.depth = 0
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.depth == 0 and not func.is_view:
            self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def _count_outside_wrappers(monkeypatch, fn):
    mode = _CountOps()

    def outside(w):
        def wrapped(*args, **kw):
            mode.depth += 1
            try:
                return w(*args, **kw)
            finally:
                mode.depth -= 1
        return wrapped

    with monkeypatch.context() as m:
        for w in ops.WRAPPERS:
            m.setattr(ops, w.__name__, outside(w))
        with mode:
            fn()
    return mode.ops


@pytest.mark.parametrize("arch,dtype,per_layer", [
    ("tinyllama-42m", "float32", 2), ("tinyllama-42m", "bfloat16", 2),
    # mamba2 in bf16: the residual add and the gate's cast of z, silu,
    # product and cast out; in float32 the two casts dispatch nothing
    ("mamba2-370m", "bfloat16", 5), ("mamba2-370m", "float32", 3)])
def test_decode_step_dispatches_fewer_ops_outside_the_kernels(
        arch, dtype, per_layer, monkeypatch):
    """One ``forward_decode`` step dispatches ``per_layer`` x L fewer
    PyTorch ops outside the kernel wrappers than the unfused loop: the
    residual adds (2 a tinyllama layer, 1 a mamba2 layer) and mamba2's four
    gate ops went into the norm kernel's variants."""
    cfg, plan, lay, params = _setup(arch, dtype)
    B, budget = 2, 16
    cache = steps.zero_cache_for(cfg, plan, B, budget, "cpu")
    tok = torch.tensor([[3], [5]])
    pos = torch.tensor([0, 4], dtype=torch.int32)

    def fused():
        model.forward_decode(params, _clone(cache), tok, pos, cfg, plan, lay)

    def unfused():
        with monkeypatch.context() as m:
            m.setattr(blocks, "gated_rmsnorm", _old_gate)
            _unfused_forward(params, tok, _clone(cache), cfg, plan, lay,
                             "decode", pos)

    n_fused = _count_outside_wrappers(monkeypatch, fused)
    n_unfused = _count_outside_wrappers(monkeypatch, unfused)
    assert len(n_unfused) - len(n_fused) == per_layer * cfg.n_layers, \
        (n_unfused, n_fused)


def test_each_decode_step_launches_the_norm_family_once_per_norm(monkeypatch):
    """Per tinyllama step 1 plain norm and 2L residual norms, per mamba2
    step 1 plain, L residual and L gated: every norm is still one kernel
    launch (counted on the CPU by wrapping the ops wrappers)."""
    for arch, want in (("tinyllama-42m", lambda L: (1, 2 * L, 0)),
                       ("mamba2-370m", lambda L: (1, L, L))):
        cfg, plan, lay, params = _setup(arch, "float32")
        calls = dict.fromkeys(("rmsnorm", "rmsnorm_residual", "rmsnorm_gated"),
                              0)

        def counting(w):
            def wrapped(*args, **kw):
                calls[w.__name__] += 1
                return w(*args, **kw)
            return wrapped

        cache = steps.zero_cache_for(cfg, plan, 2, 16, "cpu")
        with monkeypatch.context() as m:
            for name in calls:
                m.setattr(ops, name, counting(getattr(ops, name)))
            model.forward_decode(params, cache, torch.tensor([[3], [5]]),
                                 torch.tensor([0, 4], dtype=torch.int32), cfg,
                                 plan, lay)
        assert tuple(calls.values()) == want(cfg.n_layers), (arch, calls)
