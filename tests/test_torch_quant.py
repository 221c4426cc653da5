"""The port's int8 page pools against the JAX package's: the plain version
of the int8 paged-decode kernel against the Pallas kernel (interpret mode)
and ``kernels/ref.py``, ``_row_quant``, ``gather_pages_dequant`` and the
quantized ``paged_decode_attention`` against ``repro.core``, the scale
pools of the cache template, the allocator's scale-dirty tracking on the
same call sequence as the JAX class, the model's prefill chunk and decode
over int8 pools (logits, payloads and scales), and the engine's greedy
tokens against the JAX paged engine with int8 pools.  Tolerances: fp32
1e-4, bf16 2e-2 (``tests/test_kernels.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from paged_cases import gather_np, paged_case, quant_pool_case

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import attention as jattn
from repro.core import model as jmodel
from repro.core import steps as jsteps
from repro.core.blocks import _row_quant as j_row_quant
from repro.core.kvcache import PageAllocator as JaxAllocator
from repro.core.partition import ShardingPlan as JaxPlan
from repro.kernels import ref as jref
from repro.kernels.decode_attention import paged_decode_attention as pl_paged
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.core import attention as tattn
from repro_torch.core import steps
from repro_torch.core.blocks import _row_quant
from repro_torch.core.kvcache import PageAllocator, paged_cache_template
from repro_torch.core.partition import (ShardingPlan, kv_pool_is_quantized,
                                        model_layout)
from repro_torch.kernels import ops
from repro_torch.serving import Request, ServingEngine

DTYPES = [("float32", jnp.float32, torch.float32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16)]


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else \
        dict(rtol=1e-4, atol=1e-4)


def _close(got, want, name):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(name))


# ------------------------------------------------------------------ kernel
@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_paged_decode_i8_matches_pallas_and_ref(name, jdt, tdt):
    """Lengths crossing page boundaries, a shuffled block table, an idle
    lane and a zero-scale (recycled) page; q in fp32 or bf16, the output
    in q's dtype, the dequant in float32 as the Pallas i8 kernel does."""
    rng = np.random.RandomState(5)
    B, H, D, psz, n_max = 5, 4, 32, 8, 4
    n_pages = B * n_max + 1
    kp, ks = quant_pool_case(rng, n_pages, H, psz, D)
    vp, vs = quant_pool_case(rng, n_pages, H, psz, D)
    bt = paged_case(rng, B, n_max, n_pages)
    bt[0, 0] = 3                                    # slot 0 reads page 3
    length = np.asarray([7, 8, 9, 32, 1], np.int32)
    q = rng.randn(B, H, D).astype(np.float32)
    qt = torch.from_numpy(q).to(tdt)
    got = ops.paged_decode_attention(
        qt, torch.from_numpy(kp), torch.from_numpy(vp), torch.from_numpy(bt),
        torch.from_numpy(length), k_scale=torch.from_numpy(ks),
        v_scale=torch.from_numpy(vs))
    assert got.dtype == tdt
    qj = jnp.asarray(q, jdt)
    _close(got, pl_paged(qj, jnp.asarray(kp), jnp.asarray(vp),
                         jnp.asarray(bt), jnp.asarray(length),
                         k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                         interpret=True), name)
    kf = gather_np(np.asarray(jref.ref_dequant_pool(kp, ks)), bt)
    vf = gather_np(np.asarray(jref.ref_dequant_pool(vp, vs)), bt)
    _close(got, jref.ref_decode_attention(qj, kf, vf, jnp.asarray(length)),
           name)


# --------------------------------------------------------------- row quant
def test_row_quant_matches_jax():
    """amax / 127 per token row over (G, D); zero rows get scale 0; exact
    halves round to even in both."""
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 4, 16).astype(np.float32)
    x[1, 2] = 0.0                                    # a zero row
    x[2, 0] = np.linspace(-127, 127, 64).reshape(4, 16) / 4   # .5 ties
    q, s = _row_quant(torch.from_numpy(x))
    jq, js = j_row_quant(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[1, 2].item() == 0.0 and not q[1, 2].any()
    back = q.float() * s[..., None, None]
    np.testing.assert_allclose(back.numpy(), x,
                               atol=float(s.max()) / 2 + 1e-7)


# ------------------------------------------------------------ core attention
@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_gather_pages_dequant_matches_jax(name, jdt, tdt):
    rng = np.random.RandomState(1)
    pool, scales = quant_pool_case(rng, 9, 2, 4, 16)
    bt = paged_case(rng, 3, 2, 9)
    got = tattn.gather_pages_dequant(torch.from_numpy(pool),
                                     torch.from_numpy(scales),
                                     torch.from_numpy(bt), tdt)
    want = jattn.gather_pages_dequant(jnp.asarray(pool), jnp.asarray(scales),
                                      jnp.asarray(bt), jdt)
    assert got.dtype == tdt
    _close(got, want, name)


@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_quantized_paged_decode_attention_matches_jax(name, jdt, tdt):
    """The inclusive ``cur_pos`` over int8 pools, dequantized to q's dtype
    before scoring as the JAX model path does."""
    rng = np.random.RandomState(2)
    B, G, R, D, psz, n_max = 3, 2, 1, 32, 8, 3
    n_pages = B * n_max + 1
    kp, ks = quant_pool_case(rng, n_pages, G, psz, D)
    vp, vs = quant_pool_case(rng, n_pages, G, psz, D)
    bt = paged_case(rng, B, n_max, n_pages)
    cur_pos = np.asarray([0, 8, 20], np.int32)
    q = rng.randn(B, G, R, D).astype(np.float32)
    got = tattn.paged_decode_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(kp),
        torch.from_numpy(vp), torch.from_numpy(bt), torch.from_numpy(cur_pos),
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    want = jattn.paged_decode_attention(
        jnp.asarray(q, jdt), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(bt), jnp.asarray(cur_pos), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs))
    _close(got, want, name)


# ------------------------------------------------------- template, allocator
def test_int8_template_adds_scale_pools_and_float_templates_do_not():
    cfg = reduced(get_config("tinyllama-42m"), dtype="float32")
    for kvd, quant in (("float32", False), ("bfloat16", False),
                       ("int8", True)):
        plan = ShardingPlan(kv_cache_dtype=kvd)
        assert kv_pool_is_quantized(plan) == quant
        entry = paged_cache_template(cfg, plan, model_layout(cfg, plan), 9,
                                     4)[0][0]["kv"]
        assert set(entry) == ({"kp", "vp", "ksp", "vsp"} if quant
                              else {"kp", "vp"})
        if quant:
            assert entry["kp"][1] == torch.int8
            assert entry["ksp"] == ((cfg.n_layers, 9, 4), torch.float32)


def test_scale_dirty_tracking_matches_jax_allocator():
    """Freeing marks a page dirty; a drain returns each freed page once;
    a dirty page re-allocated before the drain stays marked and resurfaces
    when it is freed again; ``trim`` marks like ``decref``."""
    ours, theirs = PageAllocator(12), JaxAllocator(12)

    def both(method, *args):
        a, b = getattr(ours, method)(*args), getattr(theirs, method)(*args)
        assert a == b, (method, args, a, b)
        return a

    assert both("take_scale_dirty") == []
    p_free, p_trim = both("alloc", 2), both("alloc", 3)
    both("decref", p_free)
    both("trim", p_trim[1:])
    assert both("take_scale_dirty") == sorted(p_free + p_trim[1:])
    assert both("take_scale_dirty") == []
    p = both("alloc", 1)
    both("decref", p)
    assert both("alloc", 1) == p                    # LIFO: the dirty page
    assert both("take_scale_dirty") == []           # live: not returned
    both("decref", p)
    assert both("take_scale_dirty") == p
    both("decref", p_trim[:1])
    assert ours.n_free == theirs.n_free == 11


# -------------------------------------------------------------------- model
def test_int8_prefill_chunks_then_decode_match_jax(mesh1):
    """Logits, int8 payloads and scales of every live page after two
    prefill chunks and three decode steps, fp32 activations."""
    PSZ, CHUNK, N_MAX, N_PAGES, B = 8, 16, 6, 13, 2
    cfg = reduced(get_config("tinyllama-42m"), dtype="float32")
    jcfg = jax_reduced(jax_get_config("tinyllama-42m"), dtype="float32")
    jplan = JaxPlan(tp=1, kv_cache_dtype="int8")
    plan = ShardingPlan(kv_cache_dtype="int8")
    jp = jmodel.init_params(jcfg, jplan)
    p = params_from_jax(cfg, plan, jax.tree_util.tree_map(np.asarray, jp),
                        device="cpu")
    jchunk, _, _ = jsteps.make_prefill_chunk_step(jcfg, jplan, mesh1, CHUNK,
                                                  N_PAGES, PSZ, N_MAX)
    jdec, _, _ = jsteps.make_paged_decode_step(jcfg, jplan, mesh1, B, N_PAGES,
                                               PSZ, N_MAX)
    jchunk, jdec = jax.jit(jchunk), jax.jit(jdec)
    jcache = jsteps.zero_paged_cache_for(jcfg, jplan, mesh1, N_PAGES, PSZ)
    chunk = steps.make_prefill_chunk_step(cfg, plan, CHUNK, N_MAX)
    dec = steps.make_paged_decode_step(cfg, plan, B, N_MAX)
    cache = steps.zero_paged_cache_for(cfg, plan, N_PAGES, PSZ, "cpu")

    prompt = np.random.RandomState(0).randint(2, cfg.vocab_size, 21)
    bt_row = np.asarray([7, 2, 11, 4, 9, 1], np.int32)
    L = len(prompt)

    def close(a, b):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   rtol=1e-4, atol=1e-4)

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
    close(tl, jl)
    bt = np.stack([bt_row, np.zeros(N_MAX, np.int32)])
    tok, pos = int(np.argmax(np.asarray(jl[0]))), L
    for _ in range(3):
        toks = np.asarray([[tok], [0]], np.int32)
        pos_v = np.asarray([pos, 0], np.int32)
        jl, jcache = jdec(jp, jcache, jnp.asarray(toks), jnp.asarray(pos_v),
                          jnp.asarray(bt))
        tl, cache = dec(p, cache, torch.from_numpy(toks).long(),
                        torch.from_numpy(pos_v), torch.from_numpy(bt))
        close(tl[0:1], jl[0:1])
        tok, pos = int(np.argmax(np.asarray(jl[0]))), pos + 1
    live = bt_row[:-(-pos // PSZ)]
    for name in ("kp", "vp", "ksp", "vsp"):
        ours = cache[0][0]["kv"][name][:, live].float().numpy()
        theirs = np.asarray(jcache[0][0]["kv"][name])[:, 0][:, live]
        if name in ("kp", "vp"):     # a rounding tie may land one step off
            assert np.abs(ours - theirs.astype(np.float32)).max() <= 1
            assert (ours != theirs).mean() < 1e-3
        else:
            np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------------- engine
SB, SLOTS, PSZ, CHUNK = 64, 3, 8, 16
N_PAGES = 12        # 11 usable pages: requests queue and pages are recycled
REQS = [(5, 9), (8, 7), (9, 12), (16, 5), (17, 10), (33, 8), (40, 20), (1, 6),
        (24, 16)]


@pytest.fixture(scope="module")
def int8_weights():
    """JAX's init for reduced tinyllama in fp32, scaled x25 so greedy
    decoding does not collapse onto repeating the prompt's last token."""
    jcfg = jax_reduced(jax_get_config("tinyllama-42m"), dtype="float32")
    jplan = JaxPlan(tp=1, kv_cache_dtype="int8")
    jp = jax.tree_util.tree_map(lambda a: a * 25,
                                jmodel.init_params(jcfg, jplan))
    cfg = reduced(get_config("tinyllama-42m"), dtype="float32")
    plan = ShardingPlan(kv_cache_dtype="int8")
    return jcfg, jplan, jp, cfg, plan, params_from_jax(
        cfg, plan, jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def test_int8_engine_greedy_tokens_identical_to_jax(int8_weights, mesh1):
    """A tight pool recycles pages, so the scale reset at admission is on
    the path; every page is free and scale-clean after drain."""
    jcfg, jplan, jp, cfg, plan, params = int8_weights
    rng = np.random.RandomState(0)
    reqs = [(rid, rng.randint(2, cfg.vocab_size, L).astype(np.int32), m)
            for rid, (L, m) in enumerate(REQS)]
    jeng = JaxEngine.build_paged(jcfg, jplan, mesh1, SLOTS, SB, jp,
                                 page_size=PSZ, prefill_chunk=CHUNK,
                                 n_pages=N_PAGES, overlap=False,
                                 prefix_cache=False)
    jreqs = [JaxRequest(rid=r, prompt=p, max_new_tokens=m) for r, p, m in reqs]
    for r in jreqs:
        jeng.submit(r)
    jeng.run(max_ticks=2000)
    eng = ServingEngine.build_paged(cfg, plan, SLOTS, SB, params,
                                    page_size=PSZ, prefill_chunk=CHUNK,
                                    n_pages=N_PAGES, overlap=False,
                                    device="cpu")
    assert eng.quant_pools
    treqs = [Request(rid=r, prompt=p, max_new_tokens=m) for r, p, m in reqs]
    for r in treqs:
        eng.submit(r)
    stats = eng.run(max_ticks=2000)
    assert all(r.done for r in treqs)
    for a, b in zip(jreqs, treqs, strict=True):
        assert b.out_tokens == a.out_tokens, a.rid
    assert len({t for r in treqs for t in r.out_tokens}) > 20
    assert stats.ticks == jeng.stats.ticks
    assert eng.drain() == 0 and eng.allocator.n_free == N_PAGES - 1
    eng.tick()                          # the next tick resets freed scales
    for entry in eng.cache[0]:
        assert not entry["kv"]["ksp"][:, 1:].any()
        assert not entry["kv"]["vsp"][:, 1:].any()
