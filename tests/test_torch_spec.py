"""The port's speculative decoding against the JAX package's: the plain
versions of the paged-verify kernels (float and int8 pools) against the
Pallas kernels (interpret mode) and ``kernels/ref.py``, the core
``paged_verify_attention`` and its ``length = cur_pos + 1`` conversion,
``forward_verify`` logits and pools through ``make_verify_step``, the
allocator's trim and the scheduler's draft headroom, denial and trim on
the same call sequences as the JAX classes, ``PromptLookupDraft`` and
``speculative_sample`` on the JAX cases, and the engine's greedy tokens
with speculation (float and int8 pools) against the JAX paged engine and
against the port's own one-token engine.  Tolerances: fp32 1e-4, bf16 2e-2
(``tests/test_kernels.py``)."""
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
from repro.core.kvcache import PageAllocator as JaxAllocator
from repro.core.partition import ShardingPlan as JaxPlan
from repro.kernels import ref as jref
from repro.kernels.decode_attention import paged_verify_attention as pl_verify
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving.prefix_cache import PromptLookupDraft as JaxDraft
from repro.serving.sampler import SamplerConfig as JaxSamplerConfig
from repro.serving.sampler import speculative_sample as j_spec_sample
from repro.serving.scheduler import FCFSScheduler as JaxFCFS
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.core import attention as tattn
from repro_torch.core import steps
from repro_torch.core.kvcache import PageAllocator, pages_needed
from repro_torch.core.partition import ShardingPlan
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.engine import EngineStats
from repro_torch.serving.prefix_cache import PromptLookupDraft
from repro_torch.serving.sampler import SamplerConfig, speculative_sample
from repro_torch.serving.scheduler import FCFSScheduler

DTYPES = [("float32", jnp.float32, torch.float32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16)]


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else \
        dict(rtol=1e-4, atol=1e-4)


def _close(got, want, name):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(name))


# ------------------------------------------------------------------ kernels
def _verify_case(rng, nq, quant, B=5, H=4, D=32, psz=8, n_max=4):
    n_pages = B * n_max + 1
    if quant:
        kp, ks = quant_pool_case(rng, n_pages, H, psz, D)
        vp, vs = quant_pool_case(rng, n_pages, H, psz, D)
    else:
        kp, vp = (rng.randn(n_pages, H, psz, D).astype(np.float32)
                  for _ in range(2))
        ks = vs = None
    bt = paged_case(rng, B, n_max, n_pages)
    bt[0, 0] = 3                       # a page with zero-scale rows
    # query 0 at length - 1; the deepest query's view length + nq - 1
    # crosses page boundaries and, in the last live row, passes n_max*psz
    length = np.asarray([6, 8, 9, 31, 1], np.int32)
    q = rng.randn(B, H, nq, D).astype(np.float32)
    return q, kp, vp, ks, vs, bt, length


@pytest.mark.parametrize("nq", [2, 5])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "i8"])
@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_paged_verify_matches_pallas_and_ref(nq, quant, name, jdt, tdt):
    rng = np.random.RandomState(10 * nq + quant)
    q, kp, vp, ks, vs, bt, length = _verify_case(rng, nq, quant)
    pool_t = (lambda a: torch.from_numpy(a)) if quant else \
        (lambda a: torch.from_numpy(a).to(tdt))
    pool_j = (lambda a: jnp.asarray(a)) if quant else \
        (lambda a: jnp.asarray(a, jdt))
    sc_t = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs)) \
        if quant else {}
    sc_j = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)) \
        if quant else {}
    got = ops.paged_verify_attention(
        torch.from_numpy(q).to(tdt), pool_t(kp), pool_t(vp),
        torch.from_numpy(bt), torch.from_numpy(length), **sc_t)
    assert got.dtype == tdt and got.shape == q.shape
    qj = jnp.asarray(q, jdt)
    _close(got, pl_verify(qj, pool_j(kp), pool_j(vp), jnp.asarray(bt),
                          jnp.asarray(length), interpret=True, **sc_j), name)
    if quant:       # dequantized in float32, as the Pallas i8 kernel does
        kf = gather_np(np.asarray(jref.ref_dequant_pool(kp, ks)), bt)
        vf = gather_np(np.asarray(jref.ref_dequant_pool(vp, vs)), bt)
    else:           # the pools in q's dtype
        kf = np.asarray(jnp.asarray(gather_np(kp, bt), jdt), np.float32)
        vf = np.asarray(jnp.asarray(gather_np(vp, bt), jdt), np.float32)
    _close(got, jref.ref_verify_attention(qj, kf, vf, jnp.asarray(length)),
           name)


def test_verify_with_one_query_is_decode():
    rng = np.random.RandomState(3)
    q, kp, vp, _, _, bt, length = _verify_case(rng, 1, False)
    args = [torch.from_numpy(a) for a in (kp, vp, bt, length)]
    np.testing.assert_allclose(
        ops.paged_verify_attention(torch.from_numpy(q), *args)[:, :, 0],
        ops.paged_decode_attention(torch.from_numpy(q[:, :, 0]), *args),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "i8"])
@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_core_paged_verify_attention_matches_jax(quant, name, jdt, tdt):
    """The inclusive ``cur_pos`` with GQA groups (R = 2) on the CPU path."""
    rng = np.random.RandomState(4 + quant)
    B, G, R, Q, D, psz, n_max = 3, 2, 2, 4, 32, 8, 3
    n_pages = B * n_max + 1
    if quant:
        kp, ks = quant_pool_case(rng, n_pages, G, psz, D)
        vp, vs = quant_pool_case(rng, n_pages, G, psz, D)
    else:
        kp, vp = (rng.randn(n_pages, G, psz, D) for _ in range(2))
    bt = paged_case(rng, B, n_max, n_pages)
    cur_pos = np.asarray([0, 6, 19], np.int32)
    q = rng.randn(B, G, R, Q, D)
    if quant:
        t_kv = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
        j_kv = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        pools_t = (torch.from_numpy(kp), torch.from_numpy(vp))
        pools_j = (jnp.asarray(kp), jnp.asarray(vp))
    else:
        t_kv, j_kv = {}, {}
        pools_t = tuple(torch.from_numpy(a.astype(np.float32)).to(tdt)
                        for a in (kp, vp))
        pools_j = tuple(jnp.asarray(a, jdt) for a in (kp, vp))
    got = tattn.paged_verify_attention(
        torch.from_numpy(q.astype(np.float32)).to(tdt), *pools_t,
        torch.from_numpy(bt), torch.from_numpy(cur_pos), **t_kv)
    want = jattn.paged_verify_attention(
        jnp.asarray(q, jdt), *pools_j, jnp.asarray(bt), jnp.asarray(cur_pos),
        **j_kv)
    _close(got, want, name)


def test_core_verify_converts_cur_pos_to_the_kernels_length(monkeypatch):
    """On the card, core/attention hands the kernel ``length = cur_pos +
    1``: pinned by routing the card branch to the kernel's plain version."""
    rng = np.random.RandomState(6)
    q, kp, vp, _, _, bt, length = _verify_case(rng, 3, False)
    seen = {}

    def fake_kernel(q_, k_, v_, bt_, length_, **kw):
        seen["length"] = length_.clone()
        return ops.ref.ref_paged_verify_attention(q_, k_, v_, bt_, length_,
                                                  kw.get("scale"))

    monkeypatch.setattr(ops, "paged_verify_attention", fake_kernel)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    cur_pos = torch.from_numpy(length - 1)
    got = tattn.paged_verify_attention(
        torch.from_numpy(q)[:, :, None], torch.from_numpy(kp),
        torch.from_numpy(vp), torch.from_numpy(bt), cur_pos)
    monkeypatch.undo()
    assert seen["length"].dtype == torch.int32
    np.testing.assert_array_equal(seen["length"].numpy(), length)
    want = tattn.paged_verify_attention(
        torch.from_numpy(q)[:, :, None], torch.from_numpy(kp),
        torch.from_numpy(vp), torch.from_numpy(bt), cur_pos)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


# -------------------------------------------------------------------- model
@pytest.mark.parametrize("kvd", ["float32", "int8"])
def test_forward_verify_matches_jax(mesh1, kvd):
    """Logits of the live columns and the pools after a prefill chunk, one
    verify step with padded columns (qlen < Q) and an idle lane, and a
    second verify step at the accepted position."""
    PSZ, CHUNK, N_MAX, N_PAGES, B, Q = 8, 16, 6, 13, 3, 4
    cfg = reduced(get_config("tinyllama-42m"), dtype="float32")
    jcfg = jax_reduced(jax_get_config("tinyllama-42m"), dtype="float32")
    jplan, plan = JaxPlan(tp=1, kv_cache_dtype=kvd), \
        ShardingPlan(kv_cache_dtype=kvd)
    jp = jmodel.init_params(jcfg, jplan)
    p = params_from_jax(cfg, plan, jax.tree_util.tree_map(np.asarray, jp),
                        device="cpu")
    jchunk, _, _ = jsteps.make_prefill_chunk_step(jcfg, jplan, mesh1, CHUNK,
                                                  N_PAGES, PSZ, N_MAX)
    jver, _, _ = jsteps.make_verify_step(jcfg, jplan, mesh1, B, Q, N_PAGES,
                                         PSZ, N_MAX)
    jchunk, jver = jax.jit(jchunk), jax.jit(jver)
    jcache = jsteps.zero_paged_cache_for(jcfg, jplan, mesh1, N_PAGES, PSZ)
    chunk = steps.make_prefill_chunk_step(cfg, plan, CHUNK, N_MAX)
    ver = steps.make_verify_step(cfg, plan, B, Q, N_MAX)
    cache = steps.zero_paged_cache_for(cfg, plan, N_PAGES, PSZ, "cpu")
    rng = np.random.RandomState(0)
    rows = [np.asarray([7, 2, 11, 4, 9, 1], np.int32),
            np.asarray([3, 12, 5, 8, 6, 10], np.int32)]
    lens = [13, 7]
    for bt_row, L in zip(rows, lens, strict=True):
        toks = np.zeros((1, CHUNK), np.int32)
        toks[0, :L] = rng.randint(2, cfg.vocab_size, L)
        _, jcache = jchunk(jp, jcache, jnp.asarray(toks),
                           jnp.asarray([0], jnp.int32),
                           jnp.asarray([L - 1], jnp.int32),
                           jnp.asarray(bt_row[None]))
        _, cache = chunk(p, cache, torch.from_numpy(toks).long(), 0, L - 1,
                         torch.from_numpy(bt_row[None]))
    bt = np.stack(rows + [np.zeros(N_MAX, np.int32)])
    pos = np.asarray(lens + [0], np.int32)
    for qlen in (np.asarray([4, 2, 1], np.int32),
                 np.asarray([3, 4, 1], np.int32)):
        toks = rng.randint(2, cfg.vocab_size, (B, Q)).astype(np.int32)
        jl, jcache = jver(jp, jcache, jnp.asarray(toks), jnp.asarray(pos),
                          jnp.asarray(qlen), jnp.asarray(bt))
        tl, cache = ver(p, cache, torch.from_numpy(toks).long(),
                        torch.from_numpy(pos), torch.from_numpy(qlen),
                        torch.from_numpy(bt))
        assert tl.shape == (B, Q, cfg.vocab_size)
        for b in range(B - 1):
            np.testing.assert_allclose(tl[b, :qlen[b]].numpy(),
                                       np.asarray(jl)[b, :qlen[b]],
                                       rtol=1e-4, atol=1e-4)
        pos = pos + np.asarray([2, 1, 0], np.int32)    # accepted prefixes
    for b, bt_row in enumerate(rows):
        live = bt_row[:-(-(int(pos[b]) + 4) // PSZ)]
        for name in cache[0][0]["kv"]:
            ours = cache[0][0]["kv"][name][:, live].float().numpy()
            theirs = np.asarray(jcache[0][0]["kv"][name],
                                np.float32)[:, 0][:, live]
            if name in ("kp", "vp") and kvd == "int8":
                assert np.abs(ours - theirs).max() <= 1   # rounding ties
            else:
                np.testing.assert_allclose(ours, theirs, rtol=1e-4,
                                           atol=1e-5)


def test_verify_step_keeps_its_shapes():
    cfg = reduced(get_config("tinyllama-42m"), dtype="float32")
    plan = ShardingPlan(kv_cache_dtype="float32")
    ver = steps.make_verify_step(cfg, plan, 2, 3, 4)
    bt = torch.zeros((2, 4), dtype=torch.int32)
    i32 = dict(dtype=torch.int32)
    with pytest.raises(ValueError, match="tokens"):
        ver(None, None, torch.zeros((2, 4), dtype=torch.long),
            torch.zeros(2, **i32), torch.ones(2, **i32), bt)
    with pytest.raises(ValueError, match="qlen"):
        ver(None, None, torch.zeros((2, 3), dtype=torch.long),
            torch.zeros(2, **i32), torch.ones(3, **i32), bt)


# ------------------------------------------------------ allocator, scheduler
def _toks(*ids):
    return np.asarray(ids, np.int32)


def test_trim_matches_jax_allocator():
    ours, theirs = PageAllocator(8), JaxAllocator(8)
    pages = ours.alloc(4)
    assert theirs.alloc(4) == pages
    for a in (ours, theirs):
        a.trim(pages[2:])
    assert ours.n_free == theirs.n_free == 5
    assert ours.take_scale_dirty() == theirs.take_scale_dirty() == \
        sorted(pages[2:])
    for a in (ours, theirs):
        a.trim(pages[:2])
    assert ours.n_free == theirs.n_free == 7
    with pytest.raises(AssertionError, match="double free"):
        ours.trim(pages[:1])


@pytest.mark.parametrize("n_pages,spec", [(32, True), (5, False)],
                         ids=["granted", "denied"])
def test_scheduler_spec_headroom_matches_jax(n_pages, spec):
    """Headroom of +spec_tokens coverage granted all or nothing; denied,
    the request is still admitted with spec=False and counted; trim hands
    the headroom back.  The same call sequence on the JAX class."""
    out = []
    for Alloc, Sched, Req in ((PageAllocator, FCFSScheduler, Request),
                              (JaxAllocator, JaxFCFS, JaxRequest)):
        a, st = Alloc(n_pages), EngineStats()
        s = Sched(seq_budget=32, allocator=a, page_size=4, spec_tokens=4,
                  stats=st)
        reqs = [Req(rid=0, prompt=_toks(*range(2, 10)), max_new_tokens=8),
                Req(rid=1, prompt=_toks(*range(2, 29)), max_new_tokens=4)
                ][:2 if spec else 1]
        for r in reqs:
            s.submit(r)
        adms = s.plan([0, 1])
        rec = [(adm.slot, list(adm.pages), adm.spec) for adm in adms]
        for adm in adms:
            if adm.spec:
                s.on_spec_trim(adm, pages_needed(len(adm.req.prompt) +
                                                 adm.req.max_new_tokens, 4))
                rec.append((adm.slot, list(adm.pages), adm.spec, a.n_free))
        for adm in adms:
            s.on_finish(adm)
        out.append((rec, st.spec_denied, a.n_free))
    assert out[0] == out[1]
    rec, denied, n_free = out[0]
    assert rec[0][2] is spec and denied == (0 if spec else 1)
    assert n_free == n_pages - 1
    if spec:    # 8 + 8 tokens need 4 pages, +4 drafts 5; 27 + 4 cap at n_max 8
        assert len(rec[0][1]) == 5 and len(rec[1][1]) == 8


# ------------------------------------------------------- draft and sampler
@pytest.mark.parametrize("context,k", [
    ([1, 2, 3, 9, 8, 7, 1, 2, 3], 2), ([1, 2, 3, 9, 1, 2, 3], 8),
    ([5, 6, 1, 5, 6, 2, 5, 6], 1), ([], 4), ([1], 4), ([1, 2, 3, 4], 0),
    ([1, 2, 3, 4], 4), ([4, 4, 4, 4], 3), ([7, 1, 7, 2, 7], 2),
    ([3, 1, 2, 3, 1, 2, 9], 5)])
def test_prompt_lookup_draft_matches_jax(context, k):
    assert PromptLookupDraft().draft(context, k) == \
        JaxDraft().draft(context, k)


@pytest.mark.parametrize("seed", range(4))
def test_speculative_sample_matches_jax(seed):
    """Greedy rows with drafts that agree for 0..k tokens."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(5, 40).astype(np.float32)
    greedy = logits[:, :37].argmax(-1)
    n_agree = seed
    draft = [int(t) for t in greedy[:n_agree]] + \
        [int(greedy[n_agree] + 1) % 37] * (4 - n_agree)
    got = speculative_sample(logits, draft, SamplerConfig(), 37,
                             np.random.RandomState(0))
    want = j_spec_sample(logits, draft, JaxSamplerConfig(), 37,
                         np.random.RandomState(0))
    assert got == want and len(got) == n_agree + 1


# ------------------------------------------------------------------- engine
SB, SLOTS, PSZ, CHUNK, K = 64, 3, 8, 8, 4


def _weights(kvd, scale):
    jcfg = jax_reduced(jax_get_config("tinyllama-42m"), dtype="float32")
    jplan = JaxPlan(tp=1, kv_cache_dtype=kvd)
    jp = jax.tree_util.tree_map(lambda a: a * scale,
                                jmodel.init_params(jcfg, jplan))
    cfg = reduced(get_config("tinyllama-42m"), dtype="float32")
    plan = ShardingPlan(kv_cache_dtype=kvd)
    return jcfg, jplan, jp, cfg, plan, params_from_jax(
        cfg, plan, jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def repetitive_prompts(vocab, n=6, seed=11):
    """A shared prefix and tiled motifs: the traffic prompt lookup drafts
    on (``tests/test_spec_decode.py``)."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(2, vocab, 8).astype(np.int32)
    out = []
    for i in range(n):
        motif = rng.randint(2, vocab, 3 + i % 2).astype(np.int32)
        body = np.tile(motif, 4)[: 8 + 2 * (i % 3)]
        out.append(np.concatenate([shared, body]).astype(np.int32))
    return out


def _serve(Engine, Req, args, prompts, max_new, **kw):
    eng = Engine.build_paged(*args, page_size=PSZ, prefill_chunk=CHUNK, **kw)
    reqs = [Req(rid=i, prompt=p.copy(), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_ticks=3000)
    assert all(r.done for r in reqs)
    return eng, [r.out_tokens for r in reqs]


@pytest.mark.parametrize("kvd,scale,n_pages", [
    ("float32", 1, 0), ("float32", 5, 0), ("int8", 1, 0), ("int8", 5, 10)],
    ids=["fp32", "fp32-x5", "int8", "int8-x5-tight"])
def test_spec_engine_greedy_tokens_identical_to_jax(mesh1, kvd, scale,
                                                    n_pages):
    """speculative=4 on repetitive prompts, JAX's engine without a prefix
    cache (the port's drafts come from the request's own context), in its
    serial loop.  At init scale greedy decoding repeats and most drafts
    are accepted; at x5 it mostly does not and drafts are rarer and often
    rejected; a tight pool denies headroom to some admissions."""
    jcfg, jplan, jp, cfg, plan, params = _weights(kvd, scale)
    prompts = repetitive_prompts(cfg.vocab_size)
    jeng, jtoks = _serve(JaxEngine, JaxRequest,
                         (jcfg, jplan, mesh1, SLOTS, SB, jp), prompts, 12,
                         n_pages=n_pages, overlap=False, prefix_cache=False,
                         speculative=K)
    eng, toks = _serve(ServingEngine, Request,
                       (cfg, plan, SLOTS, SB, params), prompts, 12,
                       n_pages=n_pages, speculative=K, overlap=False,
                       device="cpu")
    assert toks == jtoks
    st, jst = eng.stats, jeng.stats
    assert (st.ticks, st.spec_steps, st.spec_drafted, st.spec_accepted,
            st.spec_denied) == (jst.ticks, jst.spec_steps, jst.spec_drafted,
                                jst.spec_accepted, jst.spec_denied)
    assert st.spec_steps > 0
    if n_pages:
        assert st.spec_denied > 0
    assert eng.drain() == 0
    assert eng.allocator.n_free == eng.allocator.n_pages - 1


@pytest.mark.parametrize("kvd", ["float32", "int8"])
def test_spec_engine_matches_its_one_token_engine(kvd):
    """Speculation changes how many tokens a tick emits, never which
    (weights x5: diverse tokens, some drafts accepted)."""
    *_, cfg, plan, params = _weights(kvd, 5)
    prompts = repetitive_prompts(cfg.vocab_size, n=5, seed=3)
    args = (cfg, plan, SLOTS, SB, params)
    base, t0 = _serve(ServingEngine, Request, args, prompts, 16, device="cpu")
    spec, t1 = _serve(ServingEngine, Request, args, prompts, 16,
                      speculative=K, device="cpu")
    assert t1 == t0
    assert len({t for toks in t0 for t in toks}) > 30
    assert spec.stats.spec_accepted > 0
    assert spec.stats.ticks < base.stats.ticks


def test_launcher_serves_speculative_int8_on_cpu(capsys):
    assert serve.main(["--arch", "tinyllama-42m", "--smoke", "--requests", "4",
                       "--slots", "2", "--seq-budget", "64", "--prompt-len",
                       "20", "--max-new", "6", "--page-size", "8",
                       "--prefill-chunk", "16", "--kv-dtype", "int8",
                       "--speculative", "3", "--paged", "--device",
                       "cpu"]) == 0
    out = capsys.readouterr().out
    assert "tokens=24" in out and "pages_free=16/16" in out
    assert "speculative(k=3): accepted_tokens_per_tick=" in out
