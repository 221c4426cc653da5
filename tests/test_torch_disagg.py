"""Disaggregated prefill/decode in the port against the JAX package on the
CPU: ``kvcache.handoff_refs`` (the source's references drop exactly once,
the destination's pages are freshly owned; refusals), the page-transfer
step byte for byte against JAX's ``make_page_transfer_step`` on the same
numpy pools (float pools, and int8 payloads with their scale rows), and
the engine at ``disagg=(1, 1)``: tokens, routing and every replica's
handoff and transfer counters equal JAX's, with the serial loop and the
pipelined tick; a preemption of a slot queued for handoff; speculation
with sampling; the validation messages; the launcher's ``--disagg``.
Reduced tinyllama-42m in fp32 (page 8, chunk 16, 2 slots a replica), JAX's
init through the bridge."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import model as jmodel
from repro.core import steps as jsteps
from repro.core.kvcache import PageAllocator as JaxAllocator
from repro.core.kvcache import handoff_refs as jax_handoff_refs
from repro.core.partition import ShardingPlan as JaxPlan
from repro.serving import Request as JaxRequest
from repro.serving import SamplerConfig as JaxSampler
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.core import kvcache, model, steps
from repro_torch.core.kvcache import PageAllocator, handoff_refs
from repro_torch.core.partition import ShardingPlan
from repro_torch.launch import serve
from repro_torch.serving import (FCFSScheduler, Request, SamplerConfig,
                                 ServingEngine)

SB, PSZ, CHUNK, SLOTS = 64, 8, 16, 2
SIDES = {"jax": (JaxAllocator, jax_handoff_refs),
         "port": (PageAllocator, handoff_refs)}


# ---------------------------------------------------------- handoff_refs
@pytest.mark.parametrize("side", list(SIDES))
def test_handoff_refs_decrefs_source_once(side):
    """The source drops exactly one reference a page (pages the cache
    shares stay resident, the private tail frees); the destination owns
    its fresh run; the transfer counters move."""
    Alloc, handoff = SIDES[side]
    src, dst = Alloc(8), Alloc(8)
    pages = src.alloc(3)
    src.incref(pages[:2])              # the first two shared (prefix cache)
    fresh = dst.alloc(3)
    handoff(src, pages, dst, fresh)
    assert [src.refcount(p) for p in pages] == [1, 1, 0]
    assert src.n_free == 8 - 1 - 2
    assert all(dst.refcount(p) == 1 for p in fresh)
    assert (src.pages_transferred_out, dst.pages_transferred_in) == (3, 3)
    dst.decref(fresh)
    assert dst.n_free == 8 - 1


@pytest.mark.parametrize("side", list(SIDES))
def test_handoff_refs_refusals(side):
    """A shared destination page, one allocator on both sides and runs of
    different lengths are refused, and nothing moves."""
    Alloc, handoff = SIDES[side]
    src, dst = Alloc(8), Alloc(8)
    pages = src.alloc(2)
    shared = dst.alloc(2)
    dst.incref(shared)
    with pytest.raises(AssertionError, match="freshly allocated"):
        handoff(src, pages, dst, shared)
    assert all(src.refcount(p) == 1 for p in pages)
    assert src.pages_transferred_out == 0
    with pytest.raises(AssertionError, match="within one replica"):
        handoff(src, pages, src, pages)
    with pytest.raises(AssertionError):
        handoff(src, pages, dst, dst.alloc(1))


# ---------------------------------------------------------- transfer step
@pytest.mark.parametrize("kvd", ["float32", "int8"])
def test_transfer_step_byte_identical_to_jax(mesh1, kvd):
    """Random payloads (and scale rows) on replica 0's pages, the same
    numpy values in both packages' pools; a transfer of pages 2, 4 to
    replica 1's pages 1, 3 over 3 lanes (the third unused: scratch to
    scratch): every page but the scratch pages equals JAX's bit for bit;
    the source pages and a bystander are unchanged."""
    cfg = reduced(get_config("tinyllama-42m"), dtype="float32")
    jcfg = jax_reduced(jax_get_config("tinyllama-42m"), dtype="float32")
    n_pages, psz, lanes = 6, 4, 3
    jfn, _, _ = jsteps.make_page_transfer_step(
        jcfg, JaxPlan(tp=1, kv_cache_dtype=kvd), mesh1, n_pages, psz, lanes,
        n_replicas=2)
    jcache = jsteps.zero_paged_cache_for(
        jcfg, JaxPlan(tp=1, kv_cache_dtype=kvd), mesh1, n_pages, psz,
        n_replicas=2)
    cache = steps.zero_paged_cache_for(cfg, ShardingPlan(kv_cache_dtype=kvd),
                                       n_pages, psz, "cpu", n_replicas=2)
    rng = np.random.RandomState(0)

    def fill(a):
        """(reps, R, n_pages, ...) values: random on every page."""
        return (rng.randint(-127, 128, a.shape) if a.dtype == np.int8
                else rng.randn(*a.shape)).astype(a.dtype)

    # the same random values, (reps, R, n_pages, ...), in both packages'
    # pools, by name: JAX's pools as they are, the port's through its
    # unfold view
    mine = kvcache.unfold_replica_pools(cache, 2)
    vals = {}
    for g, (gj, gp) in enumerate(zip(jcache, mine)):
        for e, (ej, ep) in enumerate(zip(gj, gp)):
            assert sorted(ej["kv"]) == sorted(ep["kv"])
            for name, pool in ep["kv"].items():
                v = fill(np.asarray(ej["kv"][name]))
                ej["kv"][name] = jax.numpy.asarray(v)
                pool.copy_(torch.from_numpy(v))
                vals[g, e, name] = v
    assert any(v.dtype == np.int8 for v in vals.values()) == (kvd == "int8")
    src, dst = [2, 4, 0], [1, 3, 0]
    with mesh1:
        jout = jfn(jcache, np.int32(0), np.int32(1),
                   np.asarray(src, np.int32), np.asarray(dst, np.int32))
    # the port's step takes the ids folded, as its engine stages them
    fn = steps.make_page_transfer_step(2 * n_pages, lanes)
    fn(cache, torch.from_numpy(kvcache.fold_ids(src, 0, n_pages)),
       torch.from_numpy(kvcache.fold_ids(dst, 1, n_pages)))
    for (g, e, name), v in vals.items():
        got = mine[g][e]["kv"][name].numpy()
        want = np.asarray(jout[g][e]["kv"][name])
        np.testing.assert_array_equal(got[:, :, 1:], want[:, :, 1:])
        for s_, d in zip(src[:2], dst[:2]):
            np.testing.assert_array_equal(got[:, 1, d], v[:, 0, s_])
        np.testing.assert_array_equal(got[:, 0], v[:, 0])    # the source
        np.testing.assert_array_equal(got[:, 1, 5], v[:, 1, 5])
    with pytest.raises(ValueError, match="pool of 12 pages"):
        steps.make_page_transfer_step(n_pages, lanes)(
            cache, torch.zeros(lanes, dtype=torch.int32),
            torch.zeros(lanes, dtype=torch.int32))


# ------------------------------------------------------------------ engine
@pytest.fixture(scope="module")
def weights():
    """JAX's init for reduced tinyllama in fp32, x25 (greedy decoding does
    not collapse), and the port's copy."""
    jcfg = jax_reduced(jax_get_config("tinyllama-42m"), dtype="float32")
    jp = jax.tree_util.tree_map(
        lambda a: a * 25.0,
        jmodel.init_params(jcfg, JaxPlan(tp=1, kv_cache_dtype="float32")))
    cfg = reduced(get_config("tinyllama-42m"), dtype="float32")
    return jcfg, jp, cfg, params_from_jax(
        cfg, ShardingPlan(kv_cache_dtype="float32"),
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _requests(vocab, n=8, seed=0, max_new=(2, 7)):
    """JAX's ``tests/test_page_transfer.py`` mix: prompts of 4-19 tokens."""
    rng = np.random.RandomState(seed)
    return [(rid, rng.randint(2, vocab, int(rng.randint(4, 20))).astype(
        np.int32), int(rng.randint(*max_new))) for rid in range(n)]


def _engine(side, w, mesh, slots=SLOTS, **kw):
    jcfg, jp, cfg, params = w
    if side == "jax":
        return JaxEngine.build_paged(
            jcfg, JaxPlan(tp=1, kv_cache_dtype="float32"), mesh, slots, SB,
            jp, page_size=PSZ, prefill_chunk=CHUNK, prefix_cache=True, **kw)
    return ServingEngine.build_paged(
        cfg, ShardingPlan(kv_cache_dtype="float32"), slots, SB, params,
        page_size=PSZ, prefill_chunk=CHUNK, prefix_cache=True, device="cpu",
        **kw)


def _reqs(side, reqs):
    Req = JaxRequest if side == "jax" else Request
    return [Req(rid=i, prompt=p.copy(), max_new_tokens=m) for i, p, m in reqs]


def _serve(side, w, mesh, reqs, **kw):
    eng = _engine(side, w, mesh, **kw)
    rs = _reqs(side, reqs)
    for r in rs:
        eng.submit(r)
    eng.run(max_ticks=5000)
    assert all(r.done for r in rs)
    return eng, rs


def _summary(eng, rs):
    s = eng.stats
    return ([r.out_tokens for r in rs], [r.replica for r in rs], s.ticks,
            s.handoffs, s.pages_transferred, s.preemptions,
            s.plan_invalidations, s.prefill_tokens_skipped,
            [(x.role, x.routed, x.prefills, x.decoded_tokens, x.preemptions,
              x.handoffs_out, x.handoffs_in, x.pages_transferred_out,
              x.pages_transferred_in) for x in s.replicas],
            [(a.pages_transferred_out, a.pages_transferred_in)
             for a in eng.allocators])


def _leak_free(eng):
    assert eng.drain() == 0
    for r in range(eng.R):
        a, c = eng.allocators[r], eng.prefix_caches[r]
        cached = c.n_cached_pages if c is not None else 0
        assert a.n_free + cached == a.n_pages - a.n_reserved, r


@pytest.fixture(scope="module")
def oracle(weights, mesh1):
    reqs = _requests(weights[2].vocab_size)
    _, rs = _serve("port", weights, mesh1, reqs, overlap=False)
    return reqs, [r.out_tokens for r in rs]


@pytest.mark.parametrize("overlap", [False, True], ids=["serial", "overlap"])
def test_disagg_matches_jax_and_dp1(weights, mesh1, oracle, overlap):
    """disagg 1:1: every request prefills on replica 0 and finishes on
    replica 1; tokens, ticks, handoffs, pages moved, every replica's role,
    routing and handoff counters and the allocators' transfer counters
    equal JAX's; tokens equal the dp = 1 oracle's; both replicas
    leak-free."""
    reqs, want = oracle
    eng, rs = _serve("port", weights, mesh1, reqs, dp=2, disagg=(1, 1),
                     overlap=overlap)
    got = _summary(eng, rs)
    assert got == _summary(*_serve("jax", weights, mesh1, reqs, dp=2,
                                   disagg=(1, 1), overlap=overlap))
    assert got[0] == want
    assert all(r == 1 for r in got[1])
    assert got[3] == len(reqs) and got[4] > 0
    r0, r1 = eng.stats.replicas
    assert (r0.role, r1.role) == ("prefill", "decode")
    assert r0.routed == len(reqs) and r1.routed == 0
    assert r0.pages_transferred_out == r1.pages_transferred_in == got[4]
    _leak_free(eng)


def test_handoff_preemption_mid_transfer(weights, mesh1):
    """One decode slot: request 1 finishes its prefill while request 0
    holds it and queues for handoff; ``preempt`` it there.  It leaves the
    queue, re-prefills over its donated prefix and hands off later: tokens
    equal the dp = 1 oracle's, and ticks, handoffs (one a request) and
    preemptions equal JAX's same sequence; both replicas leak-free."""
    reqs = _requests(weights[2].vocab_size, n=2, seed=3, max_new=(8, 9))
    want = [r.out_tokens for r in _serve("port", weights, mesh1, reqs,
                                         overlap=False)[1]]
    runs = {}
    for side in ("jax", "port"):
        eng = _engine(side, weights, mesh1, slots=1, dp=2, disagg=(1, 1))
        rs = _reqs(side, reqs)
        for r in rs:
            eng.submit(r)
        for _ in range(200):
            if eng._pending_handoffs:
                break
            eng.tick()
        assert eng._pending_handoffs, "no slot ever queued for handoff"
        b = eng._pending_handoffs[0]
        assert eng.admissions[b].req.out_tokens
        eng.preempt(b)
        assert b not in eng._pending_handoffs and eng.admissions[b] is None
        eng.run(max_ticks=5000)
        assert all(r.done for r in rs)
        runs[side] = (eng, _summary(eng, rs))
    got = runs["port"][1]
    assert got == runs["jax"][1]
    assert got[0] == want and got[3] == len(reqs) and got[5] == 1
    assert runs["port"][0].stats.replicas[0].preemptions == 1
    _leak_free(runs["port"][0])


def test_disagg_speculation_and_sampling(weights, mesh1):
    """disagg 1:1 with speculative=4 (drafts on the decode replica only)
    and sampling (temperature 0.8, top_k 40, rng_seed 7): tokens equal
    JAX's disagg engine's and the port's dp = 1 sampled serial engine's
    (each request draws from its own stream wherever it runs)."""
    reqs = _requests(weights[2].vocab_size, seed=1)
    samp = dict(temperature=0.8, top_k=40)
    want = [r.out_tokens for r in _serve(
        "port", weights, mesh1, reqs, overlap=False, rng_seed=7,
        sampler=SamplerConfig(**samp))[1]]
    eng, rs = _serve("port", weights, mesh1, reqs, dp=2, disagg=(1, 1),
                     rng_seed=7, speculative=4,
                     sampler=SamplerConfig(**samp))
    jeng, jrs = _serve("jax", weights, mesh1, reqs, dp=2, disagg=(1, 1),
                       rng_seed=7, speculative=4, sampler=JaxSampler(**samp))
    assert _summary(eng, rs) == _summary(jeng, jrs)
    assert [r.out_tokens for r in rs] == want
    _leak_free(eng)


def test_disagg_validation(weights):
    """JAX's messages: P + D must cover dp with one of each role; the paged
    engine; attention-only archs; a scheduler factory; and requests that
    could prefill but never fit a decode replica."""
    _, _, cfg, params = weights
    plan = ShardingPlan(kv_cache_dtype="float32")
    kw = dict(page_size=PSZ, prefill_chunk=CHUNK, device="cpu")
    for pd in ((2, 1), (2, 0)):
        with pytest.raises(ValueError, match="P \\+ D == dp"):
            ServingEngine.build_paged(cfg, plan, 2, SB, params, dp=2,
                                      disagg=pd, **kw)
    with pytest.raises(ValueError, match="requires the paged engine"):
        ServingEngine(cfg, plan, 2, SB, params, disagg=(1, 1), device="cpu")
    ssm = reduced(get_config("mamba2-370m"), dtype="float32")
    with pytest.raises(ValueError, match="SSM slabs and cross-KV pages do "
                                         "not hand off"):
        ServingEngine.build_paged(
            ssm, plan, 2, SB, model.init_params(ssm, plan, device="cpu"),
            dp=2, disagg=(1, 1), **kw)
    with pytest.raises(ValueError, match="scheduler factory"):
        ServingEngine.build_paged(
            cfg, plan, 2, SB, params, dp=2, disagg=(1, 1),
            scheduler=FCFSScheduler(seq_budget=SB,
                                    allocator=PageAllocator(20),
                                    page_size=PSZ), **kw)
    eng = ServingEngine.build_paged(cfg, plan, 2, 32, params, n_pages=4,
                                    dp=2, disagg=(1, 1), page_size=PSZ,
                                    prefill_chunk=CHUNK, device="cpu")
    with pytest.raises(RuntimeError, match="never hand off"):
        eng.submit(Request(rid=0, prompt=np.arange(2, 20, dtype=np.int32),
                           max_new_tokens=12))
    assert "transfer" in eng.steps and eng.scheds[0].role == "prefill"


@pytest.mark.parametrize("argv,err", [
    (["--disagg", "1:1"], "needs --dp 2"),
    (["--dp", "3", "--disagg", "2:2"], "needs --dp 4"),
    (["--dp", "2", "--disagg", "1-1"], "expects P:D"),
    (["--dp", "0"], "--dp must be >= 1"),
])
def test_launcher_checks_disagg(argv, err, capsys):
    """The JAX launcher's checks of ``--dp`` and ``--disagg``."""
    with pytest.raises(SystemExit) as e:
        serve.parse_args(["--arch", "tinyllama-42m", *argv])
    assert e.value.code == 2
    assert err in capsys.readouterr().err
