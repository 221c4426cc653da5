"""The port's radix prefix cache slice against the JAX package on the CPU.

- ``blocks._page_write`` with chunk positions past the block table (a chunk
  resuming mid-prompt after a prefix hit runs past the sequence budget):
  the pools equal JAX's, whose scatter drops those rows.
- ``PageAllocator`` refcounts and ``RadixPrefixCache`` under the same
  operation sequences as JAX's: lookups, splits, LRU eviction, shared
  protection; the radix-path drafts of ``PromptLookupDraft``.
- ``steps.make_page_copy_step`` against JAX's, float and int8 pools.
- ``FCFSScheduler`` planning COW, rolling back under pressure, skipping an
  eviction that would not cover the shortfall, falling back to a cold
  prefill: the same admissions as JAX's scheduler.
- The paged engine with ``prefix_cache=True`` against JAX's
  ``build_paged(prefix_cache=True)`` (weights through
  ``bridge.params_from_jax``): greedy tokens, ticks, prefix hits, skipped
  prefill tokens and COW copies, float and int8 pools, with and without
  speculation, ``overlap`` off and on; forced preemption reusing the
  donated KV; the launcher's prefix-cache flags.

Tolerance: fp32 1e-4 (``tests/test_kernels.py``); engines compare greedy
tokens exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import blocks as jblocks
from repro.core import model as jmodel
from repro.core import steps as jsteps
from repro.core.kvcache import PageAllocator as JaxAllocator
from repro.core.partition import ShardingPlan as JaxPlan
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving.prefix_cache import PromptLookupDraft as JaxDraft
from repro.serving.prefix_cache import RadixPrefixCache as JaxRadix
from repro.serving.scheduler import FCFSScheduler as JaxFCFS
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.core import blocks, steps
from repro_torch.core.kvcache import PageAllocator
from repro_torch.core.partition import ShardingPlan
from repro_torch.launch import serve
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.prefix_cache import (PromptLookupDraft,
                                              RadixPrefixCache)
from repro_torch.serving.scheduler import FCFSScheduler

FP32_TOL = dict(rtol=1e-4, atol=1e-4)
PSZ = 4


def toks(*ids):
    return np.asarray(ids, np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ the repair
@pytest.mark.parametrize("kvd", ["float32", "int8"])
def test_page_write_past_the_block_table_matches_jax(kvd):
    """A chunk of 8 positions from 13 over a 4-page table of 4-token pages
    (16 positions): rows 13-15 land in the table, rows 16-20 run past it
    and write nothing (JAX's gather fills them out of bounds, its scatter
    drops them); a negative position (a padded verify column) goes to the
    scratch page in both.  Every page but scratch page 0, whose contents
    no slot reads, equals JAX's, payload and scale rows."""
    rng = np.random.RandomState(1)
    B, G, C, D, psz, n_pages = 2, 2, 8, 8, 4, 10
    kg, vg = (rng.randn(B, G, C, D).astype(np.float32) for _ in range(2))
    positions = np.stack([np.arange(13, 13 + C),
                          np.r_[np.arange(2, 9), -1]]).astype(np.int32)
    bt = np.asarray([[3, 7, 1, 5], [2, 9, 6, 8]], np.int32)
    pool_dt = np.int8 if kvd == "int8" else np.float32
    kv = {"kp": rng.randint(-5, 5, (n_pages, G, psz, D)).astype(pool_dt),
          "vp": rng.randint(-5, 5, (n_pages, G, psz, D)).astype(pool_dt)}
    if kvd == "int8":
        kv["ksp"] = rng.rand(n_pages, psz).astype(np.float32)
        kv["vsp"] = rng.rand(n_pages, psz).astype(np.float32)
    want = jblocks._page_write({k: jnp.asarray(v) for k, v in kv.items()},
                               jnp.asarray(kg), jnp.asarray(vg),
                               jnp.asarray(positions), jnp.asarray(bt), psz)
    got = blocks._page_write({k: _t(v.copy()) for k, v in kv.items()},
                             _t(kg), _t(vg), _t(positions), _t(bt), psz)
    for name in kv:
        np.testing.assert_allclose(got[name][1:].float().numpy(),
                                   np.asarray(want[name][1:], np.float32),
                                   **FP32_TOL)
    # the rows past the table left the slot's pages and every other page
    # as they were
    np.testing.assert_array_equal(got["kp"][4].numpy(), kv["kp"][4])
    assert not np.array_equal(got["kp"][5].numpy()[:, 1:], kv["kp"][5][:, 1:])


# ------------------------------------------------- allocator and radix tree
def _pair(n_pages=32):
    """The JAX and the port's allocator and cache, side by side."""
    ja, ta = JaxAllocator(n_pages), PageAllocator(n_pages)
    return (ja, JaxRadix(ja, PSZ)), (ta, RadixPrefixCache(ta, PSZ))


def _state(alloc, cache):
    return (alloc.n_free, alloc.total_allocated,
            [alloc.refcount(p) for p in range(alloc.n_pages)],
            cache.n_nodes, cache.n_cached_pages, cache.n_evictable_pages,
            cache.evictions, sorted(cache.entries()))


def _scenario(name, alloc, cache):
    """One radix operation sequence (the JAX package's
    ``tests/test_prefix_cache.py`` cases) -> what each step returned."""
    out = []
    if name == "miss-hit":
        out.append(cache.lookup(toks(1, 2, 3, 4)))
        pages = alloc.alloc(2)
        out.append(cache.insert(toks(1, 2, 3, 4, 5, 6, 7, 8), pages))
        for q in (toks(1, 2, 3, 4, 5, 6, 7, 8), toks(1, 2, 3, 4),
                  toks(9, 9, 9, 9)):
            out.append(cache.lookup(q))
    elif name == "partial-cow":
        pages = alloc.alloc(2)
        cache.insert(toks(1, 2, 3, 4, 5, 6, 7, 8), pages)
        out.append(cache.lookup(toks(1, 2, 99, 98, 97)))
        out.append(cache.lookup(toks(1, 2, 3, 4, 5, 99)))
    elif name == "split":
        p1 = alloc.alloc(2)
        cache.insert(toks(1, 2, 3, 4, 5, 6, 7, 8), p1)
        p2 = alloc.alloc(2)
        out.append(cache.insert(toks(1, 2, 3, 4, 50, 60, 70, 80), p2))
        out.append(cache.lookup(toks(1, 2, 3, 4, 50, 60, 70, 80)))
        out.append(cache.lookup(toks(1, 2, 3, 4, 5, 6, 7, 8)))
    elif name == "lru-shared":
        p1, p2 = alloc.alloc(1), alloc.alloc(1)
        cache.insert(toks(1, 2, 3, 4), p1)
        cache.insert(toks(9, 8, 7, 6), p2)
        alloc.decref(p1)
        cache.lookup(toks(1, 2, 3, 4))
        out.append(cache.evict(1))        # run 2 is shared: run 1 goes
        out.append(cache.lookup(toks(1, 2, 3, 4)))
        out.append(cache.lookup(toks(9, 8, 7, 6)))
        alloc.decref(p2)
        out.append(cache.evict(5))
    elif name == "children-first":
        p = alloc.alloc(3)
        cache.insert(toks(1, 2, 3, 4, 5, 6, 7, 8), p[:2])
        cache.insert(toks(1, 2, 3, 4, 50, 60, 70, 80), [p[0], p[2]])
        alloc.decref(p)
        out.append(cache.evict(3))
    elif name == "random":
        rng = np.random.RandomState(7)
        held = []
        for _ in range(60):
            act = rng.randint(4)
            seq = toks(*rng.randint(2, 5, 4 * rng.randint(1, 5)))
            if act == 0:
                out.append(cache.lookup(np.r_[seq, rng.randint(2, 5, 3)]))
            elif act == 1:
                pages = alloc.alloc(len(seq) // PSZ)
                if pages is not None:
                    out.append(cache.insert(seq, pages))
                    held.append(pages)
            elif act == 2 and held:
                alloc.decref(held.pop(rng.randint(len(held))))
            else:
                out.append(cache.evict(int(rng.randint(1, 4))))
            out.append(_state(alloc, cache)[:6])
        for pages in held:
            alloc.decref(pages)
        out.append(cache.evict(10 ** 6))
    return out


@pytest.mark.parametrize("name", ["miss-hit", "partial-cow", "split",
                                  "lru-shared", "children-first", "random"])
def test_radix_operations_match_jax(name):
    """The same lookups, inserts, splits, decrefs and evictions on both
    caches return the same matches, page runs and freed counts, and leave
    the same refcounts, nodes, evictable pages and leaf paths."""
    (ja, jc), (ta, tc) = _pair()
    assert _scenario(name, ta, tc) == _scenario(name, ja, jc)
    assert _state(ta, tc) == _state(ja, jc)
    if name in ("lru-shared", "children-first", "random"):
        assert tc.n_nodes == 0 and ta.n_free == ta.n_pages - 1


def test_allocator_refcounts_match_jax():
    """incref/decref/total_allocated as in JAX; a freed page cannot be
    shared."""
    for alloc in (JaxAllocator(8), PageAllocator(8)):
        pages = alloc.alloc(3)
        alloc.incref(pages)
        alloc.decref(pages)
        assert alloc.n_free == 4 and [alloc.refcount(p) for p in pages] == \
            [1, 1, 1]
        alloc.decref(pages)
        assert alloc.n_free == 7 and alloc.total_allocated == 3
        with pytest.raises(AssertionError):
            alloc.incref([pages[0]])


@pytest.mark.parametrize("context,k", [
    ([7, 1, 2, 3], 3), ([5, 6, 1, 2], 4), ([9, 9, 9, 40, 41], 2),
    ([1, 2, 3, 4, 1, 2], 3)])
def test_radix_path_drafts_match_jax(context, k):
    """With a cache, a gram the context does not repeat is looked up along
    the cached token paths (the longest continuation wins), as in JAX."""
    (ja, jc), (ta, tc) = _pair()
    for cache, alloc in ((jc, ja), (tc, ta)):
        cache.insert(toks(1, 2, 3, 4, 5, 6, 7, 8), alloc.alloc(2))
        cache.insert(toks(1, 2, 3, 4, 50, 60, 70, 80), alloc.alloc(2))
        cache.insert(toks(5, 6, 1, 2, 3, 9, 9, 9), alloc.alloc(2))
    got = PromptLookupDraft(tc).draft(np.asarray(context), k)
    assert got == JaxDraft(jc).draft(np.asarray(context), k)
    assert PromptLookupDraft().draft(np.asarray(context), k) == \
        JaxDraft().draft(np.asarray(context), k)


# ------------------------------------------------------------ page copy
@pytest.mark.parametrize("kvd", ["float32", "int8"])
def test_page_copy_step_matches_jax(mesh1, kvd):
    """Page 2 onto page 5 in every layer's pool (payload and scale rows),
    every other page untouched, as JAX's copy step; src == dst is the
    identity."""
    jcfg = jax_reduced(jax_get_config("tinyllama-42m"), dtype="float32")
    jplan = JaxPlan(tp=1, kv_cache_dtype=kvd)
    n_pages, psz = 6, 4
    jcopy, _, _ = jsteps.make_page_copy_step(jcfg, jplan, mesh1, n_pages, psz)
    rng = np.random.RandomState(0)
    jcache = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.randn(*x.shape) * 40, x.dtype),
        jsteps.zero_paged_cache_for(jcfg, jplan, mesh1, n_pages, psz))
    cache = [[{kind: {name: _t(np.array(pool)[:, 0]) for name, pool in
                      pools.items()} for kind, pools in entry.items()}
              for entry in group] for group in jcache]
    copy = steps.make_page_copy_step(n_pages)
    with mesh1:
        jout = jax.jit(jcopy)(jcache, jnp.asarray([2], jnp.int32),
                              jnp.asarray([5], jnp.int32))
    out = copy(cache, torch.tensor([2], dtype=torch.int32),
               torch.tensor([5], dtype=torch.int32))
    names = set()
    for group, jgroup in zip(out, jout, strict=True):
        for entry, jentry in zip(group, jgroup, strict=True):
            for name, pool in entry["kv"].items():
                names.add(name)
                np.testing.assert_array_equal(
                    pool.numpy(), np.asarray(jentry["kv"][name])[:, 0])
                np.testing.assert_array_equal(pool[:, 5].numpy(),
                                              pool[:, 2].numpy())
    assert names == ({"kp", "vp", "ksp", "vsp"} if kvd == "int8"
                     else {"kp", "vp"})
    before = [t.clone() for g in out for e in g for t in e["kv"].values()]
    copy(out, torch.tensor([3], dtype=torch.int32),
         torch.tensor([3], dtype=torch.int32))
    after = [t for g in out for e in g for t in e["kv"].values()]
    assert all(torch.equal(a, b) for a, b in zip(after, before, strict=True))


# ------------------------------------------------------------- scheduler
class _Req:
    def __init__(self, rid, prompt, max_new):
        self.rid, self.prompt, self.max_new_tokens = rid, prompt, max_new


def _sched_scenario(name, Sched, Alloc, Radix):
    """The JAX package's scheduler cases (``tests/test_prefix_cache.py``)
    on one side -> the admissions and refcounts each step saw."""
    a = Alloc({"cow": 8, "futile": 11, "cold": 8}[name])
    c = Radix(a, PSZ)
    sched = Sched(seq_budget=64, allocator=a, page_size=PSZ, prefix_cache=c,
                  stats=None)
    log = []

    def adm_view(adms):
        return [(x.req.rid, x.pages, x.cached_len, x.cow) for x in adms]

    if name == "cow":
        seed_pages = a.alloc(2)
        c.insert(toks(1, 2, 3, 4, 5, 6, 7, 8), seed_pages)
        a.decref(seed_pages)
        sched.submit(_Req(0, toks(1, 2, 3, 4, 5, 6, 90, 91), 4))
        (adm,) = sched.plan([0])
        log += [adm_view([adm]), [a.refcount(p) for p in seed_pages]]
        sched.on_cow_done(adm)
        log.append([a.refcount(p) for p in seed_pages])
        sched.submit(_Req(1, toks(*range(40, 60)), 4))
        log.append(adm_view(sched.plan([1])))          # blocks, rolled back
        log.append([a.refcount(p) for p in seed_pages])
        sched.on_finish(adm)
        log.append(adm_view(sched.plan([1])))          # evicts, admits
        log.append(c.n_nodes)
    elif name == "futile":
        slot_held = a.alloc(6)
        run = a.alloc(2)
        c.insert(toks(1, 2, 3, 4, 5, 6, 7, 8), run)
        a.decref(run)
        sched.submit(_Req(0, toks(*range(20, 38)), 2))
        log += [adm_view(sched.plan([0])), c.n_nodes]  # blocks, keeps the run
        a.decref(slot_held)
        (adm,) = sched.plan([0])
        log += [adm_view([adm]), c.n_nodes]
        sched.on_finish(adm)
    else:
        run = a.alloc(2)
        c.insert(toks(1, 2, 3, 4, 5, 6, 7, 8), run)
        a.decref(run)
        sched.submit(_Req(0, toks(1, 2, 3, 4, 5, 6, *range(90, 105)), 7))
        (adm,) = sched.plan([0])                       # cold, run evicted
        log += [adm_view([adm]), c.n_nodes]
        sched.on_finish(adm)
    log.append((a.n_free, sched.backlog_pages, sched.has_pending()))
    return log


@pytest.mark.parametrize("name", ["cow", "futile", "cold"])
def test_scheduler_cow_rollback_and_eviction_match_jax(name):
    """COW planning and rollback under pressure, a blocked admission that
    does not wipe a hot run it could not use, and the fallback to a cold
    prefill when the prefix pins themselves block: the same admissions,
    page runs, COW pairs and refcounts as JAX's scheduler."""
    got = _sched_scenario(name, FCFSScheduler, PageAllocator,
                          RadixPrefixCache)
    assert got == _sched_scenario(name, JaxFCFS, JaxAllocator, JaxRadix)
    if name == "cow":
        assert got[0][0][2] == 6 and got[0][0][3] is not None
    if name == "cold":
        assert got[0][0][2] == 0 and got[1] == 0


# --------------------------------------------------------------- engine
SB, SLOTS, PSZ_E, CHUNK = 64, 2, 8, 16


def _weights(kvd, scale):
    jcfg = jax_reduced(jax_get_config("tinyllama-42m"), dtype="float32")
    jplan = JaxPlan(tp=1, kv_cache_dtype=kvd)
    jp = jax.tree_util.tree_map(lambda a: a * scale,
                                jmodel.init_params(jcfg, jplan))
    cfg = reduced(get_config("tinyllama-42m"), dtype="float32")
    plan = ShardingPlan(kv_cache_dtype=kvd)
    return jcfg, jplan, jp, cfg, plan, params_from_jax(
        cfg, plan, jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def shared_prompts(vocab, seed=0):
    """A shared 21-token system prompt with short suffixes, one prompt that
    leaves it mid-page (COW) and a resubmitted prompt (COW through the
    one-token prefill floor): ``tests/test_prefix_cache.py``'s mix."""
    rng = np.random.RandomState(seed)
    base = rng.randint(2, vocab, 21).astype(np.int32)
    out = [np.concatenate([base, rng.randint(2, vocab, 3 + i)]).astype(
        np.int32) for i in range(5)]
    out.append(np.concatenate([base[:5], rng.randint(2, vocab, 6)]).astype(
        np.int32))
    out.append(out[0].copy())
    return out


def _serve(Engine, Req, args, prompts, max_new, **kw):
    eng = Engine.build_paged(*args, page_size=PSZ_E, prefill_chunk=CHUNK,
                             **kw)
    reqs = [Req(rid=i, prompt=p.copy(), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_ticks=3000)
    assert all(r.done for r in reqs)
    return eng, [r.out_tokens for r in reqs]


@pytest.mark.parametrize("overlap", [False, True], ids=["serial", "overlap"])
@pytest.mark.parametrize("kvd,scale,k", [
    ("float32", 25, 0), ("int8", 25, 0), ("float32", 1, 4), ("int8", 1, 4)],
    ids=["float", "int8", "float-spec", "int8-spec"])
def test_prefix_cache_engine_matches_jax(mesh1, kvd, scale, k, overlap):
    """The shared-prefix mix on both engines with ``prefix_cache=True``:
    identical greedy tokens, ticks, prefills, prefix lookups and hits,
    skipped prefill tokens and COW copies (and, with speculation, drafts
    searched along the cache's paths: the same drafting counters); the
    cache-off port engine's tokens too; every page free or cached after
    ``drain()``, and free after a full evict."""
    jcfg, jplan, jp, cfg, plan, params = _weights(kvd, scale)
    prompts = shared_prompts(cfg.vocab_size)
    jeng, jtoks = _serve(JaxEngine, JaxRequest, (jcfg, jplan, mesh1, SLOTS,
                                                 SB, jp), prompts, 6,
                         prefix_cache=True, speculative=k, overlap=overlap)
    eng, toks_ = _serve(ServingEngine, Request, (cfg, plan, SLOTS, SB,
                                                 params), prompts, 6,
                        prefix_cache=True, speculative=k, overlap=overlap,
                        device="cpu")
    assert toks_ == jtoks
    st, jst = eng.stats, jeng.stats
    fields = ("ticks", "prefills", "prefix_lookups", "prefix_hits",
              "prefill_tokens_skipped", "cow_copies", "plan_ahead_ticks",
              "spec_steps", "spec_drafted", "spec_accepted",
              "spec_draft_hits")
    assert [getattr(st, f) for f in fields] == [getattr(jst, f)
                                                for f in fields]
    assert st.cow_copies >= 2 and st.prefill_tokens_skipped > 0
    assert st.prefix_hit_rate == jst.prefix_hit_rate > 0
    assert not k or st.spec_accepted > 0
    _, off = _serve(ServingEngine, Request, (cfg, plan, SLOTS, SB, params),
                    prompts, 6, speculative=k, overlap=overlap, device="cpu")
    assert off == toks_
    assert eng.drain() == 0
    usable = eng.allocator.n_pages - 1
    assert eng.allocator.n_free + eng.prefix_cache.n_cached_pages == usable
    assert eng.allocator.total_allocated == jeng.allocator.total_allocated
    eng.prefix_cache.evict(usable)
    assert eng.allocator.n_free == usable


@pytest.mark.parametrize("overlap", [False, True], ids=["serial", "overlap"])
def test_forced_preemption_reuses_the_donated_kv(mesh1, overlap):
    """One slot: a request preempted mid-decode (after its output spills
    into a generated page) and another mid-prefill resume as prefix hits
    on the pages they donated and emit the uncontended continuation, as
    in JAX's engine (``tests/test_scheduling.py``)."""
    jcfg, jplan, jp, cfg, plan, params = _weights("float32", 25)
    rng = np.random.RandomState(5)
    p1 = rng.randint(2, cfg.vocab_size, 12).astype(np.int32)
    p2 = rng.randint(2, cfg.vocab_size, 20).astype(np.int32)
    runs = {}
    for side, Engine, Req, args in (
            ("jax", JaxEngine, JaxRequest, (jcfg, jplan, mesh1, 1, SB, jp)),
            ("port", ServingEngine, Request, (cfg, plan, 1, SB, params))):
        kw = {} if side == "jax" else {"device": "cpu"}
        _, ref = _serve(Engine, Req, args, [p1, p2], 8, prefix_cache=True,
                        overlap=overlap, **kw)
        eng = Engine.build_paged(*args, page_size=PSZ_E, prefill_chunk=8,
                                 prefix_cache=True, overlap=overlap, **kw)
        r1 = Req(rid=0, prompt=p1.copy(), max_new_tokens=8)
        r2 = Req(rid=1, prompt=p2.copy(), max_new_tokens=4)
        eng.submit(r1)
        eng.submit(r2)
        while len(r1.out_tokens) < 6:
            eng.tick()
        eng.preempt(0)
        while not (eng.admissions[0] is not None and
                   eng.admissions[0].req is r2 and
                   eng.slot_state[0] == "prefill" and eng.prefill_done[0]):
            eng.tick()
        eng.preempt(0)
        st = eng.run(max_ticks=3000)
        assert r1.done and r2.done
        # the uncontended continuation (greedy: a 4-token budget emits the
        # first 4 of the 8)
        assert [r1.out_tokens, r2.out_tokens] == [ref[0], ref[1][:4]]
        runs[side] = ([r1.out_tokens, r2.out_tokens], st.ticks,
                      st.preemptions, st.prefill_tokens_skipped)
        assert st.preemptions == 2 and st.prefill_tokens_skipped >= 16
        usable = eng.allocator.n_pages - 1
        assert eng.allocator.n_free + eng.prefix_cache.n_cached_pages == \
            usable
    assert runs["port"] == runs["jax"]


def test_prefix_cache_is_refused_where_jax_refuses_it():
    """An SSM arch, and the contiguous engine, refuse the prefix cache."""
    cfg = reduced(get_config("mamba2-370m"), dtype="float32")
    from repro_torch.core import model
    params = model.init_params(cfg, ShardingPlan(kv_cache_dtype="float32"),
                               torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="recurrent state that a token-id "
                                         "prefix cannot address"):
        ServingEngine.build_paged(cfg, ShardingPlan(kv_cache_dtype="float32"),
                                  2, 32, params, page_size=8, prefill_chunk=8,
                                  prefix_cache=True, device="cpu")
    tcfg = reduced(get_config("tinyllama-42m"), dtype="float32")
    tparams = model.init_params(tcfg, ShardingPlan(kv_cache_dtype="float32"),
                                torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="paged engine"):
        ServingEngine(tcfg, ShardingPlan(kv_cache_dtype="float32"), 2, 32,
                      tparams, prefix_cache=True, device="cpu")


# --------------------------------------------------------------- launcher
LAUNCH = ["--arch", "tinyllama-42m", "--smoke", "--requests", "5", "--slots",
          "2", "--seq-budget", "64", "--prompt-len", "12", "--max-new", "4",
          "--page-size", "8", "--prefill-chunk", "16", "--kv-dtype", "fp32",
          "--device", "cpu"]


def test_launcher_serves_the_prefix_cache(capsys):
    """``--prefix-cache --shared-prefix 12`` (implies the paged engine)
    prints JAX's ``prefix_cache:`` line with hits, skipped tokens and COW
    copies."""
    assert serve.main([*LAUNCH, "--prefix-cache", "--shared-prefix",
                       "12"]) == 0
    out = capsys.readouterr().out
    assert "engine=paged" in out and "tokens=20" in out
    line = next(x for x in out.splitlines() if x.startswith("prefix_cache:"))
    assert "hit_rate=" in line and "cow_copies=" in line
    assert int(line.split("prefill_tokens_skipped=")[1].split()[0]) > 0


def test_launcher_refuses_the_prefix_cache_for_mamba2_as_jax_does(mesh1):
    """``--prefix-cache --arch mamba2-370m`` raises the JAX engine's
    error."""
    argv = [*LAUNCH, "--prefix-cache"]
    argv[argv.index("--arch") + 1] = "mamba2-370m"
    from repro.launch import serve as jserve
    with pytest.raises(ValueError) as want:
        jserve.main([a for a in argv if a not in ("--device", "cpu")])
    with pytest.raises(ValueError) as got:
        serve.main(argv)
    assert str(got.value) == str(want.value)
    assert "token-id prefix cannot address" in str(got.value)
