"""Data-parallel replicas in the port against the JAX package on the CPU:
the replica-folded pools (``fold``/``unfold`` are views: a write through
either lands in the pool the steps write), the router's decisions on a
scripted sequence, and the dp = 2 paged engine against JAX's dp = 2 engine
and the dp = 1 oracle: greedy tokens under FCFS, priority and fair (with
preemption and the prefix cache), float and int8 pools, speculation
(k = 3), mamba2's slabs with a forced preemption; the pools' bytes against
JAX's (reps, R, n_pages, ...) layout; per-replica counters; leak-free
replicas after ``drain()``; the dp checks' messages.  Reduced tinyllama-42m
(page 8, chunk 16, 2 slots a replica) and mamba2-370m in fp32, JAX's init
through the bridge."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import kvcache as jkv
from repro.core import model as jmodel
from repro.core.kvcache import PageAllocator as JaxAllocator
from repro.core.partition import ShardingPlan as JaxPlan
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving.policies import FairScheduler as JaxFair
from repro.serving.policies import PriorityScheduler as JaxPriority
from repro.serving.prefix_cache import CrossKVCache as JaxCross
from repro.serving.prefix_cache import RadixPrefixCache as JaxRadix
from repro.serving.router import Router as JaxRouter
from repro.serving.scheduler import FCFSScheduler as JaxFCFS
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.core import kvcache, steps
from repro_torch.core.kvcache import PageAllocator
from repro_torch.core.model import init_params
from repro_torch.core.model import tree_map as model_tree_map
from repro_torch.core.partition import ShardingPlan
from repro_torch.serving import (CrossKVCache, FairScheduler,
                                 PriorityScheduler, RadixPrefixCache,
                                 Request, ServingEngine)
from repro_torch.serving.router import Router
from repro_torch.serving.scheduler import FCFSScheduler

SB, PSZ, CHUNK, SLOTS = 64, 8, 16, 2


@pytest.fixture(scope="module")
def weights():
    """JAX's init for the reduced configs in fp32 and the port's copy:
    tinyllama x25 (greedy decoding does not collapse), mamba2 at init
    scale."""
    out = {}
    for arch, scale in (("tinyllama-42m", 25.0), ("mamba2-370m", 1.0)):
        jcfg = jax_reduced(jax_get_config(arch), dtype="float32")
        jp = jax.tree_util.tree_map(
            lambda a, s=scale: a * s,
            jmodel.init_params(jcfg, JaxPlan(tp=1, kv_cache_dtype="float32")))
        cfg = reduced(get_config(arch), dtype="float32")
        out[arch] = (jcfg, jp, cfg, params_from_jax(
            cfg, ShardingPlan(kv_cache_dtype="float32"),
            jax.tree_util.tree_map(np.asarray, jp), device="cpu"))
    return out


# ------------------------------------------------------------ folded pools
def test_fold_unfold_are_views_of_jax_layout():
    """The folded pools are JAX's (reps, R, n_pages, ...) bytes: unfold is
    a view (same storage, a write through it lands in the pool), fold of
    the unfolded view gives the pool's own storage back, and both equal
    JAX's fold/unfold on the same values."""
    cfg = reduced(get_config("tinyllama-42m"), dtype="float32")
    for kvd in ("float32", "int8"):
        cache = steps.zero_paged_cache_for(cfg, ShardingPlan(
            kv_cache_dtype=kvd), 6, 4, "cpu", n_replicas=2)
        un = kvcache.unfold_replica_pools(cache, 2)
        back = kvcache.fold_replica_pools(un)
        for pool, u, f in zip(cache[0][0]["kv"].values(),
                              un[0][0]["kv"].values(),
                              back[0][0]["kv"].values()):
            assert u.shape[:3] == (pool.shape[0], 2, 6)
            assert u.data_ptr() == pool.data_ptr() == f.data_ptr()
            assert f.shape == pool.shape
            u[:, 1, 3] = 7                 # replica 1's page 3
            assert bool((pool[:, 6 + 3] == 7).all())
            vals = np.arange(pool.numel(), dtype=np.float32).reshape(
                pool.shape)
            ref = np.asarray(jkv.unfold_replica_pools(jnp.asarray(vals), 2))
            np.testing.assert_array_equal(kvcache.unfold_replica_pools(
                torch.from_numpy(vals), 2).numpy(), ref)
            np.testing.assert_array_equal(np.asarray(
                jkv.fold_replica_pools(jnp.asarray(ref))), vals)


def test_replica_template_sizes():
    """Pages and slabs per replica, folded: R x n_pages (R x n_slabs) rows,
    scale rows too."""
    cfg = reduced(get_config("mamba2-370m"), dtype="float32")
    c = steps.zero_paged_cache_for(cfg, ShardingPlan(ssm_cache_dtype="int8"),
                                   5, 4, "cpu", n_slabs=3, n_replicas=2)
    ssm = c[0][0]["ssm"]
    assert {k: v.shape[1] for k, v in ssm.items()} == dict.fromkeys(ssm, 6)
    with pytest.raises(ValueError, match="n_replicas"):
        steps.zero_paged_cache_for(cfg, ShardingPlan(), 5, 4, "cpu",
                                   n_slabs=3, n_replicas=0)


# ------------------------------------------------------------------ router
def _router_script(side):
    """A scripted placement sequence on one side's classes -> the replica
    chosen at every step: least load, prefix affinity (resident and
    recently routed), sticky resume, frames affinity, draining, decode
    placement under roles."""
    Alloc, Radix, Cross, FCFS, Rtr, Req = {
        "jax": (JaxAllocator, JaxRadix, JaxCross, JaxFCFS, JaxRouter,
                JaxRequest),
        "port": (PageAllocator, RadixPrefixCache, CrossKVCache, FCFSScheduler,
                 Router, Request)}[side]
    log = []
    allocs = [Alloc(40) for _ in range(3)]
    radix = [Radix(a, 4) for a in allocs]
    scheds = [FCFS(seq_budget=64, allocator=a, page_size=4, prefix_cache=c)
              for a, c in zip(allocs, radix)]
    rtr = Rtr(scheds, allocs, radix, 4)
    rng = np.random.RandomState(0)
    shared = rng.randint(2, 500, 12).astype(np.int32)
    # replica 2 holds a cached 12-token prefix
    pages = allocs[2].alloc(3)
    radix[2].insert(shared, pages)
    allocs[2].decref(pages)

    def place(req):
        r = rtr.route(req)
        scheds[r].submit(req)
        rtr.commit(req, r)
        log.append(r)
        return r

    for rid in range(4):                            # least load
        place(Req(rid=rid, prompt=rng.randint(2, 500, 6 + rid).astype(
            np.int32), max_new_tokens=4))
    place(Req(rid=10, prompt=np.concatenate(       # resident affinity
        [shared, [3, 4]]).astype(np.int32), max_new_tokens=4))
    burst = rng.randint(2, 500, 9).astype(np.int32)
    for rid in (11, 12):                            # recent-window affinity
        place(Req(rid=rid, prompt=np.concatenate([burst, [rid]]).astype(
            np.int32), max_new_tokens=2))
    resumed = Req(rid=13, prompt=burst.copy(), max_new_tokens=6)
    resumed.out_tokens = [5, 6, 7]                  # sticky resume
    place(resumed)
    log.append(rtr.affinity_routed)
    log.append([rtr.page_load(r) for r in range(3)])
    rtr.mark_draining(0)
    place(Req(rid=14, prompt=rng.randint(2, 500, 5).astype(np.int32),
              max_new_tokens=2))
    log.append(rtr.decode_placement([0, 1, 2]))
    # frames affinity over cross-KV caches, and roles
    allocs = [Alloc(40) for _ in range(3)]
    cross = [Cross(a) for a in allocs]
    scheds = [FCFS(seq_budget=64, allocator=a, page_size=4, cross_cache=x,
                   cross_pages_per_req=2) for a, x in zip(allocs, cross)]
    rtr = Rtr(scheds, allocs, [None] * 3, 4, cross_caches=cross,
              roles=["prefill", "prefill", "decode"])
    frames = rng.randn(3, 4).astype(np.float32)
    key = Cross.digest(frames)
    pages = allocs[1].alloc(2)
    cross[1].insert(key, pages)
    allocs[1].decref(pages)
    place(Req(rid=20, prompt=rng.randint(2, 500, 5).astype(np.int32),
              frames=frames, max_new_tokens=2))
    place(Req(rid=21, prompt=rng.randint(2, 500, 5).astype(np.int32),
              frames=rng.randn(3, 4).astype(np.float32), max_new_tokens=2))
    log.append(rtr.decode_placement([2]))
    return log


def test_router_matches_jax():
    """The same placements as JAX's ``Router`` at every step."""
    got = _router_script("port")
    assert got == _router_script("jax")
    assert got[4] == 2 and got[5] == got[6] == got[7] and got[8] >= 3
    assert got[10] != 0 and got[12] == 1      # draining 0; frames hit on 1


# ------------------------------------------------------------------ engine
def _mixed(vocab, n=9, seed=0, shared=12):
    """(rid, prompt, max_new, priority, client): two 12-token system
    prompts (one full page and a partial one), request i behind the
    (i mod 2)-th, so prefix affinity spreads them over two replicas;
    every 3rd request urgent, three clients."""
    rng = np.random.RandomState(seed)
    heads = [rng.randint(2, vocab, shared) for _ in range(2)]
    return [(i, np.concatenate([heads[i % 2], rng.randint(2, vocab, int(
        rng.randint(4, 12)))]).astype(np.int32), int(rng.randint(6, 12)),
        10 if i % 3 == 2 else 0, i % 3) for i in range(n)]


def _arrivals(eng, reqs, first=2, every=3, max_ticks=3000):
    """Submit the first ``first`` requests at once, then one every
    ``every`` ticks, and tick until all are done."""
    waiting, tick = list(reqs), 0
    while waiting or eng.has_pending() or \
            any(a is not None for a in eng.admissions):
        assert tick < max_ticks
        n_in = len(reqs) - len(waiting)
        while waiting and (n_in < first or tick >= every * (n_in - first + 1)):
            eng.submit(waiting.pop(0))
            n_in += 1
        eng.tick()
        tick += 1
    eng.run()


POLICIES = {"fcfs": (None, None),
            "priority": (functools.partial(PriorityScheduler, preemption=True),
                         functools.partial(JaxPriority, preemption=True)),
            "fair": (functools.partial(FairScheduler, preemption=True,
                                       quantum=8, preempt_after=1),
                     functools.partial(JaxFair, preemption=True, quantum=8,
                                       preempt_after=1))}


def _serve(side, w, mesh, reqs, dp=2, kvd="float32", slots=SLOTS,
           arrivals=True, policy="fcfs", prefix_cache=True, overlap=False,
           **kw):
    """Serve ``reqs`` ((rid, prompt, max_new, priority, client)) on one
    side's paged engine -> (engine, requests)."""
    jcfg, jp, cfg, params = w
    if side == "jax":
        eng = JaxEngine.build_paged(
            jcfg, JaxPlan(tp=1, kv_cache_dtype=kvd), mesh, slots, SB,
            jp, page_size=PSZ, prefill_chunk=CHUNK, dp=dp,
            prefix_cache=prefix_cache, overlap=overlap,
            scheduler=POLICIES[policy][1], **kw)
        Req = JaxRequest
    else:
        eng = ServingEngine.build_paged(
            cfg, ShardingPlan(kv_cache_dtype=kvd), slots, SB, params,
            page_size=PSZ, prefill_chunk=CHUNK, dp=dp,
            prefix_cache=prefix_cache, overlap=overlap,
            scheduler=POLICIES[policy][0], device="cpu", **kw)
        Req = Request
    rs = [Req(rid=i, prompt=p.copy(), max_new_tokens=m, priority=pr,
              client_id=c) for i, p, m, pr, c in reqs]
    if arrivals:
        _arrivals(eng, rs)
    else:
        for r in rs:
            eng.submit(r)
        eng.run()
    assert all(r.done for r in rs)
    return eng, rs


def _summary(eng, rs):
    s = eng.stats
    return ([r.out_tokens for r in rs], [r.replica for r in rs], s.ticks,
            s.preemptions, s.plan_invalidations, s.prefill_tokens_skipped,
            s.cow_copies, [(x.routed, x.prefills, x.decoded_tokens,
                            x.preemptions, x.prefix_hits, x.prefix_lookups)
                           for x in s.replicas])


def _leak_free(eng):
    """After ``drain()``: every replica's pages free or held by its prefix
    cache, and its slabs free."""
    assert eng.drain() == 0
    for r in range(eng.R):
        a, c = eng.allocators[r], eng.prefix_caches[r]
        cached = c.n_cached_pages if c is not None else 0
        assert a.n_free + cached == a.n_pages - a.n_reserved, r
        if eng.slab_allocators:
            assert eng.slab_allocators[r].n_free == eng.n_slabs - 1, r


@pytest.fixture(scope="module")
def oracle(weights, mesh1):
    """The dp = 1 oracle's greedy tokens (the port's serial FCFS engine
    without the prefix cache)."""
    w = weights["tinyllama-42m"]
    reqs = _mixed(w[2].vocab_size)
    eng, rs = _serve("port", w, mesh1, reqs, dp=1, prefix_cache=False)
    return reqs, [r.out_tokens for r in rs]


@pytest.mark.parametrize("policy", list(POLICIES))
def test_dp2_matches_jax_and_dp1(weights, mesh1, oracle, policy):
    """dp = 2 with the prefix cache and requests arriving while others
    run, under FCFS (2 slots a replica), priority and fair preemption (1
    slot a replica): greedy tokens, routing,
    ticks, preemptions, skipped prefill tokens, COW copies and every
    replica's counters equal JAX's dp = 2 engine; tokens equal the dp = 1
    oracle's; both replicas serve; every replica leak-free after
    ``drain()``."""
    reqs, want = oracle
    w = weights["tinyllama-42m"]
    # one slot a replica under the preemptive policies: urgent arrivals
    # find their replica full
    kw = dict(policy=policy, slots=SLOTS if policy == "fcfs" else 1)
    eng, rs = _serve("port", w, mesh1, reqs, **kw)
    got = _summary(eng, rs)
    assert got == _summary(*_serve("jax", w, mesh1, reqs, **kw))
    assert got[0] == want
    assert all(x.routed > 0 and x.decoded_tokens > 0
               for x in eng.stats.replicas)
    assert policy == "fcfs" or got[3] > 0
    _leak_free(eng)


def test_dp2_overlap_pools_match_jax_layout(weights, mesh1, oracle):
    """The pipelined tick at dp = 2 against JAX's (ticks and plan-ahead
    ticks too), then the pools: every replica's pages but its scratch page
    (idle rows' garbage) equal JAX's pools, (reps, R, n_pages, G, psz, D),
    through the port's unfold view."""
    reqs, want = oracle
    w = weights["tinyllama-42m"]
    mine = _serve("port", w, mesh1, reqs, overlap=True)
    theirs = _serve("jax", w, mesh1, reqs, overlap=True)
    assert _summary(*mine) == _summary(*theirs)
    assert mine[0].stats.plan_ahead_ticks == theirs[0].stats.plan_ahead_ticks
    assert [r.out_tokens for r in mine[1]] == want
    un = kvcache.unfold_replica_pools(mine[0].cache, 2)
    n = 0
    for gp, gj in zip(un, theirs[0].cache):
        for ep, ej in zip(gp, gj):
            for name in ("kp", "vp"):
                a = ep["kv"][name].numpy()[:, :, 1:]
                b = np.asarray(ej["kv"][name])[:, :, 1:]
                assert a.shape == b.shape
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-3)
                n += int((b != 0).any())
    assert n


def test_dp2_int8_pools(weights, mesh1, oracle):
    """int8 pools at dp = 2 (scale rows reset per replica, folded ids):
    tokens, routing and counters equal JAX's; leak-free replicas."""
    reqs, _ = oracle
    w = weights["tinyllama-42m"]
    eng, rs = _serve("port", w, mesh1, reqs, kvd="int8", arrivals=False)
    assert _summary(eng, rs) == _summary(*_serve("jax", w, mesh1, reqs,
                                                 kvd="int8", arrivals=False))
    assert all(x.decoded_tokens > 0 for x in eng.stats.replicas)
    _leak_free(eng)


def test_dp2_speculation(weights, mesh1):
    """speculative=3 at dp = 2 (each replica's own draft source over its
    radix cache), weights x5 and repetitive prompts behind two system
    prompts, so drafts are accepted and rejected: tokens, counters and the
    speculation counters equal JAX's; tokens equal the dp = 1 one-token
    oracle's."""
    jcfg, jp, cfg, params = weights["tinyllama-42m"]
    w = (jcfg, jax.tree_util.tree_map(lambda a: a / 5, jp), cfg,
         model_tree_map(lambda t: t / 5, params))
    rng = np.random.RandomState(11)
    heads = [rng.randint(2, cfg.vocab_size, 8) for _ in range(2)]
    reqs = []
    for i in range(6):
        motif = rng.randint(2, cfg.vocab_size, 3 + i % 2)
        body = np.tile(motif, 4)[:8 + 2 * (i % 3)]
        reqs.append((i, np.concatenate([heads[i % 2], body]).astype(
            np.int32), 12, 0, 0))
    want = [r.out_tokens for r in _serve("port", w, mesh1, reqs, dp=1,
                                         prefix_cache=False,
                                         arrivals=False)[1]]
    eng, rs = _serve("port", w, mesh1, reqs, speculative=3, arrivals=False)
    jeng, jrs = _serve("jax", w, mesh1, reqs, speculative=3, arrivals=False)
    assert _summary(eng, rs) == _summary(jeng, jrs)
    s, js = eng.stats, jeng.stats
    assert (s.spec_steps, s.spec_drafted, s.spec_accepted, s.spec_denied) == \
        (js.spec_steps, js.spec_drafted, js.spec_accepted, js.spec_denied)
    assert s.spec_accepted > 0 and [r.out_tokens for r in rs] == want
    assert all(x.decoded_tokens > 0 for x in s.replicas)
    _leak_free(eng)


def test_dp2_mamba2_slabs(weights, mesh1):
    """mamba2 at dp = 2: each replica's slabs (folded ids), a forced
    ``preempt(b)`` on replica 1 stashing and restoring its slab: tokens,
    restores and per-replica counters equal JAX's and the uninterrupted
    run's; slabs free after ``drain()``."""
    w = weights["mamba2-370m"]
    rng = np.random.RandomState(3)
    reqs = [(i, rng.randint(2, w[2].vocab_size, L).astype(np.int32), m, 0, 0)
            for i, (L, m) in enumerate(((13, 6), (9, 5), (11, 6), (7, 4)))]

    def run(side, force):
        if side == "jax":
            eng = JaxEngine.build_paged(
                w[0], JaxPlan(tp=1, kv_cache_dtype="float32"), mesh1, 1, 32,
                w[1], page_size=8, prefill_chunk=8, dp=2, overlap=False)
            rs = [JaxRequest(rid=i, prompt=p.copy(), max_new_tokens=m)
                  for i, p, m, _, _ in reqs]
        else:
            eng = ServingEngine.build_paged(
                w[2], ShardingPlan(kv_cache_dtype="float32"), 1, 32, w[3],
                page_size=8, prefill_chunk=8, dp=2, overlap=False,
                device="cpu")
            rs = [Request(rid=i, prompt=p.copy(), max_new_tokens=m)
                  for i, p, m, _, _ in reqs]
        # a pure-SSM arch holds no pages, so the router's page load ties at
        # 0 and places every request on replica 0: alternate them instead
        eng.router.route = lambda req: req.rid % 2
        for r in rs:
            eng.submit(r)
        tick = 0
        while eng.has_pending() or any(a is not None for a in eng.admissions):
            if force and tick == 3 and eng.admissions[1] is not None:
                eng.preempt(1)                  # replica 1's slot
            eng.tick()
            tick += 1
        eng.run()
        assert all(r.done for r in rs)
        return eng, (_summary(eng, rs), eng.stats.slab_restores)

    ref = run("port", False)[1]
    eng, got = run("port", True)
    assert got == run("jax", True)[1]
    assert got[0][0] == ref[0][0] and got[1] == 1 and got[0][3] == 1
    _leak_free(eng)


def test_dp_checks_and_accessors(weights):
    """The dp checks' messages (JAX's), and the one-replica accessors
    refusing dp > 1."""
    _, _, cfg, params = weights["tinyllama-42m"]
    plan = ShardingPlan(kv_cache_dtype="float32")
    with pytest.raises(ValueError, match="dp>1 serving requires the paged"):
        ServingEngine(cfg, plan, 2, SB, params, dp=2, device="cpu")
    with pytest.raises(ValueError, match="dp must be >= 1"):
        ServingEngine.build_paged(cfg, plan, 2, SB, params, page_size=PSZ,
                                  dp=0, device="cpu")
    inst = FCFSScheduler(seq_budget=SB, allocator=PageAllocator(20),
                         page_size=PSZ)
    with pytest.raises(ValueError, match="scheduler factory, not an instance"):
        ServingEngine.build_paged(cfg, plan, 2, SB, params, page_size=PSZ,
                                  dp=2, scheduler=inst, device="cpu")
    eng = ServingEngine.build_paged(cfg, plan, 2, SB, params, page_size=PSZ,
                                    prefill_chunk=CHUNK, dp=2,
                                    prefix_cache=True, device="cpu")
    assert (eng.R, eng.Bp, eng.B) == (2, 2, 4)
    for what in ("sched", "allocator", "prefix_cache", "slab_allocator",
                 "cross_cache"):
        with pytest.raises(AssertionError, match="dp>1"):
            getattr(eng, what)
    assert [eng._rep(b) for b in range(4)] == [0, 0, 1, 1]
    assert eng._gslot(1, 1) == 3
    one = ServingEngine.build_paged(cfg, plan, 2, SB, params, page_size=PSZ,
                                    prefill_chunk=CHUNK, device="cpu")
    assert one.allocator is one.allocators[0] and one.sched is one.scheds[0]


@pytest.fixture(scope="module")
def seamless():
    """Reduced seamless-m4t-large-v2 (one encoder layer, 16 frames) in
    fp32 from JAX's init, every weight x10 but the layernorms' (their
    scale starts at 1), carried into the port through the bridge."""
    arch = "seamless-m4t-large-v2"
    small = dict(dtype="float32", n_enc_layers=1, enc_seq_len=16)
    jcfg = jax_reduced(jax_get_config(arch), **small)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: a if any(getattr(k, "key", "").startswith(
            ("ln", "final_norm")) for k in path) else a * 10,
        jmodel.init_params(jcfg, JaxPlan(tp=1, kv_cache_dtype="float32")))
    cfg = reduced(get_config(arch), **small)
    return jcfg, jp, cfg, params_from_jax(
        cfg, ShardingPlan(kv_cache_dtype="float32"),
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def test_dp2_encdec_cross_pages(seamless, mesh1):
    """Reduced seamless at dp = 2 with int8 pools over three frame tensors,
    the port against JAX's dp = 2 engine on the same frames and prompts:
    greedy tokens, each request's replica, ticks, encodes, cross hits and
    every replica's counters equal (each encode writes its replica's cross
    pages, frames affinity sends a tensor's later requests where it was
    encoded); the tokens equal the port's at dp = 1; replicas leak-free
    (cross-KV entries cached, pages otherwise free)."""
    jcfg, jp, cfg, params = seamless
    rng = np.random.RandomState(1)
    frames = [rng.randn(cfg.enc_seq_len, cfg.d_model).astype(np.float32)
              for _ in range(3)]
    prompts = [rng.randint(2, cfg.vocab_size, int(L)).astype(np.int32)
               for L in rng.randint(4, 12, 6)]

    def serve(side, dp):
        if side == "jax":
            eng = JaxEngine.build_paged(
                jcfg, JaxPlan(tp=1, kv_cache_dtype="int8"), mesh1, 2, 32, jp,
                page_size=8, prefill_chunk=16, dp=dp, overlap=False)
            Req = JaxRequest
        else:
            eng = ServingEngine.build_paged(
                cfg, ShardingPlan(kv_cache_dtype="int8"), 2, 32, params,
                page_size=8, prefill_chunk=16, dp=dp, overlap=False,
                device="cpu")
            Req = Request
        rs = [Req(rid=i, prompt=p, frames=frames[i % 3], max_new_tokens=5)
              for i, p in enumerate(prompts)]
        for r in rs:
            eng.submit(r)
        eng.run()
        assert all(r.done for r in rs)
        st = eng.stats
        return eng, ([r.out_tokens for r in rs], [r.replica for r in rs],
                     st.ticks, st.cross_encodes, st.cross_hits,
                     st.cross_lookups,
                     [(x.routed, x.prefills, x.decoded_tokens, x.cross_hits,
                       x.cross_lookups) for x in st.replicas])

    eng, got = serve("port", 2)
    assert got == serve("jax", 2)[1]
    toks, reps = got[0], got[1]
    assert toks == serve("port", 1)[1][0]
    assert len({t for r in toks for t in r}) > 5            # not degenerate
    assert eng.stats.cross_encodes == 3 and set(reps) == {0, 1}
    assert all(reps[i] == reps[i + 3] for i in range(3))
    assert eng.router.affinity_routed == 3
    assert eng.drain() == 0
    for r in range(2):
        a = eng.allocators[r]
        assert a.n_free + eng.cross_caches[r].n_cached_pages == a.n_pages - 1
