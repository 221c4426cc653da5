"""Elastic replicas in the port against the JAX package on the CPU:
``scale_to`` (a drain migrates in-flight pages through the page-transfer
step, or preempts and requeues; the pools re-scatter and the step set is
made again at the new R) and ``kill_replica`` (the orphans re-admitted
through ``plan_recovery``), driven through the engine's
``membership_hook`` by ``faultlib.FaultPlan`` on both sides.  Each case
runs JAX's engine and the port's under the same schedule: greedy or
sampled tokens, each request's replica, the membership counters and the
``RecoveryReport`` equal, tokens equal the dp = 1 oracle, and every
replica leak-free after ``drain()`` (int8 pools: free pages' scale rows
zero or awaiting their reset).  Also the scheduler's migration hooks under
the three policies, ``reshard_replica_pools`` and ``plan_recovery``
against JAX's, the fallback for SSM and enc-dec archs, the refusals
message for message, the launcher's ``--scale-events``, and the dp = 2
rows of ``scripts/check_spec_identity.py``'s twin (sampled, speculation
off and on).  Reduced tinyllama-42m (page 8, chunk 16, 2-4 slots a
replica, prefix cache on), mamba2-370m and seamless-m4t-large-v2 in fp32,
JAX's init through the bridge."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from faultlib import FaultPlan, inject_transfer_fault

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import model as jmodel
from repro.core.kvcache import PageAllocator as JaxAllocator
from repro.core.partition import ShardingPlan as JaxPlan
from repro.launch import serve as jserve
from repro.runtime import elastic as jelastic
from repro.runtime import ft as jft
from repro.serving import Request as JaxRequest
from repro.serving import SamplerConfig as JaxSampler
from repro.serving import ServingEngine as JaxEngine
from repro.serving.policies import FairScheduler as JaxFair
from repro.serving.policies import PriorityScheduler as JaxPriority
from repro.serving.prefix_cache import RadixPrefixCache as JaxRadix
from repro.serving.scheduler import FCFSScheduler as JaxFCFS
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.core import kvcache, steps
from repro_torch.core.kvcache import PageAllocator
from repro_torch.core.model import tree_map as model_tree_map
from repro_torch.core.partition import ShardingPlan
from repro_torch.launch import serve
from repro_torch.runtime import elastic, ft
from repro_torch.serving import (FairScheduler, HostSpillStore,
                                 PriorityScheduler, RadixPrefixCache, Request,
                                 SamplerConfig, ServingEngine)
from repro_torch.serving.scheduler import FCFSScheduler

SB, PSZ, CHUNK = 64, 8, 16
KVDS = ("float32", "int8")
POLICIES = {
    "fcfs": (None, None),
    "priority": (functools.partial(PriorityScheduler, preemption=True),
                 functools.partial(JaxPriority, preemption=True)),
    "fair": (FairScheduler, JaxFair),
}
SAMPLED = dict(temperature=0.8, top_k=40)


@pytest.fixture(scope="module")
def weights():
    """Reduced tinyllama in fp32 from JAX's init x25 (greedy decoding does
    not collapse), and the port's copy, for float and int8 pools."""
    jcfg = jax_reduced(jax_get_config("tinyllama-42m"), dtype="float32")
    cfg = reduced(get_config("tinyllama-42m"), dtype="float32")
    jp = jax.tree_util.tree_map(
        lambda a: a * 25.0,
        jmodel.init_params(jcfg, JaxPlan(tp=1, kv_cache_dtype="float32")))
    host = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, jp, cfg, {kvd: params_from_jax(
        cfg, ShardingPlan(kv_cache_dtype=kvd), host, device="cpu")
        for kvd in KVDS}


def _requests(Req, vocab, n=6, seed=0, max_new=(2, 8)):
    """JAX's elastic mix: prompts of 4-19 tokens, 2-7 new, three priority
    classes and three clients."""
    rng = np.random.RandomState(seed)
    return [Req(rid=rid,
                prompt=rng.randint(2, vocab, int(rng.randint(4, 20)))
                .astype(np.int32),
                max_new_tokens=int(rng.randint(*max_new)),
                priority=int(rng.randint(0, 3)),
                client_id=int(rng.randint(0, 3)))
            for rid in range(n)]


def _build(side, w, mesh1, kvd="float32", dp=2, slots=2, policy="fcfs",
           sampler=None, **kw):
    """One side's paged engine (prefix cache on) -> (engine, Request)."""
    jcfg, jp, cfg, params = w
    if side == "jax":
        return JaxEngine.build_paged(
            jcfg, JaxPlan(tp=1, kv_cache_dtype=kvd), mesh1, slots, SB, jp,
            page_size=PSZ, prefill_chunk=CHUNK, prefix_cache=True, dp=dp,
            scheduler=POLICIES[policy][1],
            sampler=JaxSampler(**sampler) if sampler else None, **kw), \
            JaxRequest
    return ServingEngine.build_paged(
        cfg, ShardingPlan(kv_cache_dtype=kvd), slots, SB, params[kvd],
        page_size=PSZ, prefill_chunk=CHUNK, prefix_cache=True, dp=dp,
        scheduler=POLICIES[policy][0],
        sampler=SamplerConfig(**sampler) if sampler else None,
        device="cpu", **kw), Request


def _leak_free(eng):
    """JAX's ``_assert_leak_free`` after ``drain()``: every page free or
    cached, every slab free; int8 pools: every free page's scale rows zero
    or awaiting their reset (``tests/test_dp_serving.py``'s hygiene)."""
    eng.drain()
    for r in range(eng.R):
        a = eng.allocators[r]
        cached = 0
        if eng.prefix_caches[r] is not None:
            cached += eng.prefix_caches[r].n_cached_pages
        if eng.cross_caches:
            cached += eng.cross_caches[r].n_cached_pages
        assert a.n_free + cached == a.n_pages - a.n_reserved, r
        if eng.slab_allocators:
            assert eng.slab_allocators[r].n_free == eng.n_slabs - 1, r
    if not eng.quant_pools:
        return
    port = isinstance(eng, ServingEngine)
    # JAX's pools are (reps, R, n_pages, ...) already; the port's unfold
    un = kvcache.unfold_replica_pools(eng.cache, eng.R) if port else eng.cache
    for r in range(eng.R):
        a = eng.allocators[r]
        clean = sorted(a._free_set - a._scale_dirty)
        for group in un:
            for entry in group:
                for kind in ("kv", "cross"):
                    for name, pool in entry.get(kind, {}).items():
                        if name.endswith("sp") and clean:
                            assert not np.asarray(pool[:, r, clean]).any(), \
                                (r, name)


def _summary(eng, rs):
    s = eng.stats
    return ({r.rid: r.out_tokens for r in rs}, [r.replica for r in rs],
            s.ticks, s.preemptions, s.scale_events, s.crashes, s.migrations,
            s.migrated_pages, s.readmitted, s.pages_transferred, eng.R,
            [(x.routed, x.prefills, x.decoded_tokens, x.preemptions,
              x.pages_transferred_out, x.pages_transferred_in)
             for x in s.replicas])


def _serve(side, w, mesh1, events=(), drive=None, seed=0, n=6, **kw):
    """Serve JAX's mix on one side under the membership ``events`` (a
    ``FaultPlan``); ``drive(eng)`` may tick and act before the run.  ->
    (engine, summary, what ``drive`` returned, the events applied); the
    engine is leak-free after ``drain()``."""
    eng, Req = _build(side, w, mesh1, **kw)
    plan = FaultPlan(list(events)).install(eng)
    rs = _requests(Req, w[2].vocab_size, n=n, seed=seed)
    for r in rs:
        eng.submit(r)
    got = drive(eng) if drive else None
    eng.run(max_ticks=5000)
    assert all(r.done for r in rs)
    out = _summary(eng, rs)
    _leak_free(eng)
    return eng, out, got, plan.applied


def _both(w, mesh1, **kw):
    """``_serve`` on the port and on JAX: summaries, drive results and
    applied events equal -> the port's (engine, summary, drive result)."""
    eng, got, drove, applied = _serve("port", w, mesh1, **kw)
    _, want, jdrove, japplied = _serve("jax", w, mesh1, **kw)
    assert got == want
    assert applied == japplied
    return eng, got, (drove, jdrove), applied


_ORACLES = {}


def _oracle(w, mesh1, kvd="float32", seed=0, sampler=None, n=6):
    """The dp = 1 serial oracle's tokens (the port's), one per request set."""
    key = (kvd, seed, bool(sampler), n)
    if key not in _ORACLES:
        _ORACLES[key] = _serve("port", w, mesh1, kvd=kvd, dp=1, seed=seed,
                               n=n, sampler=sampler, overlap=False,
                               rng_seed=7)[1][0]
    return _ORACLES[key]


def _ticks_then(n, action):
    def drive(eng):
        for _ in range(n):
            eng.tick()
        return action(eng)
    return drive


# ------------------------------------------------------------ host pieces
@pytest.mark.parametrize("policy", list(POLICIES))
def test_migration_hooks_match_jax(policy):
    """``plan_migration`` (the full horizon budgeted, draft headroom with
    speculation, None under pool pressure), ``on_migrated`` (the resident
    references handed over, the tail dropped) and ``take_queued`` (the
    queue emptied, the backlog back to 0) on each policy: the same pages,
    refcounts and queues as JAX's."""
    def script(side):
        Alloc, Radix, Req = {"jax": (JaxAllocator, JaxRadix, JaxRequest),
                             "port": (PageAllocator, RadixPrefixCache,
                                      Request)}[side]
        make = {"fcfs": {"jax": JaxFCFS, "port": FCFSScheduler},
                "priority": {"jax": JaxPriority, "port": PriorityScheduler},
                "fair": {"jax": JaxFair, "port": FairScheduler}}[policy][side]
        log = []
        src_a, dst_a = Alloc(20), Alloc(12)
        src = make(seq_budget=64, allocator=src_a, page_size=4,
                   prefix_cache=Radix(src_a, 4))
        dst = make(seq_budget=64, allocator=dst_a, page_size=4,
                   prefix_cache=Radix(dst_a, 4), spec_tokens=3)
        rng = np.random.RandomState(3)
        reqs = [Req(rid=i, prompt=rng.randint(2, 500, 6 + 3 * i).astype(
            np.int32), max_new_tokens=5 + i, priority=i % 2, client_id=i % 2)
            for i in range(4)]
        for r in reqs:
            src.submit(r)
        adms = src.plan([0, 1])
        adms[0].req.out_tokens = [7, 8]        # two tokens emitted
        for adm in adms:
            n = 6 if adm is adms[0] else 4     # resident tokens
            d = dst.plan_migration(adm.slot, adm.req, n)
            log.append(None if d is None else (list(d.pages), d.cached_len,
                                               d.spec, d.seq))
            if d is not None:
                k = -(-n // 4)
                src.on_migrated(adm, k, dst_a, d.pages[:k])
        log.append((src_a.n_free, dst_a.n_free,
                    [dst_a.refcount(p) for p in range(12)],
                    src_a.pages_transferred_out, dst_a.pages_transferred_in))
        log.append(dst.plan_migration(0, reqs[3], 10))       # no room left
        log.append((src.backlog_pages, [r.rid for r in src.take_queued()],
                    src.backlog_pages, src.has_pending(),
                    src.pending_requests()))
        return log

    got = script("port")
    assert got == script("jax")
    assert got[0] is not None and got[1] is not None and got[3] is None
    assert len(got[4][1]) == 2 and got[4][2] == 0 and not got[4][3]


def test_plan_recovery_matches_jax():
    """Active admissions by admission sequence, then the queue in order;
    the report's rids and orphan count."""
    class Adm:
        def __init__(self, seq, rid):
            self.seq, self.req = seq, JaxRequest(rid=rid, prompt=np.ones(
                2, np.int32))

    active = [Adm(5, 10), Adm(2, 11), Adm(9, 12)]
    queued = [JaxRequest(rid=r, prompt=np.ones(2, np.int32)) for r in (3, 1)]
    want, wrep = jft.plan_recovery(1, active, queued)
    got, rep = ft.plan_recovery(1, active, queued)
    assert [r.rid for r in got] == [r.rid for r in want] == [11, 10, 12, 3, 1]
    assert (rep.replica, rep.active_rids, rep.queued_rids, rep.n_orphans) == \
        (wrep.replica, wrep.active_rids, wrep.queued_rids, wrep.n_orphans)


@pytest.mark.parametrize("arch,kvd", [("tinyllama-42m", "int8"),
                                      ("mamba2-370m", "int8")])
def test_reshard_replica_pools_matches_jax(arch, kvd):
    """Every leaf (page pools, int8 scale rows, slabs and slab scales)
    re-scattered as JAX's ``reshard_replica_pools`` does on the unfolded
    layout: survivors to their new positions (3 -> 2, order changed;
    2 -> 3, one joins zeroed); the result is a new folded pool and the old
    one is left as it was; bad ``keep`` lists refused."""
    cfg = reduced(get_config(arch), dtype="float32")
    plan = ShardingPlan(kv_cache_dtype=kvd, ssm_cache_dtype=kvd)
    cache = steps.zero_paged_cache_for(cfg, plan, 5, 4, "cpu", n_slabs=3,
                                       n_replicas=3)
    gen = torch.Generator().manual_seed(0)
    cache = model_tree_map(lambda t: torch.randint(
        -100, 100, t.shape, generator=gen).to(t.dtype), cache)
    before = model_tree_map(torch.clone, cache)
    for keep, new_r, old_r in (([2, 0], 2, 3), ([1, 0], 3, 2)):
        src = cache if old_r == 3 else kvcache.fold_replica_pools(
            model_tree_map(lambda t: t[:, :2].contiguous(),
                           kvcache.unfold_replica_pools(
                cache, 3)))
        got = elastic.reshard_replica_pools(src, keep, new_r, old_r)
        un = kvcache.unfold_replica_pools(src, old_r)
        jwant = jelastic.reshard_replica_pools(
            jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), un),
            keep, new_r)
        got_un = kvcache.unfold_replica_pools(got, new_r)
        n = 0
        for g, j in zip(jax.tree_util.tree_leaves(
                model_tree_map(lambda t: t.numpy(), got_un)),
                jax.tree_util.tree_leaves(jwant), strict=True):
            np.testing.assert_array_equal(g, np.asarray(j))
            n += 1
        assert n == len(jax.tree_util.tree_leaves(jwant)) > 0
    for a, b in zip(jax.tree_util.tree_leaves(model_tree_map(
            lambda t: t.numpy(), cache)), jax.tree_util.tree_leaves(
            model_tree_map(lambda t: t.numpy(), before))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="incompatible"):
        elastic.reshard_replica_pools(cache, [], 2, 3)
    with pytest.raises(ValueError, match="outside"):
        elastic.reshard_replica_pools(cache, [3], 2, 3)


# ------------------------------------------------- membership on the engine
def test_scale_down_migrates_pages_int8(weights, mesh1):
    """(a) With free slots on the survivor, the drain moves resident int8
    pages (scale rows too) through the transfer step instead of
    preempting: the same migrations, pages and tokens as JAX's, the dp = 1
    oracle's tokens."""
    eng, got, _, _ = _both(weights, mesh1, kvd="int8", slots=4, seed=1,
                        drive=_ticks_then(3, lambda e: e.scale_to(1)))
    assert got[0] == _oracle(weights, mesh1, "int8", 1)
    assert eng.stats.migrations > 0 and eng.stats.migrated_pages > 0
    assert eng.R == 1 and "transfer" not in eng.steps


def test_scale_down_mid_overlap(weights, mesh1):
    """(b) ``scale_to`` while a dispatched tick is in flight collects it
    first: nothing is in flight after it and no request is lost."""
    def drive(eng):
        for _ in range(50):
            eng.tick()
            if eng._inflight is not None:
                break
        assert eng._inflight is not None
        eng.scale_to(1)
        return eng.R, eng._inflight

    _, got, drove, _ = _both(weights, mesh1, overlap=True, drive=drive)
    assert drove[0] == (1, None) and got[4] == 1
    assert got[0] == _oracle(weights, mesh1)


def test_migrated_slot_survives_preemption(weights, mesh1):
    """(c) A slot that just migrated (int8 pools) preempts and resumes on
    its new replica like any native admission."""
    def act(eng):
        eng.scale_to(1)
        assert eng.stats.migrations > 0
        b = next(b for b, a in enumerate(eng.admissions) if a is not None)
        eng.preempt(b)
        return b

    _, got, _, _ = _both(weights, mesh1, kvd="int8", slots=4, seed=1,
                         drive=_ticks_then(3, act))
    assert got[3] >= 1 and got[0] == _oracle(weights, mesh1, "int8", 1)


def test_transfer_fault_rolls_back_and_preempts(weights, mesh1):
    """(d) A transfer that raises after the destination claim (the
    transfer function patched as ``faultlib.inject_transfer_fault`` patches
    JAX's) rolls the claim back: the survivor's free pages and the source
    pages' refcounts as before, the source slot still serving; the drain
    then falls back to preemption, and every request still completes."""
    def act(eng):
        b = next(b for b, a in enumerate(eng.admissions)
                 if a is not None and b // eng.Bp == 1)
        free = eng.allocators[0].n_free
        rc = [eng.allocators[1].refcount(p) for p in eng.admissions[b].pages]
        state = inject_transfer_fault(eng, fail_calls=range(1, 100))
        assert eng._migrate_slot(b, [0]) is False
        assert state["faults"] == 1
        assert eng.allocators[0].n_free == free
        assert eng.admissions[b] is not None
        assert [eng.allocators[1].refcount(p)
                for p in eng.admissions[b].pages] == rc
        eng.scale_to(1)
        return state["faults"], eng.stats.migrations, eng.stats.preemptions

    _, got, drove, _ = _both(weights, mesh1, seed=3, n=2, overlap=False,
                          drive=_ticks_then(3, act))
    assert drove[0] == drove[1] and drove[0][0] > 1 and drove[0][1] == 0
    assert got[0] == _oracle(weights, mesh1, seed=3, n=2)


@pytest.mark.parametrize("sampler", [None, SAMPLED], ids=["greedy", "sampled"])
def test_kill_replica_readmits_exact_continuation(weights, mesh1, sampler):
    """(e) ``kill_replica(1)`` once a replica-1 request has emitted: the
    same ``RecoveryReport`` as JAX's, the victim's emitted tokens kept,
    tokens (greedy, or sampled at temperature 0.8, top-k 40 from each
    request's own stream) equal JAX's and the dp = 1 oracle's."""
    def drive(eng):
        for _ in range(200):
            eng.tick()
            victim = next((a.req for a in eng.admissions if a is not None
                           and a.req.replica == 1 and a.req.out_tokens),
                          None)
            if victim is not None:
                break
        emitted = list(victim.out_tokens)
        rep = eng.kill_replica(1)
        assert victim.rid in rep.active_rids and eng.R == 1
        eng.run(max_ticks=5000)
        assert victim.out_tokens[:len(emitted)] == emitted
        return (rep.replica, rep.active_rids, rep.queued_rids, rep.n_orphans)

    eng, got, drove, _ = _both(weights, mesh1, sampler=sampler, rng_seed=7,
                            seed=2 if sampler else 0, drive=drive)
    assert drove[0] == drove[1]
    assert got[5] == 1 and got[8] >= len(drove[0][1])
    assert got[0] == _oracle(weights, mesh1, seed=2 if sampler else 0,
                             sampler=sampler)


def test_admission_during_drain_avoids_draining_replica(weights, mesh1):
    """(f) A replica marked draining is never chosen, even with the least
    page load: a late request and a decode placement go to replica 0."""
    def run(side):
        eng, Req = _build(side, weights, mesh1)
        busy = Req(rid=0, prompt=np.arange(2, 18, dtype=np.int32),
                   max_new_tokens=8)
        eng.submit(busy)
        eng.tick()
        eng.router.mark_draining(1)
        late = Req(rid=1, prompt=np.arange(2, 8, dtype=np.int32),
                   max_new_tokens=2)
        eng.submit(late)
        placed = (busy.replica, late.replica,
                  eng.router.decode_placement([0, 1]))
        eng.run(max_ticks=5000)
        assert busy.done and late.done
        _leak_free(eng)
        return placed, busy.out_tokens, late.out_tokens

    got = run("port")
    assert got == run("jax") and got[0] == (0, 0, 0)


def _refusals(side, w, mesh1):
    """Every membership refusal's (type, message) on one side."""
    jcfg, jp, cfg, params = w
    out = []

    def catch(fn, *args):
        try:
            fn(*args)
        except (ValueError, AssertionError) as e:
            out.append((type(e).__name__, str(e)))
        else:
            out.append(None)

    eng, _ = _build(side, w, mesh1, dp=1)
    catch(eng.scale_to, 0)
    catch(eng.kill_replica, 0)                 # the last replica
    catch(eng.kill_replica, 1)                 # out of range
    catch(eng.scale_to, 1)                     # a no-op
    out.append(eng.stats.scale_events)
    dis, _ = _build(side, w, mesh1, slots=1, disagg=(1, 1))
    catch(dis.scale_to, 1)
    catch(dis.kill_replica, 0)
    if side == "jax":
        inst = JaxEngine.build_paged(
            jcfg, JaxPlan(tp=1, kv_cache_dtype="float32"), mesh1, 2, SB, jp,
            page_size=PSZ, prefill_chunk=CHUNK,
            scheduler=JaxFCFS(seq_budget=SB))
        contig = JaxEngine(jcfg, JaxPlan(tp=1, kv_cache_dtype="float32"),
                           mesh1, 2, SB, jp, None, None)
    else:
        inst = ServingEngine.build_paged(
            cfg, ShardingPlan(kv_cache_dtype="float32"), 2, SB,
            params["float32"], page_size=PSZ, prefill_chunk=CHUNK,
            scheduler=FCFSScheduler(seq_budget=SB), device="cpu")
        contig = ServingEngine(cfg, ShardingPlan(kv_cache_dtype="float32"), 2,
                               SB, params["float32"], device="cpu")
    catch(inst.scale_to, 2)
    catch(inst.kill_replica, 0)
    catch(contig.scale_to, 2)
    catch(contig.kill_replica, 0)
    return out


def test_refusals_are_jax_s(weights, mesh1):
    """(g) The validation errors, message for message: dp_new < 1, the
    last replica, a replica out of range, disaggregation, a scheduler
    instance, the contiguous engine; scaling to the current width is a
    no-op.  ``spill=`` takes a ``HostSpillStore``, which the engine keeps
    (``tests/test_torch_spill.py`` holds what it does against JAX)."""
    got = _refusals("port", weights, mesh1)
    assert got == _refusals("jax", weights, mesh1)
    assert got[3] is None and got[4] == 0
    assert all(x is not None for i, x in enumerate(got) if i not in (3, 4))
    store = HostSpillStore()
    eng, _ = _build("port", weights, mesh1, spill=store)
    assert eng.spill is store and store.pages_restored == 0


def _schedules(n=8):
    """(kv dtype, policy, dp0, request seed, events) of ``n`` seeded
    ``FaultPlan.random`` schedules over the three policies and both pool
    dtypes, their events within the runs' 8-11 ticks (a seed whose every
    schedule applies at least one event)."""
    out = []
    for i in range(n):
        rng = np.random.RandomState([21, i])
        kvd, policy = KVDS[i % 2], list(POLICIES)[i % 3]
        dp0 = int(rng.randint(2, 4))
        seed = int(rng.randint(3))
        out.append((kvd, policy, dp0, seed,
                    FaultPlan.random(rng, last_tick=8).events))
    return out


@pytest.mark.parametrize("kvd,policy,dp0,seed,events", _schedules())
def test_random_schedules_match_jax_and_dp1(weights, mesh1, kvd, policy, dp0,
                                            seed, events):
    """(h) A seeded ``FaultPlan.random`` schedule (scale-downs with
    migration, joins, crashes) under one policy and pool dtype: the port
    equals JAX's engine under the same schedule, and the dp = 1 oracle."""
    _, got, _, applied = _both(weights, mesh1, kvd=kvd, policy=policy,
                               dp=dp0, seed=seed, events=events)
    assert applied and got[0] == _oracle(weights, mesh1, kvd, seed)


def test_random_schedules_apply_both_kinds():
    """The seeded set scales and kills, and runs both dtypes and every
    policy (or it would degrade to plain dp serving)."""
    sch = _schedules()
    kinds = {k for *_, ev in sch for _, k, _ in ev}
    assert kinds == {"scale", "kill"}
    assert {s[0] for s in sch} == set(KVDS)
    assert {s[1] for s in sch} == set(POLICIES)


@pytest.fixture(scope="module")
def fallback_weights():
    """Reduced mamba2-370m at init scale, and reduced seamless (one
    encoder layer of 16 frames) x10 but its layernorms, from JAX's init."""
    out = {}
    for arch, small in (("mamba2-370m", dict(dtype="float32")),
                        ("seamless-m4t-large-v2",
                         dict(dtype="float32", n_enc_layers=1,
                              enc_seq_len=16))):
        jcfg = jax_reduced(jax_get_config(arch), **small)
        jp = jax.tree_util.tree_map_with_path(
            lambda path, a, s=(10 if jcfg.is_encdec else 1): a if any(
                getattr(k, "key", "").startswith(("ln", "final_norm"))
                for k in path) else a * s,
            jmodel.init_params(jcfg, JaxPlan(tp=1, kv_cache_dtype="float32")))
        cfg = reduced(get_config(arch), **small)
        out[arch] = (jcfg, jp, cfg, params_from_jax(
            cfg, ShardingPlan(kv_cache_dtype="float32"),
            jax.tree_util.tree_map(np.asarray, jp), device="cpu"))
    return out


@pytest.mark.parametrize("arch", ["mamba2-370m", "seamless-m4t-large-v2"])
def test_ssm_and_encdec_scale_down_preempts(fallback_weights, mesh1, arch):
    """(i) Slabs and cross-KV pages do not transfer: ``scale_to(1)``
    preempts replica 1's slots (mamba2's slab to the host stash; seamless
    re-encodes), with no migration and no transfer step: tokens and
    counters equal JAX's and the port's dp = 1 run.  Requests alternate
    replicas at submit on both sides (a pure-SSM arch holds no pages, so
    the router would send all to replica 0)."""
    jcfg, jp, cfg, params = fallback_weights[arch]
    rng = np.random.RandomState(4)
    frames = [rng.randn(cfg.enc_seq_len, cfg.d_model).astype(np.float32)
              for _ in range(2)] if cfg.is_encdec else None

    def run(side, dp):
        if side == "jax":
            eng = JaxEngine.build_paged(
                jcfg, JaxPlan(tp=1, kv_cache_dtype="float32"), mesh1, 2, SB,
                jp, page_size=PSZ, prefill_chunk=CHUNK, dp=dp, overlap=False)
            Req = JaxRequest
        else:
            eng = ServingEngine.build_paged(
                cfg, ShardingPlan(kv_cache_dtype="float32"), 2, SB, params,
                page_size=PSZ, prefill_chunk=CHUNK, dp=dp, overlap=False,
                device="cpu")
            Req = Request
        rs = _requests(Req, cfg.vocab_size, n=4, seed=4)
        for r in rs:
            r.priority = r.client_id = 0
            if frames:
                r.frames = frames[r.rid % 2]
        route = eng.router.route
        eng.router.route = lambda req: req.rid % dp
        for r in rs:
            eng.submit(r)
        eng.router.route = route
        FaultPlan([(3, "scale", 1)]).install(eng)
        eng.run(max_ticks=2000)
        assert all(r.done for r in rs)
        st = eng.stats
        out = ({r.rid: r.out_tokens for r in rs}, [r.replica for r in rs],
               st.ticks, st.scale_events, st.migrations, st.preemptions,
               st.readmitted, st.slab_restores, st.cross_encodes,
               "transfer" in eng.steps if side == "port" else None)
        _leak_free(eng)
        return out

    got = run("port", 2)
    want = run("jax", 2)
    assert got[:-1] == want[:-1]
    assert got[3] == 1 and got[4] == 0 and got[5] > 0 and got[-1] is False
    assert got[0] == run("port", 1)[0]


# ------------------------------------------------------------ the launcher
SCALE_ARGV = ["--arch", "tinyllama-42m", "--smoke", "--paged", "--dp", "2",
              "--scale-events", "3:1,6:2,9:kill:0"]


def test_launcher_scale_events_match_jax(capsys):
    """``--scale-events`` serves on the port's launcher with JAX's
    ``elastic:`` counts on the same command line; ``LATER`` keeps only
    ``--tp``; the flag's refusals are JAX's."""
    assert "--scale-events" not in serve.LATER and list(serve.LATER) == ["--tp"]

    def elastic_line(main, argv):
        assert main(argv) in (0, None)
        out = capsys.readouterr().out
        return next(ln for ln in out.splitlines() if ln.startswith("elastic:"))

    got = elastic_line(serve.main, SCALE_ARGV + ["--device", "cpu"])
    assert got == elastic_line(jserve.main, SCALE_ARGV)
    assert "scale_events=2 crashes=1" in got and got.endswith("dp_final=1")
    for argv, msg in ((["--scale-events", "3:1"], "requires the paged engine"),
                      (["--dp", "2", "--disagg", "1:1", "--scale-events",
                        "3:1"], "cannot combine with --disagg"),
                      (["--paged", "--scale-events", "3:x"], "T:kill:R")):
        with pytest.raises(SystemExit):
            serve.parse_args(["--arch", "tinyllama-42m", *argv])
        assert msg in capsys.readouterr().err


# ------------------------------------------ the spec identity twin, dp = 2
@pytest.mark.parametrize("k", [0, 3], ids=["spec0", "spec3"])
def test_spec_identity_sampled_dp2(weights, mesh1, k):
    """``scripts/check_spec_identity.py``'s dp = 2 rows: reduced tinyllama
    x5, temperature 0.7, top-k 40, prefix cache on, motif prompts behind two
    system prompts (prefix affinity spreads them over both replicas),
    speculation off and at k = 3: the port's dp = 2 tokens
    equal JAX's dp = 2 engine's and the port's dp = 1 one-token serial
    oracle's; drafts are accepted at k = 3."""
    jcfg, jp, cfg, params = weights
    w = (jcfg, jax.tree_util.tree_map(lambda a: a / 5, jp), cfg,
         {kvd: model_tree_map(lambda t: t / 5, p)
          for kvd, p in params.items()})
    # a request set on which a sampled draft is accepted at x5 (few are:
    # at temperature 0.7 the draws leave the motifs)
    rng = np.random.RandomState(1)
    heads = [rng.randint(2, cfg.vocab_size, 12) for _ in range(2)]
    prompts = [np.concatenate([heads[i % 2], np.tile(rng.randint(
        2, cfg.vocab_size, 3 + i % 3), 4)[:8 + 3 * (i % 4)]]).astype(np.int32)
        for i in range(6)]
    samp = dict(temperature=0.7, top_k=40)

    def run(side, dp, spec, overlap=True):
        eng, Req = _build(side, w, mesh1, dp=dp, sampler=samp, rng_seed=0,
                          speculative=spec, overlap=overlap)
        rs = [Req(rid=i, prompt=p.copy(), max_new_tokens=12)
              for i, p in enumerate(prompts)]
        for r in rs:
            eng.submit(r)
        eng.run(max_ticks=5000)
        assert all(r.done for r in rs)
        return eng, [r.out_tokens for r in rs], [r.replica for r in rs]

    eng, toks, reps = run("port", 2, k)
    jeng, jtoks, jreps = run("jax", 2, k)
    assert (toks, reps) == (jtoks, jreps) and set(reps) == {0, 1}
    assert toks == run("port", 1, 0, overlap=False)[1]
    assert eng.stats.spec_accepted == jeng.stats.spec_accepted
    assert k == 0 or eng.stats.spec_accepted > 0
    _leak_free(eng)
