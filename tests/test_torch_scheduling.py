"""The port's priority and fair policies and preemption against the JAX
package on the CPU.

- ``PriorityScheduler`` (aging, preemption gated by base priority) and
  ``FairScheduler`` (deficit round-robin over ``client_id``, preemptive
  DRR) driven through the same operation sequences as JAX's: the same
  admission orders and victims.
- A hypothesis property: under random admission, prefill completion,
  finish and forced preemption, every request finishes exactly once and
  every page ends free or cached (``tests/test_scheduling.py``), with the
  same decisions as JAX's scheduler at every step.
- The paged engine under priority and fair preemption against JAX's engine
  (weights through ``bridge.params_from_jax``), ``overlap`` off and on:
  greedy tokens, ticks, preemptions and rolled-back verdicts; tokens equal
  to FCFS without preemption; leak-free after ``drain()``.
- mamba2 with ``preempt(b)`` forced mid-flight from float32 and int8 slabs
  (the slab stashed on the host and restored): tokens equal to the
  uninterrupted run and to JAX's, ``slab_restores`` as JAX counts them.
- The launcher's policy flags."""
import functools

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import model as jmodel
from repro.core.kvcache import PageAllocator as JaxAllocator
from repro.core.partition import ShardingPlan as JaxPlan
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving.policies import FairScheduler as JaxFair
from repro.serving.policies import PriorityScheduler as JaxPriority
from repro.serving.prefix_cache import RadixPrefixCache as JaxRadix
from repro.serving.scheduler import FCFSScheduler as JaxFCFS
from repro.serving.scheduler import effective_prompt as jax_effective_prompt
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.core.kvcache import PageAllocator
from repro_torch.core.partition import ShardingPlan
from repro_torch.launch import serve
from repro_torch.serving import (FairScheduler, PriorityScheduler, Request,
                                 ServingEngine)
from repro_torch.serving.prefix_cache import RadixPrefixCache
from repro_torch.serving.scheduler import FCFSScheduler, effective_prompt

PSZ = 4
# each side's classes: (FCFS, Priority, Fair, allocator, radix cache,
# effective_prompt)
SIDES = {"jax": (JaxFCFS, JaxPriority, JaxFair, JaxAllocator, JaxRadix,
                 jax_effective_prompt),
         "port": (FCFSScheduler, PriorityScheduler, FairScheduler,
                  PageAllocator, RadixPrefixCache, effective_prompt)}


class _Req:
    def __init__(self, rid, prompt, max_new=4, priority=0, client_id=0):
        self.rid, self.prompt, self.max_new_tokens = rid, prompt, max_new
        self.priority, self.client_id = priority, client_id
        self.out_tokens = []


def toks(*ids):
    return np.asarray(ids, np.int32)


def _policy_case(name, side):
    """One of the JAX package's policy cases (``tests/test_scheduling.py``)
    on one side -> the rids admitted and evicted at each step."""
    _, Prio, Fair, Alloc, Radix, eff = SIDES[side]
    log = []
    if name == "priority-order":
        sched = Prio(seq_budget=64)
        for rid, p in enumerate([0, 5, 1, 5]):
            sched.submit(_Req(rid, toks(1, 2, 3), priority=p))
        log.append([a.req.rid for a in sched.plan([0, 1, 2, 3])])
    elif name == "aging":
        for rate in (0.25, 0.0):
            sched = Prio(seq_budget=64, aging_rate=rate)
            sched.submit(_Req(0, toks(1, 2, 3), priority=0))
            for r in range(1, 60):
                sched.submit(_Req(100 + r, toks(4, 5, 6), priority=5))
                (adm,) = sched.plan([0])
                sched.on_finish(adm)
                log.append(adm.req.rid)
    elif name in ("fair-interleave", "fair-cost"):
        sched = Fair(seq_budget=64, quantum=16 if name == "fair-interleave"
                     else 12)
        if name == "fair-interleave":
            reqs = [_Req(rid, toks(*range(8)), 4, client_id=0)
                    for rid in range(6)] + \
                [_Req(rid, toks(*range(8)), 4, client_id=1) for rid in (10, 11)]
        else:
            reqs = [_Req(rid, toks(*range(30)), 6, client_id=0)
                    for rid in range(4)] + \
                [_Req(rid, toks(*range(8)), 4, client_id=1)
                 for rid in range(10, 22)]
        for r in reqs:
            sched.submit(r)
        while sched.has_pending():
            (adm,) = sched.plan([0])
            log.append(adm.req.rid)
            sched.on_finish(adm)
    elif name == "fair-preempt":
        for preemption in (True, False):
            sched = Fair(seq_budget=64, quantum=16, preemption=preemption,
                         preempt_after=3)
            for rid in range(4):
                sched.submit(_Req(rid, toks(*range(8)), 8, client_id=0))
            adms = sched.plan([0, 1])
            sched.submit(_Req(10, toks(*range(8)), 8, client_id=1))
            for tick in range(20):
                victims = sched.plan_preemptions(adms, 0)
                log.append((tick, [v.req.rid for v in victims]))
                if victims:
                    break
            if victims:
                sched.on_preempt(victims[0], eff(victims[0].req)[:0])
                active = [a for a in adms if a is not victims[0]]
                (adm1,) = sched.plan([victims[0].slot])
                log.append((adm1.req.rid,
                            sched.plan_preemptions(active + [adm1], 0)))
    elif name == "priority-preempt":
        sched = Prio(seq_budget=64, preemption=True)
        lo_a, lo_b = _Req(0, toks(1, 2, 3), priority=1), \
            _Req(1, toks(4, 5, 6), priority=0)
        sched.submit(lo_a)
        sched.submit(lo_b)
        adms = sched.plan([0, 1])
        log.append(sched.plan_preemptions(adms, 0))
        sched.submit(_Req(2, toks(7, 8, 9), priority=5))
        victims = sched.plan_preemptions(adms, 0)
        log.append([v.req.rid for v in victims])
        sched.on_preempt(victims[0], eff(lo_b)[:0])
        (adm_hi,) = sched.plan([victims[0].slot])
        log.append(adm_hi.req.rid)
        log.append(sched.plan_preemptions([adms[0], adm_hi], 0))
        sched.submit(_Req(3, toks(1), priority=9))
        log.append(sched.plan_preemptions([adms[0], adm_hi], 1))
    elif name == "page-pressure":
        alloc = Alloc(9)
        sched = Prio(seq_budget=32, allocator=alloc, page_size=PSZ,
                     prefix_cache=None, stats=None, preemption=True)
        low = _Req(0, toks(*range(16)), 8, priority=0)
        sched.submit(low)
        (adm,) = sched.plan([0, 1])
        sched.submit(_Req(1, toks(*range(8)), 8, priority=10))
        (victim,) = sched.plan_preemptions([adm], 1)
        sched.on_preempt(victim, eff(low)[:0])
        (adm_hi,) = sched.plan([0, 1])
        log += [victim.req.rid, adm_hi.req.rid, len(adm_hi.pages),
                alloc.n_free]
    elif name == "donate-resume":
        alloc = Alloc(16)
        cache = Radix(alloc, PSZ)
        sched = Prio(seq_budget=64, allocator=alloc, page_size=PSZ,
                     prefix_cache=cache, stats=None, preemption=True)
        req = _Req(0, toks(*range(10, 18)), 8)
        sched.submit(req)
        (adm,) = sched.plan([0])
        sched.on_prefill_complete(adm)
        req.out_tokens = [91, 92, 93, 94, 95]
        sched.on_preempt(adm, eff(req)[:12])
        log += [alloc.n_free, cache.n_cached_pages, sched.has_pending()]
        (adm2,) = sched.plan([0])
        log += [adm2.cached_len, adm2.cow, adm2.pages[:3] == adm.pages[:3]]
        sched.on_finish(adm2)
        cache.evict(10 ** 6)
        log.append(alloc.n_free)
    return log


@pytest.mark.parametrize("name", [
    "priority-order", "aging", "fair-interleave", "fair-cost",
    "fair-preempt", "priority-preempt", "page-pressure", "donate-resume"])
def test_policy_decisions_match_jax(name):
    """Admission order by priority (ties by submission), aging that ends
    starvation (and none without it), DRR interleaving and charging by
    cost, preemptive DRR and priority preemption (victim choice, no
    ping-pong, free slots first, page pressure), and a preempted request
    donating its pages and resuming as a prefix hit: the same decisions as
    JAX's policies."""
    got = _policy_case(name, "port")
    assert got == _policy_case(name, "jax")
    if name == "priority-order":
        assert got == [[1, 3, 2, 0]]
    if name == "aging":
        assert 0 in got[:59] and 0 not in got[59:]
    if name == "donate-resume":
        assert got[3:5] == [12, None] and got[-1] == 15


def _policies(side):
    FCFS, Prio, Fair, *_ = SIDES[side]
    return {"fcfs": lambda **kw: FCFS(**kw),
            "priority": lambda **kw: Prio(preemption=True, **kw),
            "fair": lambda **kw: Fair(quantum=8, **kw)}


def _conserve(name, seed, side):
    """Random admission, COW, prefill completion, finish and forced
    preemption over 3 slots and a 32-page pool -> every decision made, and
    checks that every request finished once and every page ends free or
    cached (free after a full evict)."""
    _, _, _, Alloc, Radix, eff = SIDES[side]
    rng = np.random.RandomState(seed)
    alloc = Alloc(33)
    cache = Radix(alloc, PSZ)
    sched = _policies(side)[name](seq_budget=64, allocator=alloc,
                                  page_size=PSZ, prefix_cache=cache,
                                  stats=None)
    reqs = [_Req(rid, toks(*rng.randint(2, 50, rng.randint(1, 13))),
                 max_new=int(rng.randint(1, 7)),
                 priority=int(rng.randint(0, 4)),
                 client_id=int(rng.randint(0, 3)))
            for rid in range(20)]
    for r in reqs:
        sched.submit(r)
    active, finished, preempts, log = {}, [], 0, []
    for _ in range(5000):
        if len(finished) == len(reqs):
            break
        free = [s for s in range(3) if s not in active]
        for adm in sched.plan(free):
            log.append((adm.slot, adm.req.rid, list(adm.pages),
                        adm.cached_len, adm.cow))
            if adm.cow is not None:
                sched.on_cow_done(adm)
            active[adm.slot] = [adm, False]
        for slot in list(active):
            adm, prefilled = active[slot]
            req = adm.req
            if rng.rand() < 0.15 and preempts < 60:
                n = (len(req.prompt) + len(req.out_tokens) - 1
                     if prefilled and req.out_tokens else
                     int(rng.randint(0, len(req.prompt) + 1)))
                sched.on_preempt(adm, eff(req)[:max(n, 0)])
                del active[slot]
                preempts += 1
                continue
            if not prefilled:
                sched.on_prefill_complete(adm)
                active[slot][1] = True
            req.out_tokens.append(int(rng.randint(2, 50)))
            if len(req.out_tokens) >= req.max_new_tokens:
                sched.on_finish(adm)
                finished.append(req.rid)
                del active[slot]
    assert sorted(finished) == list(range(len(reqs)))     # each once
    assert alloc.n_free + cache.n_cached_pages == 32
    assert sched.backlog_pages == 0 and not sched.has_pending()
    cache.evict(10 ** 6)
    assert alloc.n_free == 32
    return log, preempts


@pytest.mark.parametrize("name", ["fcfs", "priority", "fair"])
@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 2 ** 16))
def test_policies_conserve_requests_and_pages(name, seed):
    """Requests and pages are conserved under random admissions, COW
    copies, completions and forced preemptions, for each policy, and the
    port decides every step as JAX's scheduler does."""
    got = _conserve(name, seed, "port")
    assert got == _conserve(name, seed, "jax")
    assert got[1] > 0


# --------------------------------------------------------------- engine
SB, PSZ_E, CHUNK = 64, 8, 16


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


def _mixed(vocab, n=9, seed=0):
    """(rid, prompt, max_new, priority, client): every 3rd request urgent,
    three clients."""
    rng = np.random.RandomState(seed)
    return [(i, rng.randint(2, vocab, int(rng.randint(4, 20))).astype(
        np.int32), int(rng.randint(8, 16)), 10 if i % 3 == 2 else 0, i % 3)
        for i in range(n)]


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


POLICIES = {
    "priority": (PriorityScheduler, JaxPriority, {}),
    "fair": (FairScheduler, JaxFair, {"quantum": 8, "preempt_after": 1}),
}


@pytest.mark.parametrize("overlap", [False, True], ids=["serial", "overlap"])
@pytest.mark.parametrize("policy", list(POLICIES))
def test_preemptive_policies_match_jax_and_fcfs(weights, mesh1, policy,
                                                overlap):
    """Requests arriving while others run, under priority (every 3rd
    urgent) or fair (three clients) preemption with the prefix cache: the
    port's greedy tokens, ticks, preemptions, rolled-back verdicts and
    skipped prefill tokens equal JAX's; the tokens equal FCFS without
    preemption; pages free or cached after ``drain()``."""
    jcfg, jp, cfg, params = weights["tinyllama-42m"]
    mine, theirs, kw = POLICIES[policy]
    reqs = _mixed(cfg.vocab_size)
    runs = {}
    for side in ("jax", "port", "fcfs"):
        if side == "jax":
            eng = JaxEngine.build_paged(
                jcfg, JaxPlan(tp=1, kv_cache_dtype="float32"), mesh1, 2, SB,
                jp, page_size=PSZ_E, prefill_chunk=CHUNK, prefix_cache=True,
                overlap=overlap,
                scheduler=functools.partial(theirs, preemption=True, **kw))
            rs = [JaxRequest(rid=i, prompt=p, max_new_tokens=m, priority=pr,
                             client_id=c) for i, p, m, pr, c in reqs]
        else:
            sched = None if side == "fcfs" else \
                functools.partial(mine, preemption=True, **kw)
            eng = ServingEngine.build_paged(
                cfg, ShardingPlan(kv_cache_dtype="float32"), 2, SB, params,
                page_size=PSZ_E, prefill_chunk=CHUNK,
                prefix_cache=side == "port", overlap=overlap,
                scheduler=sched, device="cpu")
            rs = [Request(rid=i, prompt=p, max_new_tokens=m, priority=pr,
                          client_id=c) for i, p, m, pr, c in reqs]
        _arrivals(eng, rs)
        assert all(r.done for r in rs)
        s = eng.stats
        runs[side] = ([r.out_tokens for r in rs], s.ticks, s.preemptions,
                      s.plan_invalidations, s.prefill_tokens_skipped)
        if side == "port":
            assert eng.drain() == 0
            assert eng.allocator.n_free + eng.prefix_cache.n_cached_pages == \
                eng.allocator.n_pages - 1
    assert runs["port"] == runs["jax"]
    assert runs["port"][0] == runs["fcfs"][0]
    assert runs["port"][2] > 0 and runs["fcfs"][2] == 0


@pytest.mark.parametrize("ssm_dtype", ["", "int8"],
                         ids=["f32-slabs", "i8-slabs"])
@pytest.mark.parametrize("overlap", [False, True], ids=["serial", "overlap"])
def test_mamba2_forced_preemption_restores_the_stash(weights, mesh1,
                                                     ssm_dtype, overlap):
    """mamba2 with ``preempt(b)`` forced at ticks 1, 3 and 1-2-3 (mid-
    prefill and mid-decode): each slab goes to the host and back, so the
    tokens equal the uninterrupted run's and JAX's, with one restore per
    preemption and the same ticks and skipped tokens as JAX; slabs free
    after ``drain()``, which also drops a stash left behind."""
    jcfg, jp, cfg, params = weights["mamba2-370m"]
    rng = np.random.RandomState(3)
    base = [(rng.randint(2, cfg.vocab_size, L).astype(np.int32), m)
            for L, m in ((13, 8), (9, 6))]

    def run(side, pts):
        if side == "jax":
            eng = JaxEngine.build_paged(
                jcfg, JaxPlan(tp=1, kv_cache_dtype="float32",
                              ssm_cache_dtype=ssm_dtype), mesh1, 2, 32, jp,
                page_size=8, prefill_chunk=8, overlap=overlap)
            reqs = [JaxRequest(rid=i, prompt=p.copy(), max_new_tokens=m)
                    for i, (p, m) in enumerate(base)]
        else:
            eng = ServingEngine.build_paged(
                cfg, ShardingPlan(kv_cache_dtype="float32",
                                  ssm_cache_dtype=ssm_dtype), 2, 32, params,
                page_size=8, prefill_chunk=8, overlap=overlap, device="cpu")
            reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=m)
                    for i, (p, m) in enumerate(base)]
        for r in reqs:
            eng.submit(r)
        tick = 0
        while eng.has_pending() or any(a is not None for a in eng.admissions):
            if tick in pts:
                eng.preempt(next(b for b in range(eng.B)
                                 if eng.admissions[b] is not None))
            eng.tick()
            tick += 1
        eng.run()
        assert all(r.done for r in reqs)
        st = eng.stats
        return eng, ([r.out_tokens for r in reqs], st.slab_restores,
                     st.preemptions, st.ticks, st.prefill_tokens_skipped)

    ref = run("port", set())[1]
    for pts in ({1}, {3}, {1, 2, 3}):
        eng, got = run("port", pts)
        assert got == run("jax", pts)[1]
        assert got[0] == ref[0] and got[1] == got[2] == len(pts)
        assert eng.drain() == 0 and eng.slab_allocator.n_free == \
            eng.n_slabs - 1 and eng.allocator.n_free == \
            eng.allocator.n_pages - 1
    # a stash whose request is still queued goes with drain()
    eng, _ = run("port", set())
    reqs = [Request(rid=10 + i, prompt=p.copy(), max_new_tokens=m)
            for i, (p, m) in enumerate(base)]
    for r in reqs:
        eng.submit(r)
    for _ in range(3):
        eng.tick()
    eng.preempt(next(b for b in range(eng.B) if eng.admissions[b] is not None))
    assert eng._stash
    eng.drain()
    assert not eng._stash


# --------------------------------------------------------------- launcher
LAUNCH = ["--arch", "tinyllama-42m", "--smoke", "--requests", "6", "--slots",
          "2", "--seq-budget", "64", "--prompt-len", "16", "--max-new", "5",
          "--page-size", "8", "--prefill-chunk", "16", "--kv-dtype", "fp32",
          "--device", "cpu"]


def _launch_tokens(argv, monkeypatch, capsys):
    seen = []
    submit = ServingEngine.submit

    def record(self, req):
        seen.append(req)
        return submit(self, req)

    with monkeypatch.context() as m:
        m.setattr(ServingEngine, "submit", record)
        assert serve.main(argv) == 0
    return [r.out_tokens for r in seen], capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    ["--policy", "priority", "--high-priority-every", "3"],
    ["--policy", "priority", "--preemption", "--high-priority-every", "3",
     "--paged"],
    ["--policy", "fair", "--clients", "3"],
    ["--policy", "fair", "--preemption", "--clients", "3", "--paged"],
    ["--policy", "priority", "--preemption", "--high-priority-every", "2",
     "--prefix-cache", "--speculative", "3", "--kv-dtype", "int8"]],
    ids=["priority", "priority-preemption", "fair", "fair-preemption",
         "priority-prefix-spec-int8"])
def test_launcher_serves_the_policy_flags(flags, monkeypatch, capsys):
    """Each policy flag is served, and the greedy tokens equal the bare
    command's (policies reorder work, never tokens); urgent requests get
    their own TTFT line."""
    base, _ = _launch_tokens(LAUNCH + ["--paged"] + (
        ["--kv-dtype", "int8"] if "int8" in flags else []), monkeypatch,
        capsys)
    got, out = _launch_tokens(LAUNCH + flags, monkeypatch, capsys)
    assert got == base and all(len(t) == 5 for t in got)
    assert "preemptions=" in out
    if "--high-priority-every" in flags:
        assert "ttft[high]:" in out and "ttft[low]:" in out


@pytest.mark.parametrize("argv,message", [
    (["--preemption"], "--preemption requires --policy priority or fair"),
    (["--policy", "priority", "--preemption"],
     "--preemption requires the paged engine"),
    (["--shared-prefix", "40", "--prompt-len", "16", "--max-new", "16"],
     "--shared-prefix + --prompt-len + --max-new must fit --seq-budget")])
def test_launcher_checks_the_policy_flags_as_jax_does(argv, message, capsys):
    with pytest.raises(SystemExit) as e:
        serve.parse_args(["--arch", "tinyllama-42m", "--seq-budget", "64",
                          *argv])
    assert e.value.code == 2 and message in capsys.readouterr().err
