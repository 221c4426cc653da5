"""Sampled decoding in the port against the JAX package: the sampler
functions (``sample_from_logits``, ``speculative_sample``) draw for draw
on the same logits and ``RandomState``, and the engines' sampled tokens
against JAX's engines on the same weights, requests and seeds: the paged
engine with ``temperature=0.7, top_k=40`` and ``temperature=1.0,
top_p=0.9``, serial loop and pipelined tick, with the prefix cache, with
speculation (k = 3) and under priority preemption with a forced
``preempt(b)``; the contiguous engine.  Then the twin of
``scripts/check_spec_identity.py``'s dp = 1 rows (speculation on equals
the one-token oracle under sampling, for fcfs, priority with preemption
and fair, with drafts accepted), schedule invariance (submission order,
slot counts, the engine, a request's own ``seed``), the greedy path
untouched (no logits come home) and the launcher's ``--temperature``.
Reduced tinyllama-42m in fp32, JAX's init through the bridge."""
import functools

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import ShapeConfig
from repro.core import model as jmodel
from repro.core import steps as jsteps
from repro.core.partition import ShardingPlan as JaxPlan
from repro.serving import PriorityScheduler as JaxPriority
from repro.serving import Request as JaxRequest
from repro.serving import SamplerConfig as JaxSampler
from repro.serving import ServingEngine as JaxEngine
from repro.serving.sampler import sample_from_logits as j_sample
from repro.serving.sampler import speculative_sample as j_spec_sample
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.core.partition import ShardingPlan
from repro_torch.launch import serve
from repro_torch.serving import (FairScheduler, PriorityScheduler, Request,
                                 SamplerConfig, ServingEngine)
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.sampler import sample_from_logits, speculative_sample

SAMPLERS = {"top_k": dict(temperature=0.7, top_k=40),
            "top_p": dict(temperature=1.0, top_p=0.9)}
FUNCS = {"greedy": dict(), "top_k": SAMPLERS["top_k"],
         "top_p": SAMPLERS["top_p"],
         "both": dict(temperature=0.8, top_k=20, top_p=0.8)}


def _state(rng):
    """A RandomState's position: its key and index."""
    _, key, pos, *_ = rng.get_state()
    return key.tolist(), pos


# ----------------------------------------------------------- sampler funcs
@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", list(FUNCS))
def test_sample_from_logits_matches_jax(kind, seed):
    """Rows of 100 live logits in a 104-wide padded row (the pad columns
    large, so a draw past the vocab would show), three rounds from one
    stream: the same ids, and each stream left at the same position (one
    draw per row sampled, none greedy)."""
    rng = np.random.RandomState(seed)
    logits = (2.0 * rng.randn(3, 6, 104)).astype(np.float32)
    logits[..., 100:] = 50.0
    ours, theirs = np.random.RandomState(seed), np.random.RandomState(seed)
    for lg in logits:
        got = sample_from_logits(lg, SamplerConfig(**FUNCS[kind]), 100, ours)
        want = j_sample(lg, JaxSampler(**FUNCS[kind]), 100, theirs)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert (got < 100).all()
    assert _state(ours) == _state(theirs)
    if kind == "greedy":
        assert _state(ours) == _state(np.random.RandomState(seed))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", ["top_k", "top_p"])
def test_speculative_sample_matches_jax(kind, seed):
    """Verify rows whose drafts the sample takes for 0..3 rows: row i of
    the first ``seed`` rows puts its mass on draft[i]; the rows after are
    flat, so the draft there is mostly rejected.  The same emitted tokens,
    and one draw per emitted row on both sides."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(5, 64).astype(np.float32)
    draft = [int(t) for t in rng.randint(0, 60, 4)]
    for i in range(seed):
        logits[i, draft[i]] = 40.0
    ours, theirs = np.random.RandomState(seed), np.random.RandomState(seed)
    got = speculative_sample(logits, draft, SamplerConfig(**SAMPLERS[kind]),
                             60, ours)
    want = j_spec_sample(logits, draft, JaxSampler(**SAMPLERS[kind]), 60,
                         theirs)
    assert got == want and len(got) >= seed + 1
    assert got[:seed] == draft[:seed]
    assert _state(ours) == _state(theirs)


# ----------------------------------------------------------------- engines
SB, PSZ, CHUNK, SLOTS = 64, 8, 8, 3


@pytest.fixture(scope="module")
def weights():
    """Reduced tinyllama in fp32 from JAX's init (init scale: sampled
    tokens spread over the top 40, and a motif's draft is sometimes
    sampled), and the port's copy through the bridge."""
    jcfg = jax_reduced(jax_get_config("tinyllama-42m"), dtype="float32")
    jp = jmodel.init_params(jcfg, JaxPlan(tp=1, kv_cache_dtype="float32"))
    cfg = reduced(get_config("tinyllama-42m"), dtype="float32")
    return jcfg, jp, cfg, params_from_jax(
        cfg, ShardingPlan(kv_cache_dtype="float32"),
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def motif_prompts(vocab, n=6, seed=11, shared_len=8):
    """A shared prefix and tiled motifs: prompt lookup drafts on them, and
    the shared prefix is a prefix-cache hit."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(2, vocab, shared_len)
    out = []
    for i in range(n):
        motif = rng.randint(2, vocab, 3 + i % 2)
        out.append(np.concatenate([shared, np.tile(motif, 4)[:8 + 2 * (i % 3)]])
                   .astype(np.int32))
    return out


def _jax_paged(w, mesh1, sampler, **kw):
    jcfg, jp, _, _ = w
    return JaxEngine.build_paged(jcfg, JaxPlan(tp=1, kv_cache_dtype="float32"),
                                 mesh1, kw.pop("slots", SLOTS), SB, jp,
                                 page_size=PSZ, prefill_chunk=CHUNK,
                                 sampler=JaxSampler(**sampler), rng_seed=5,
                                 **kw)


def _port_paged(w, sampler, **kw):
    _, _, cfg, p = w
    return ServingEngine.build_paged(
        cfg, ShardingPlan(kv_cache_dtype="float32"), kw.pop("slots", SLOTS),
        SB, p, page_size=PSZ, prefill_chunk=CHUNK,
        sampler=SamplerConfig(**sampler), rng_seed=kw.pop("rng_seed", 5),
        device="cpu", **kw)


def _serve(eng, cls, prompts, max_new=12, arrivals=None, preempt=(),
           **req_kw):
    """Submit ``prompts`` (all at once, or the first ``arrivals[0]`` and
    one more every ``arrivals[1]`` ticks), ``preempt(b)`` the first busy
    slot before each tick in ``preempt``, run to the end -> each request's
    tokens, by rid."""
    reqs = [cls(rid=i, prompt=p.copy(), max_new_tokens=max_new,
                **{k: v(i) for k, v in req_kw.items()})
            for i, p in enumerate(prompts)]
    first, every = arrivals or (len(reqs), 1)
    waiting, tick = list(reqs), 0
    while waiting or eng.has_pending() or \
            any(a is not None for a in eng.admissions):
        assert tick < 3000
        n_in = len(reqs) - len(waiting)
        while waiting and (n_in < first or tick >= every * (n_in - first + 1)):
            eng.submit(waiting.pop(0))
            n_in += 1
        if tick in preempt and any(a is not None for a in eng.admissions):
            eng.preempt(next(b for b in range(eng.B)
                             if eng.admissions[b] is not None))
        eng.tick()
        tick += 1
    eng.run()
    assert all(r.done for r in reqs)
    return {r.rid: r.out_tokens for r in reqs}


@pytest.mark.parametrize("overlap", [False, True], ids=["serial", "overlap"])
@pytest.mark.parametrize("kind", list(SAMPLERS))
def test_paged_engine_samples_jax_s_tokens(weights, mesh1, kind, overlap):
    """The same sampled tokens and ticks as JAX's paged engine, and not
    the greedy ones."""
    prompts = motif_prompts(weights[2].vocab_size)
    jeng = _jax_paged(weights, mesh1, SAMPLERS[kind], overlap=overlap)
    want = _serve(jeng, JaxRequest, prompts)
    eng = _port_paged(weights, SAMPLERS[kind], overlap=overlap)
    got = _serve(eng, Request, prompts)
    assert got == want
    assert (eng.stats.ticks, eng.stats.plan_ahead_ticks) == \
        (jeng.stats.ticks, jeng.stats.plan_ahead_ticks)
    assert got != _serve(_port_paged(weights, {}, overlap=overlap), Request,
                         prompts)
    assert eng.drain() == 0
    assert eng.allocator.n_free == eng.allocator.n_pages - 1


def test_paged_engine_samples_jax_s_tokens_with_the_prefix_cache(weights,
                                                                 mesh1):
    """A shared 20-token prefix (hits end mid-page: copy-on-write), cache
    on both sides: tokens, ticks, skipped prefill tokens and COW copies
    equal JAX's, and the tokens equal the port's with the cache off."""
    prompts = motif_prompts(weights[2].vocab_size, shared_len=20)
    jeng = _jax_paged(weights, mesh1, SAMPLERS["top_k"], prefix_cache=True)
    want = _serve(jeng, JaxRequest, prompts)
    eng = _port_paged(weights, SAMPLERS["top_k"], prefix_cache=True)
    got = _serve(eng, Request, prompts)
    st, jst = eng.stats, jeng.stats
    assert got == want
    assert (st.ticks, st.prefill_tokens_skipped, st.cow_copies) == \
        (jst.ticks, jst.prefill_tokens_skipped, jst.cow_copies)
    assert st.prefill_tokens_skipped > 0 and st.cow_copies > 0
    assert got == _serve(_port_paged(weights, SAMPLERS["top_k"]), Request,
                         prompts)


@pytest.mark.parametrize("kind", list(SAMPLERS))
def test_paged_engine_samples_jax_s_tokens_with_speculation(weights, mesh1,
                                                            kind):
    """speculative=3 (JAX without a prefix cache: the port's drafts come
    from the request's own context), serial loop: tokens, ticks and the
    spec counters equal JAX's; the tokens equal the one-token engine's."""
    prompts = motif_prompts(weights[2].vocab_size)
    jeng = _jax_paged(weights, mesh1, SAMPLERS[kind], speculative=3,
                      prefix_cache=False, overlap=False)
    want = _serve(jeng, JaxRequest, prompts)
    eng = _port_paged(weights, SAMPLERS[kind], speculative=3, overlap=False)
    got = _serve(eng, Request, prompts)
    st, jst = eng.stats, jeng.stats
    assert got == want
    assert (st.ticks, st.spec_steps, st.spec_drafted, st.spec_accepted) == \
        (jst.ticks, jst.spec_steps, jst.spec_drafted, jst.spec_accepted)
    assert st.spec_steps > 0
    assert got == _serve(_port_paged(weights, SAMPLERS[kind]), Request,
                         prompts)


@pytest.mark.parametrize("overlap", [False, True], ids=["serial", "overlap"])
def test_paged_engine_samples_jax_s_tokens_under_preemption(weights, mesh1,
                                                            overlap):
    """PriorityScheduler(preemption=True), every 3rd request urgent and
    arriving while others run, the prefix cache on (victims' pages
    donated), and ``preempt(b)`` forced at ticks 3 and 9: each request
    keeps its stream across its preemptions, so the tokens equal JAX's
    (with the same ticks and preemptions) and the uninterrupted FCFS
    run's."""
    prompts = motif_prompts(weights[2].vocab_size, n=7)
    kw = dict(prefix_cache=True, overlap=overlap, slots=2)
    pri = dict(priority=lambda i: 10 if i % 3 == 2 else 0)
    jeng = _jax_paged(weights, mesh1, SAMPLERS["top_k"], **kw,
                      scheduler=functools.partial(JaxPriority,
                                                  preemption=True))
    want = _serve(jeng, JaxRequest, prompts, arrivals=(2, 3),
                  preempt={3, 9}, **pri)
    eng = _port_paged(weights, SAMPLERS["top_k"], **kw,
                      scheduler=functools.partial(PriorityScheduler,
                                                  preemption=True))
    got = _serve(eng, Request, prompts, arrivals=(2, 3), preempt={3, 9},
                 **pri)
    st, jst = eng.stats, jeng.stats
    assert got == want
    assert (st.ticks, st.preemptions, st.plan_invalidations) == \
        (jst.ticks, jst.preemptions, jst.plan_invalidations)
    assert st.preemptions > 2                 # forced and the policy's
    assert got == _serve(_port_paged(weights, SAMPLERS["top_k"], slots=2),
                         Request, prompts)


@pytest.mark.parametrize("kind", list(SAMPLERS))
def test_contiguous_engine_samples_jax_s_tokens(weights, mesh1, kind):
    jcfg, jp, cfg, p = weights
    jplan = JaxPlan(tp=1, kv_cache_dtype="float32")
    dec, _, _ = jsteps.make_decode_step(jcfg, jplan, mesh1,
                                        ShapeConfig("s", "decode", SB, SLOTS))
    pre, _, _ = jsteps.make_prefill_step(jcfg, jplan, mesh1,
                                         ShapeConfig("p", "decode", SB, 1))
    jeng = JaxEngine(jcfg, jplan, mesh1, SLOTS, SB, jp, jax.jit(pre),
                     jax.jit(dec), sampler=JaxSampler(**SAMPLERS[kind]),
                     rng_seed=5)
    prompts = motif_prompts(cfg.vocab_size)
    want = _serve(jeng, JaxRequest, prompts)
    eng = ServingEngine(cfg, ShardingPlan(kv_cache_dtype="float32"), SLOTS,
                        SB, p, sampler=SamplerConfig(**SAMPLERS[kind]),
                        rng_seed=5, device="cpu")
    got = _serve(eng, Request, prompts)
    assert got == want
    assert (eng.stats.ticks, eng.stats.prefills) == \
        (jeng.stats.ticks, jeng.stats.prefills)
    # the paged engine draws the same tokens from the same streams
    assert got == _serve(_port_paged(weights, SAMPLERS[kind]), Request,
                         prompts)


# ------------------------------------------------- the spec identity twin
@pytest.mark.parametrize("policy", ["fcfs", "priority", "fair"])
def test_speculation_equals_the_one_token_oracle_under_sampling(weights,
                                                                mesh1,
                                                                policy):
    """``scripts/check_spec_identity.py``'s dp = 1 rows at temperature 0.7
    (top_k 40), prefix cache on, requests arriving over time (two at once,
    then one every 3 ticks; every 3rd urgent from the third on, two
    clients): speculative=4,
    pipelined, emits exactly the one-token serial oracle's tokens, which
    are JAX's; some drafts are accepted, and priority preempts."""
    sched = {"fcfs": (None, None),
             "priority": (functools.partial(PriorityScheduler,
                                            preemption=True),
                          functools.partial(JaxPriority, preemption=True)),
             "fair": (FairScheduler, None)}[policy]
    prompts = motif_prompts(weights[2].vocab_size, shared_len=12)
    req_kw = dict(priority=lambda i: 10 if i % 3 == 2 else 0,
                  client_id=lambda i: i % 2)
    oracle = _serve(_port_paged(weights, SAMPLERS["top_k"], slots=2,
                                prefix_cache=True, scheduler=sched[0],
                                overlap=False),
                    Request, prompts, arrivals=(2, 3), **req_kw)
    spec = _port_paged(weights, SAMPLERS["top_k"], slots=2, prefix_cache=True,
                       scheduler=sched[0], speculative=4)
    got = _serve(spec, Request, prompts, arrivals=(2, 3), **req_kw)
    assert got == oracle
    assert spec.stats.spec_accepted > 0
    if policy == "priority":
        assert spec.stats.preemptions > 0
        jeng = _jax_paged(weights, mesh1, SAMPLERS["top_k"], slots=2,
                          prefix_cache=True, scheduler=sched[1],
                          overlap=False)
        assert oracle == _serve(jeng, JaxRequest, prompts, arrivals=(2, 3),
                                **req_kw)


# -------------------------------------------------------- schedule invariance
def test_sampled_tokens_do_not_depend_on_the_schedule(weights):
    """Each request's tokens come from its own stream: the same requests
    submitted in reverse order, with 1 or 4 slots, or under other rids
    carrying the old rids as their ``seed``, give each request the same
    tokens; another ``rng_seed`` gives other tokens."""
    prompts = motif_prompts(weights[2].vocab_size)
    base = _serve(_port_paged(weights, SAMPLERS["top_p"]), Request, prompts)
    n = len(prompts)
    rev = _port_paged(weights, SAMPLERS["top_p"])
    reqs = [Request(rid=i, prompt=prompts[i].copy(), max_new_tokens=12)
            for i in reversed(range(n))]
    for r in reqs:
        rev.submit(r)
    rev.run()
    assert {r.rid: r.out_tokens for r in reqs} == base
    for slots in (1, 4):
        assert _serve(_port_paged(weights, SAMPLERS["top_p"], slots=slots),
                      Request, prompts) == base
    renamed = _port_paged(weights, SAMPLERS["top_p"])
    reqs = [Request(rid=100 + i, seed=i, prompt=prompts[i].copy(),
                    max_new_tokens=12) for i in range(n)]
    for r in reqs:
        renamed.submit(r)
    renamed.run()
    assert [r.out_tokens for r in reqs] == [base[i] for i in range(n)]
    other = _serve(_port_paged(weights, SAMPLERS["top_p"], rng_seed=6),
                   Request, prompts)
    assert all(other[i] != base[i] for i in range(n))


# ------------------------------------------------------------- greedy path
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_a_greedy_engine_brings_no_logits_home(weights, monkeypatch, paged):
    """temperature 0 (the default, or top_k 40 at temperature 0, the
    launcher's greedy sampler) keeps the greedy path: no logits buffer,
    no host draw, the ids' tokens."""
    _, _, cfg, p = weights
    prompts = motif_prompts(cfg.vocab_size, n=4)
    plan = ShardingPlan(kv_cache_dtype="float32")

    def build(sampler):
        if paged:
            return _port_paged(weights, sampler)
        return ServingEngine(cfg, plan, SLOTS, SB, p,
                             sampler=SamplerConfig(**sampler), device="cpu")

    want = _serve(build({}), Request, prompts)

    def never(*a, **k):
        raise AssertionError("a greedy engine drew from a stream")

    monkeypatch.setattr(engine_mod, "sample_from_logits", never)
    monkeypatch.setattr(engine_mod, "speculative_sample", never)
    eng = build(dict(temperature=0.0, top_k=40))
    assert not eng.sampled and eng._lout is None and eng._lout_host is None
    assert _serve(eng, Request, prompts) == want


@pytest.mark.parametrize("flags", [["--paged"], []],
                         ids=["paged", "contiguous"])
def test_launcher_samples_with_top_k_40(flags, monkeypatch, capsys):
    """``--temperature 0.7`` parses, builds ``SamplerConfig(0.7,
    top_k=40)`` with ``rng_seed`` = ``--seed`` as the JAX launcher does,
    and the report says sampled."""
    seen = []
    init = ServingEngine.__init__

    def record(self, *args, **kw):
        seen.append((kw["sampler"], kw["rng_seed"]))
        init(self, *args, **kw)

    monkeypatch.setattr(ServingEngine, "__init__", record)
    assert serve.parse_args(["--arch", "tinyllama-42m", "--temperature",
                             "0.7"]).temperature == 0.7
    assert serve.main(["--arch", "tinyllama-42m", "--smoke", "--device", "cpu",
                       "--kv-dtype", "fp32", "--requests", "3", "--slots", "2",
                       "--seq-budget", "64", "--page-size", "8",
                       "--prefill-chunk", "16", "--max-new", "4", "--seed",
                       "3", "--temperature", "0.7", *flags]) == 0
    assert seen == [(SamplerConfig(temperature=0.7, top_k=40), 3)]
    out = capsys.readouterr().out
    assert "decoding=sampled(temperature=0.7,top_k=40)" in out
    assert "tokens=12" in out
