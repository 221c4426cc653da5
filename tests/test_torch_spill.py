"""Host spill of cached pages and the hedged router in the port, against the
JAX package on the CPU.

``HostSpillStore`` (overwrite semantics, counters) against JAX's; the
engine's ``spill_state``/``_restore_from_spill`` and their wiring
(``build_paged(spill=)``, the spill at a drain, the restore after
``scale_to``) on the same requests as JAX's engine: (a) a drain-time
spill of one replica's radix entries restored into the survivor at dp 2,
int8 payloads and scale rows byte-identical before and after and again
after one more tick (the plan's scale-row reset of recycled pages must
not touch restored pages), the store's keys and counters equal JAX's;
(b) a restart warm-started from the store (tokens, prefix hits, skipped
prefill tokens); (c) the cross-KV warm start on reduced seamless (a hit,
no encode); (d) a grow with a store attached restores into the replica
JAX picks; (e) ``runtime.straggler.HedgedRouter`` under synthetic
backends.  Reduced tinyllama-42m (page 8, chunk 16, 2 slots a replica,
prefix cache on, ``overlap=False``) and seamless-m4t-large-v2 in fp32,
JAX's init through the bridge."""
import time

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import model as jmodel
from repro.core.partition import ShardingPlan as JaxPlan
from repro.runtime.straggler import HedgedRouter as JaxHedgedRouter
from repro.serving import HostSpillStore as JaxStore
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.core import kvcache
from repro_torch.core.partition import ShardingPlan
from repro_torch.runtime.straggler import HedgedRouter
from repro_torch.serving import HostSpillStore, Request, ServingEngine

SB, PSZ, CHUNK = 64, 8, 16
KVDS = ("float32", "int8")


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


def _sides():
    return {"port": (HostSpillStore, Request), "jax": (JaxStore, JaxRequest)}


def _build(side, w, mesh1, kvd, dp, **kw):
    """One side's paged engine: 2 slots a replica, the prefix cache on, the
    serial loop."""
    jcfg, jp, cfg, params = w
    if side == "jax":
        return JaxEngine.build_paged(
            jcfg, JaxPlan(tp=1, kv_cache_dtype=kvd), mesh1, 2, SB, jp,
            page_size=PSZ, prefill_chunk=CHUNK, prefix_cache=True, dp=dp,
            overlap=False, **kw)
    return ServingEngine.build_paged(
        cfg, ShardingPlan(kv_cache_dtype=kvd), 2, SB, params[kvd],
        page_size=PSZ, prefill_chunk=CHUNK, prefix_cache=True, dp=dp,
        overlap=False, device="cpu", **kw)


def _requests(Req, vocab, n=6, seed=0, rid0=0):
    """JAX's elastic mix: prompts of 4-19 tokens, 2-7 new."""
    rng = np.random.RandomState(seed)
    return [Req(rid=rid0 + i,
                prompt=rng.randint(2, vocab, int(rng.randint(4, 20)))
                .astype(np.int32),
                max_new_tokens=int(rng.randint(2, 8)))
            for i in range(n)]


def _again(Req, reqs, rid0=100):
    return [Req(rid=r.rid + rid0, prompt=r.prompt.copy(),
                max_new_tokens=int(r.max_new_tokens)) for r in reqs]


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run(max_ticks=5000)
    assert all(r.done for r in reqs)
    return [list(r.out_tokens) for r in reqs]


def _pages_bytes(eng, r, pages, kind="kv"):
    """Replica ``r``'s ``pages`` of every pool of ``kind``, by pool name, as
    numpy (JAX's pools are (reps, R, n_pages, ...); the port's unfold)."""
    port = isinstance(eng, ServingEngine)
    cache = kvcache.unfold_replica_pools(eng.cache, eng.R) if port \
        else eng.cache
    out = []
    for group in cache:
        for entry in group:
            for name, pool in sorted(entry.get(kind, {}).items()):
                out.append((name, np.asarray(
                    pool[:, r, list(pages)].numpy() if port
                    else pool[:, r, np.asarray(pages, np.int32)])))
    return out


def _same_bytes(got, want):
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


def _store_summary(store):
    return (sorted((k, n) for k, (n, _) in store.radix.items()),
            sorted((k, n) for k, (n, _) in store.cross.items()),
            store.n_entries, store.pages_saved, store.pages_restored)


def _leak_free(eng):
    eng.drain()
    for r in range(eng.R):
        a = eng.allocators[r]
        cached = eng.prefix_caches[r].n_cached_pages \
            if eng.prefix_caches[r] is not None else 0
        if eng.cross_caches:
            cached += eng.cross_caches[r].n_cached_pages
        assert a.n_free + cached == a.n_pages - a.n_reserved, r


def test_host_spill_store_matches_jax():
    """The store on its own: token paths normalised to int tuples, a key
    spilled again replaced (the latest bytes win) while ``pages_saved``
    counts every spill, ``n_entries`` over both dicts."""
    got = {}
    for side, (Store, _) in _sides().items():
        s = Store()
        s.put_prefix(np.arange(2, 10, dtype=np.int32), 1, ["a"])
        s.put_prefix((2, 3, 4, 5, 6, 7, 8, 9), 1, ["b"])
        s.put_prefix([5] * 16, 2, ["c"])
        s.put_cross("d1", 2, ["x"])
        s.put_cross("d1", 2, ["y"])
        got[side] = (sorted(s.radix.items()), sorted(s.cross.items()),
                     s.n_entries, s.pages_saved, s.pages_restored,
                     {type(k[0]) for k in s.radix})
    assert got["port"] == got["jax"]
    assert got["port"][2:5] == (3, 8, 0)
    assert dict(got["port"][0])[tuple(range(2, 10))] == (1, ["b"])


def test_spill_restore_int8_byte_identity(weights, mesh1):
    """(a) dp 2, int8 pools, a store attached: the drain of the replica
    holding radix entries spills them and the restore writes them into the
    survivor's fresh pages; every restored page's payload and scale rows
    equal the pre-drain bytes, and still do after one more tick (whose
    plan resets the scale rows of recycled pages).  The store's keys, page
    counts and counters, the donor and the survivor's cached paths equal
    JAX's; tokens of the round equal JAX's."""
    got = {}
    for side, (Store, Req) in _sides().items():
        store = Store()
        eng = _build(side, weights, mesh1, "int8", dp=2, spill=store)
        reqs = _requests(Req, weights[2].vocab_size, seed=1)
        toks = _serve(eng, reqs)
        eng._barrier()
        donor = next(r for r in range(2)
                     if eng.prefix_caches[r].n_cached_pages > 0)
        before = {t: _pages_bytes(eng, donor, p)
                  for t, p in eng.prefix_caches[donor].entries()}
        assert before, "no radix entries to spill"
        keep = 1 - donor
        eng._drain_replicas([donor], [keep])
        eng._rebuild([keep], 1)
        eng._restore_from_spill(store)
        assert store.pages_saved > 0 and store.pages_restored > 0

        def check(eng=eng, before=before):
            for t, want in before.items():
                n, pages = eng.prefix_caches[0].lookup(list(t))
                assert n == len(t), "restored prefix not found"
                _same_bytes(_pages_bytes(eng, 0, pages), want)
        check()
        late = Req(rid=99, prompt=np.arange(3, 30, dtype=np.int32),
                   max_new_tokens=3)
        eng.submit(late)
        eng.tick()
        check()
        eng.run(max_ticks=5000)
        check()
        got[side] = (toks, donor, _store_summary(store),
                     sorted(t for t, _ in eng.prefix_caches[0].entries()),
                     list(late.out_tokens))
        _leak_free(eng)
    assert got["port"] == got["jax"]


def test_spill_warm_start_radix(weights, mesh1):
    """(b) A restart with the previous engine's store (``build_paged(
    spill=)``): the repeated prompts hit the restored prefixes; tokens equal
    the cold run's, and tokens, prefix hits, skipped prefill tokens and
    the store's counters equal JAX's."""
    got = {}
    for side, (Store, Req) in _sides().items():
        eng = _build(side, weights, mesh1, "float32", dp=1)
        reqs = _requests(Req, weights[2].vocab_size, n=4)
        cold = _serve(eng, reqs)
        store = eng.spill_state()
        assert isinstance(store, Store) and store.n_entries > 0
        eng2 = _build(side, weights, mesh1, "float32", dp=1, spill=store)
        assert store.pages_restored > 0
        warm = _serve(eng2, _again(Req, reqs))
        assert warm == cold
        st = eng2.stats
        assert st.prefix_hits > 0 and st.prefill_tokens_skipped > 0
        got[side] = (cold, _store_summary(store), st.prefix_hits,
                     st.prefill_tokens_skipped, st.ticks)
        _leak_free(eng2)
    assert got["port"] == got["jax"]


def test_spill_warm_start_cross_kv(mesh1):
    """(c) Reduced seamless (JAX's CPU config, weights x10 but the
    layernorms'): the spilled encode restores into a fresh engine, so a
    request over the same frames hits without encoding; tokens equal
    JAX's and the cold run's over the same prompt."""
    small = dict(dtype="float32", n_enc_layers=1, enc_seq_len=16)
    arch = "seamless-m4t-large-v2"
    jcfg = jax_reduced(jax_get_config(arch), **small)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: a if any(getattr(k, "key", "").startswith(
            ("ln", "final_norm")) for k in path) else a * 10,
        jmodel.init_params(jcfg, JaxPlan(tp=1, kv_cache_dtype="float32")))
    cfg = reduced(get_config(arch), **small)
    p = params_from_jax(cfg, ShardingPlan(kv_cache_dtype="float32"),
                        jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.RandomState(3)
    frames = rng.randn(cfg.enc_seq_len, cfg.d_model).astype(np.float32)
    prompt = rng.randint(2, cfg.vocab_size, 7).astype(np.int32)
    got = {}
    for side, (Store, Req) in _sides().items():
        if side == "jax":
            def build(**kw):
                return JaxEngine.build_paged(
                    jcfg, JaxPlan(tp=1, kv_cache_dtype="float32"), mesh1, 2,
                    32, jp, page_size=8, prefill_chunk=8, overlap=False, **kw)
        else:
            def build(**kw):
                return ServingEngine.build_paged(
                    cfg, ShardingPlan(kv_cache_dtype="float32"), 2, 32, p,
                    page_size=8, prefill_chunk=8, overlap=False,
                    device="cpu", **kw)
        eng = build()
        cold = _serve(eng, [Req(rid=0, prompt=prompt.copy(), max_new_tokens=3,
                                frames=frames.copy())])
        assert eng.stats.cross_encodes == 1
        (key, pages), = eng.cross_caches[0].entries()
        before = _pages_bytes(eng, 0, pages, "cross")
        store = eng.spill_state()
        eng2 = build(spill=store)
        (key2, pages2), = eng2.cross_caches[0].entries()
        assert key2 == key
        _same_bytes(_pages_bytes(eng2, 0, pages2, "cross"), before)
        warm = _serve(eng2, [Req(rid=1, prompt=prompt.copy(),
                                 max_new_tokens=3, frames=frames.copy())])
        assert warm == cold
        assert eng2.stats.cross_hits == 1 and eng2.stats.cross_encodes == 0
        got[side] = (cold, _store_summary(store), eng2.stats.ticks)
        _leak_free(eng2)
    assert got["port"] == got["jax"]


def test_scale_up_restores_into_jax_s_replica(weights, mesh1):
    """(d) dp 1, int8 pools, a store attached: the cache is spilled and
    then evicted whole, a request keeps replica 0 busy, and ``scale_to(2)``
    restores every spilled entry into the least page-loaded replica (the
    joined one, as JAX picks).  The replica holding each path, the
    replayed prompts' tokens (equal to the cold run's), routing, prefix
    hits and the store's counters equal JAX's."""
    got = {}
    for side, (Store, Req) in _sides().items():
        store = Store()
        eng = _build(side, weights, mesh1, "int8", dp=1, spill=store)
        reqs = _requests(Req, weights[2].vocab_size, n=4, seed=2)
        cold = _serve(eng, reqs)
        eng.spill_state(store)
        eng.prefix_caches[0].evict(eng.allocators[0].n_pages)
        assert eng.prefix_caches[0].n_cached_pages == 0
        busy = Req(rid=50, prompt=np.arange(3, 33, dtype=np.int32),
                   max_new_tokens=6)
        eng.submit(busy)
        eng.tick()
        eng.scale_to(2)
        assert store.pages_restored > 0
        where = {t: [r for r in range(2)
                     if eng.prefix_caches[r].lookup(list(t))[0] == len(t)]
                 for t in store.radix}
        again = _again(Req, reqs)
        warm = _serve(eng, again)
        assert warm == cold and busy.done
        got[side] = (cold, where, [r.replica for r in again],
                     eng.stats.prefix_hits, eng.stats.prefill_tokens_skipped,
                     _store_summary(store), list(busy.out_tokens))
        _leak_free(eng)
    assert got["port"] == got["jax"]
    assert all(reps == [1] for reps in got["port"][1].values())


def _hedge_case(case, Router):
    """Run one synthetic hedging case -> (answers, stats without
    latencies, calls per backend)."""
    calls = {"a": 0, "b": 0}

    def backend(name, delay, fail=False):
        def fn(req):
            calls[name] += 1
            time.sleep(delay)
            if fail:
                raise RuntimeError(f"{name} failed")
            return (name, req)
        return fn

    hedge_after, a, b = {
        # primary slow, hedge fast: the hedge wins
        "hedge_wins": (0.05, backend("a", 0.5), backend("b", 0.0)),
        # primary answers before the deadline: no hedge
        "primary_wins": (2.0, backend("a", 0.0), backend("b", 0.0)),
        # the deadline passes, but the primary still answers first
        "primary_wins_hedged": (0.02, backend("a", 0.2), backend("b", 1.5)),
        # a failed primary is no answer: the hedge's answer is taken
        "primary_fails": (0.05, backend("a", 0.0, fail=True),
                          backend("b", 0.0)),
    }[case]
    router = Router([a, b], hedge_after_s=hedge_after)
    out = [router(42)]
    st = router.stats
    return (out, (st.issued, st.hedged, st.wins_primary, st.wins_hedge,
                  len(st.latencies)), dict(calls))


@pytest.mark.parametrize("case", ["hedge_wins", "primary_wins",
                                  "primary_wins_hedged", "primary_fails"])
def test_hedged_router_matches_jax(case):
    """(e) The twin of ``tests/test_fault_tolerance.py``'s hedging test and
    the cases around it: the same answer, counters and backend calls as
    JAX's ``HedgedRouter``."""
    got = _hedge_case(case, HedgedRouter)
    assert got == _hedge_case(case, JaxHedgedRouter)
    winner = {"hedge_wins": "b", "primary_wins": "a",
              "primary_wins_hedged": "a", "primary_fails": "b"}[case]
    assert got[0] == [(winner, 42)]
    assert got[1][1] == (case != "primary_wins")
