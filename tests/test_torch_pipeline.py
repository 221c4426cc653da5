"""The compiled-step slice on the CPU: the prefill chunk's per-tick scalars
as device data, and the paged engine's pipelined tick.

- The chunk step with ``chunk_start``/``last_idx`` as (1,) int32 tensors
  against the JAX chunk step (weights through ``bridge.params_from_jax``),
  the prompt's last token at the chunk's first row, mid-chunk and its last
  row; ``causal_conv`` with a tensor tail against ``repro.core.ssm``; the
  flash kernel's plain version with a tensor ``q_offset`` against Pallas
  flash (interpret mode).
- The engine's pipelined tick (``overlap=True``, the default) against its
  serial loop and against the JAX engine's ``build_paged(...,
  overlap=True)``: greedy tokens, ticks and plan-ahead ticks, for float and
  int8 pools, speculation and mamba2 slabs; the pipeline counters;
  ``run()`` and ``drain()`` leaving nothing in flight and every page and
  slab free.
- The greedy path: ``greedy_ids`` (ties to the first index, the padded
  vocabulary ignored) and ``greedy_accept`` against ``speculative_sample``;
  the step staging and ``core.graphs`` on the CPU (eager: the caller asked
  for the CPU).

Tolerance: fp32 1e-4 (``tests/test_kernels.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import model as jmodel
from repro.core import ssm as jssm
from repro.core import steps as jsteps
from repro.core.partition import ShardingPlan as JaxPlan
from repro.kernels.flash_attention import flash_attention as pl_flash
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.core import graphs, ssm, steps
from repro_torch.core.partition import ShardingPlan
from repro_torch.kernels import ops
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.engine import Staging
from repro_torch.serving.sampler import (SamplerConfig, greedy_accept,
                                         greedy_ids, speculative_sample)

FP32_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=FP32_TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **tol)


def _index(v):
    return torch.tensor([v], dtype=torch.int32)


@pytest.fixture(scope="module")
def weights():
    """JAX's init for the reduced configs in fp32 and the port's copy:
    -> {name: (jcfg, jp, cfg, params)}; tinyllama x25 so greedy decoding
    does not collapse onto one token, and at init scale, where it repeats
    and drafts are accepted; mamba2 at init scale."""
    out = {}
    for name, arch, scale in (("tinyllama-42m", "tinyllama-42m", 25.0),
                              ("tinyllama-init", "tinyllama-42m", 1.0),
                              ("mamba2-370m", "mamba2-370m", 1.0)):
        jcfg = jax_reduced(jax_get_config(arch), dtype="float32")
        jp = jax.tree_util.tree_map(
            lambda a, s=scale: a * s,
            jmodel.init_params(jcfg, JaxPlan(tp=1, kv_cache_dtype="float32")))
        cfg = reduced(get_config(arch), dtype="float32")
        out[name] = (jcfg, jp, cfg, params_from_jax(
            cfg, ShardingPlan(kv_cache_dtype="float32"),
            jax.tree_util.tree_map(np.asarray, jp), device="cpu"))
    return out


# --------------------------------------------------- chunk step and pieces
CH, N_MAX, PSZ, N_SLABS, SLAB = 8, 4, 8, 3, 2


@pytest.mark.parametrize("arch", ["tinyllama-42m", "mamba2-370m"])
@pytest.mark.parametrize("L", [9, 12, 16], ids=["last0", "mid", "lastC-1"])
def test_chunk_step_with_device_scalars_matches_jax(weights, mesh1, arch, L):
    """A prompt of L tokens in chunks of 8, ``chunk_start`` and
    ``last_idx`` handed to the step as (1,) int32 tensors: the last chunk
    holds the prompt's final token at row 0, mid-chunk or row C-1.  Every
    chunk's logits, and the pool pages or slab after them (conv tails cut
    at ``last_idx``), equal the JAX chunk step's."""
    jcfg, jp, cfg, params = weights[arch]
    jplan = JaxPlan(tp=1, kv_cache_dtype="float32")
    plan = ShardingPlan(kv_cache_dtype="float32")
    ssm_arch = arch.startswith("mamba2")
    n_slabs = N_SLABS if ssm_arch else 0
    n_pages = 2 * N_MAX + 1
    jchunk, _, _ = jsteps.make_prefill_chunk_step(jcfg, jplan, mesh1, CH,
                                                  n_pages, PSZ, N_MAX,
                                                  n_slabs=n_slabs)
    jchunk = jax.jit(jchunk)
    jcache = jsteps.zero_paged_cache_for(jcfg, jplan, mesh1, n_pages, PSZ,
                                         n_slabs=n_slabs)
    chunk = steps.make_prefill_chunk_step(cfg, plan, CH, N_MAX)
    cache = steps.zero_paged_cache_for(cfg, plan, n_pages, PSZ, "cpu", n_slabs)
    prompt = np.random.RandomState(L).randint(2, cfg.vocab_size, L)
    bt = np.asarray([[5, 2, 7, 1]], np.int32)
    for c0 in range(0, L, CH):
        toks = np.zeros((1, CH), np.int32)
        toks[0, :min(CH, L - c0)] = prompt[c0:c0 + CH]
        last = min(L - 1 - c0, CH - 1)
        jargs = [jnp.asarray(toks), jnp.asarray([c0], jnp.int32),
                 jnp.asarray([last], jnp.int32), jnp.asarray(bt)]
        targs = [_t(toks), _index(c0), _index(last), _t(bt)]
        if ssm_arch:
            jargs.append(jnp.asarray([SLAB], jnp.int32))
            targs.append(_index(SLAB))
        jl, jcache = jchunk(jp, jcache, *jargs)
        tl, cache = chunk(params, cache, *targs)
        _close(tl, jl)
    assert last == {9: 0, 12: 3, 16: CH - 1}[L]
    if ssm_arch:
        for name, pool in cache[0][0]["ssm"].items():
            _close(pool[:, SLAB],
                   np.asarray(jcache[0][0]["ssm"][name])[:, 0, SLAB])
    else:
        live = bt[0, :-(-L // PSZ)]
        for name in ("kp", "vp"):
            _close(cache[0][0]["kv"][name][:, live],
                   np.asarray(jcache[0][0]["kv"][name])[:, 0][:, live])


@pytest.mark.parametrize("tail", [0, 4, 8])
def test_causal_conv_with_a_tensor_tail_matches_jax(tail):
    """The conv's new history cut at a device index (the chunk step's
    ``last_idx``) equals JAX's ``dynamic_slice`` at the same index."""
    rng = np.random.RandomState(tail)
    x = rng.randn(1, 9, 12).astype(np.float32)
    w = rng.randn(12, 4).astype(np.float32)
    st = rng.randn(1, 3, 12).astype(np.float32)
    y, new = ssm.causal_conv(_t(x), _t(w), _t(st), _index(tail))
    wy, wnew = jssm.causal_conv(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(st), jnp.int32(tail))
    _close(y, wy)
    _close(new, wnew)


@pytest.mark.parametrize("q_offset,window", [(0, 0), (40, 0), (96, 0),
                                             (40, 24)])
def test_flash_plain_with_a_tensor_q_offset_matches_pallas(q_offset, window):
    """The flash kernel's plain version (what a CPU tensor runs) with
    ``q_offset`` as a one-element int32 tensor, against Pallas flash in
    interpret mode: queries at ``Skv - Sq``, the Pallas contract, and
    against the same call with a host int elsewhere."""
    rng = np.random.RandomState(q_offset + window)
    H, Sq, Skv, D = 2, 32, 128, 32
    q, k, v = (rng.randn(H, n, D).astype(np.float32) for n in (Sq, Skv, Skv))
    got = ops.flash_attention(_t(q), _t(k), _t(v), window=window,
                              q_offset=_index(q_offset))
    _close(got, ops.flash_attention(_t(q), _t(k), _t(v), window=window,
                                    q_offset=q_offset))
    if q_offset == Skv - Sq:
        _close(got, pl_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, window=window, bq=32, bkv=32,
                             interpret=True))
    # queries at the suffix of a key stream that ends with them
    ks, vs = k[:, :q_offset + Sq], v[:, :q_offset + Sq]
    _close(ops.flash_attention(_t(q), _t(ks), _t(vs), window=window,
                               q_offset=_index(q_offset)),
           pl_flash(jnp.asarray(q), jnp.asarray(ks), jnp.asarray(vs),
                    causal=True, window=window, bq=32, bkv=32,
                    interpret=True))


# ----------------------------------------------------------- greedy path
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_greedy_ids_take_the_first_maximum_inside_the_vocab(dtype):
    """Ties go to the first index, as ``np.argmax`` (JAX's sampler) takes
    them; columns past the vocabulary never win; (B,), (B, Q) and (1,)
    rows, as the decode, verify and chunk steps end."""
    V, Vp = 37, 40
    rng = np.random.RandomState(3)
    lg = rng.randn(4, 3, Vp).astype(np.float32)
    lg[..., V:] = 100.0                       # padding past the vocabulary
    lg[0, 0, [5, 9, 30]] = 50.0               # a three-way tie
    lg[1, 2, [0, 36]] = 50.0
    lg = torch.from_numpy(lg).to(dtype)
    want = lg.float().numpy()[..., :V].argmax(-1)
    for x in (lg, lg[:, 0], lg[:1, 0]):
        got = greedy_ids(x, V)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      want[tuple(slice(None, n) for n in
                                                 x.shape[:-1])]
                                      if x.dim() == 3 else
                                      want[:x.shape[0], 0])
    assert greedy_ids(lg, V)[0, 0] == 5 and greedy_ids(lg, V)[1, 2] == 0


@pytest.mark.parametrize("seed", range(6))
def test_greedy_accept_is_speculative_sample_on_the_ids(seed):
    """Emission over the verify step's ids equals ``speculative_sample``
    (greedy) over its logits, for drafts that match, half match or miss."""
    rng = np.random.RandomState(seed)
    Q, V = 5, 23
    logits = rng.randn(Q, V).astype(np.float32)
    ids = logits.argmax(-1)
    k = rng.randint(0, Q)
    draft = [int(t) for t in ids[:k]]
    if seed % 3 == 1 and k:
        draft[k // 2] = (draft[k // 2] + 1) % V
    elif seed % 3 == 2 and k:
        draft[0] = (draft[0] + 1) % V
    want = speculative_sample(logits, draft, SamplerConfig(), V,
                              np.random.RandomState(0))
    assert greedy_accept(greedy_ids(_t(logits), V).numpy(), draft) == want


# ------------------------------------------------------- staging and graphs
def test_staging_packs_fields_and_alternates_halves():
    """One flat buffer per step kind: fields are contiguous views in
    order; ``send`` copies the filled half (or its first elements) to the
    device buffer and the next fill takes the other half."""
    io = Staging([("tokens", (2, 1)), ("pos", (2,)), ("block_table", (2, 3))],
                 torch.device("cpu"))
    dev = io.split(io.dev[0])
    assert [tuple(t.shape) for t in dev.values()] == [(2, 1), (2,), (2, 3)]
    assert all(t.is_contiguous() for t in dev.values())
    h = io.host()
    f = io.split(h[0])
    f["tokens"][:, 0], f["pos"][:], f["block_table"][:] = [3, 4], [7, 8], 9
    io.send()
    assert dev["tokens"].tolist() == [[3], [4]] and dev["pos"].tolist() == [7, 8]
    assert (dev["block_table"] == 9).all()
    h2 = io.host()
    assert h2 is not h and not np.shares_memory(h2, h)
    io.split(h2[0])["tokens"][:, 0] = [5, 6]
    io.send(1)                                # the first element only
    assert dev["tokens"].tolist() == [[5], [4]]


def test_compile_step_on_cpu_runs_the_step_eagerly():
    """CPU inputs: the step runs as plain PyTorch on every call, over what
    its static inputs hold then; no graph."""
    buf = torch.zeros(3)
    step = graphs.compile_step(lambda x: (x * 2, x.sum()), (buf,))
    assert isinstance(step, graphs.EagerStep) and step.graph is None
    buf.copy_(torch.tensor([1.0, 2.0, 3.0]))
    out, total = step()
    assert out.tolist() == [2.0, 4.0, 6.0] and float(total) == 6.0
    buf.copy_(torch.tensor([4.0, 5.0, 6.0]))
    assert step()[0].tolist() == [8.0, 10.0, 12.0] and step.outputs[0] is not out
    assert step.calls == 2


def test_ops_launch_counts_take_a_replay():
    """``add_launches`` (a replay of a captured call) and
    ``set_launch_counts`` (the counts a capture restores)."""
    saved = ops.launch_counts()
    try:
        ops.reset_launch_counts()
        ops.add_launches({"matmul": 3, "rmsnorm": 1})
        ops.add_launches({"matmul": 3})
        counts = ops.launch_counts()
        assert counts["matmul"] == 6 and counts["rmsnorm"] == 1
        assert sum(counts.values()) == 7
    finally:
        ops.set_launch_counts(saved)
    assert ops.launch_counts() == saved


# --------------------------------------------------------------- the engine
SB, SLOTS, PSZ_E, CHUNK = 64, 3, 8, 16
N_PAGES = 12
REQS = [(5, 9), (8, 7), (9, 12), (16, 5), (17, 10), (33, 8), (40, 20), (1, 6),
        (24, 16)]


def _prompts(vocab, reqs=REQS, seed=0):
    rng = np.random.RandomState(seed)
    return [(rid, rng.randint(2, vocab, L).astype(np.int32), m)
            for rid, (L, m) in enumerate(reqs)]


def _motifs(vocab, n=6, seed=11):
    """Repetitive prompts (``tests/test_torch_spec.py``): drafts land."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(2, vocab, 8).astype(np.int32)
    out = []
    for i in range(n):
        motif = rng.randint(2, vocab, 3 + i % 2).astype(np.int32)
        body = np.tile(motif, 4)[: 8 + 2 * (i % 3)]
        out.append((i, np.concatenate([shared, body]).astype(np.int32), 12))
    return out


# name: (weights, kv dtype, ssm dtype, speculative k, prompts, n_pages,
# slots, seq budget, chunk)
ENGINES = {
    "float-pools": ("tinyllama-42m", "float32", "", 0, "random", N_PAGES,
                    SLOTS, SB, CHUNK),
    "int8-pools": ("tinyllama-42m", "int8", "", 0, "random", N_PAGES, SLOTS,
                   SB, CHUNK),
    "speculative": ("tinyllama-init", "float32", "", 4, "motif", 0, SLOTS, SB,
                    CHUNK),
    "mamba2-slabs": ("mamba2-370m", "float32", "", 0, "short", 0, 2, 32, 8),
    "mamba2-int8-slabs": ("mamba2-370m", "float32", "int8", 0, "short", 0, 2,
                          32, 8),
}


def _reqs(kind, vocab):
    if kind == "motif":
        return _motifs(vocab)
    if kind == "short":
        return _prompts(vocab, [(5, 6), (9, 4), (17, 5), (12, 3)])
    return _prompts(vocab)


@pytest.fixture(scope="module")
def served(weights, mesh1):
    """Every engine of ``ENGINES`` on the port with overlap on and off and
    on the JAX package with overlap on: -> {name: {side: (engine,
    tokens)}}."""
    out = {}
    for name, (arch, kvd, ssmd, k, kind, n_pages, slots, sb, ch) in \
            ENGINES.items():
        jcfg, jp, cfg, params = weights[arch]
        reqs = _reqs(kind, cfg.vocab_size)
        runs = {}
        for side in ("jax", "overlap", "serial"):
            if side == "jax":
                eng = JaxEngine.build_paged(
                    jcfg, JaxPlan(tp=1, kv_cache_dtype=kvd,
                                  ssm_cache_dtype=ssmd), mesh1, slots, sb, jp,
                    page_size=PSZ_E, prefill_chunk=ch, n_pages=n_pages,
                    speculative=k, prefix_cache=False, overlap=True)
                rs = [JaxRequest(rid=r, prompt=p, max_new_tokens=m)
                      for r, p, m in reqs]
            else:
                eng = ServingEngine.build_paged(
                    cfg, ShardingPlan(kv_cache_dtype=kvd, ssm_cache_dtype=ssmd),
                    slots, sb, params, page_size=PSZ_E, prefill_chunk=ch,
                    n_pages=n_pages, speculative=k,
                    overlap=side == "overlap", device="cpu")
                rs = [Request(rid=r, prompt=p, max_new_tokens=m)
                      for r, p, m in reqs]
            for r in rs:
                eng.submit(r)
            eng.run(max_ticks=3000)
            assert all(r.done for r in rs), (name, side)
            runs[side] = (eng, [r.out_tokens for r in rs])
        out[name] = runs
    return out


@pytest.mark.parametrize("name", list(ENGINES))
def test_overlap_tokens_identical_to_serial_and_to_jax_overlap(served, name):
    """The pipelined tick serves the serial loop's greedy tokens and the JAX
    engine's (``overlap=True``) in its schedule: the same ticks, plan-ahead
    ticks and, with speculation, the same drafting counters."""
    runs = served[name]
    (eng, toks), (jeng, jtoks) = runs["overlap"], runs["jax"]
    assert toks == jtoks == runs["serial"][1]
    assert len({t for r in toks for t in r}) > 3       # not degenerate
    st, jst = eng.stats, jeng.stats
    assert (st.ticks, st.prefills, st.plan_ahead_ticks) == \
        (jst.ticks, jst.prefills, jst.plan_ahead_ticks)
    if ENGINES[name][3]:
        assert (st.spec_steps, st.spec_drafted, st.spec_accepted) == \
            (jst.spec_steps, jst.spec_drafted, jst.spec_accepted)
        assert st.spec_accepted > 0


@pytest.mark.parametrize("name", list(ENGINES))
def test_pipeline_counters(served, name):
    """Plan-ahead ticks with overlap, none in the serial loop; no plan is
    ever invalidated (FCFS never preempts); busy time never above the
    ticks' wall time."""
    over, serial = served[name]["overlap"][0].stats, \
        served[name]["serial"][0].stats
    assert over.plan_ahead_ticks > 0 and serial.plan_ahead_ticks == 0
    assert over.plan_invalidations == serial.plan_invalidations == 0
    for st in (over, serial):
        assert 0.0 <= st.device_busy_fraction <= 1.0
        assert st.collect_wait_s <= st.tick_wall_s
    # the serial loop collects every dispatch in its own tick
    assert serial.ticks <= over.ticks


@pytest.mark.parametrize("name", list(ENGINES))
def test_run_and_drain_leave_nothing_in_flight(served, name):
    """After ``run()`` no dispatch is in flight, ``drain()`` finds nothing
    admitted, and every page and slab is back in its pool."""
    for side in ("overlap", "serial"):
        eng = served[name][side][0]
        assert eng._inflight is None
        assert eng.drain() == 0
        assert eng.allocator.n_free == eng.allocator.n_pages - 1
        if eng.has_slabs:
            assert eng.slab_allocator.n_free == eng.n_slabs - 1


def test_drain_mid_run_collects_the_dispatch_first(weights):
    """``run(max_ticks)`` stops with a dispatch in flight; it is collected
    before the caller sees the engine, and ``drain()`` then aborts every
    admission and frees every page."""
    *_, cfg, params = weights["tinyllama-42m"]
    eng = ServingEngine.build_paged(cfg, ShardingPlan(kv_cache_dtype="float32"),
                                    SLOTS, SB, params, page_size=PSZ_E,
                                    prefill_chunk=CHUNK, n_pages=N_PAGES,
                                    device="cpu")
    reqs = [Request(rid=r, prompt=p, max_new_tokens=m)
            for r, p, m in _prompts(cfg.vocab_size)]
    for r in reqs:
        eng.submit(r)
    for _ in range(5):
        eng.tick()
    assert eng._inflight is not None          # tick 5's steps not collected
    emitted = sum(len(r.out_tokens) for r in reqs)
    assert eng.drain() > 0
    assert eng._inflight is None
    assert sum(len(r.out_tokens) for r in reqs) > emitted   # collected first
    assert eng.allocator.n_free == N_PAGES - 1
    assert eng.has_pending()
