"""hymba-1.5b, the hybrid decoder, in the port against the JAX package on
the same numpy inputs and, through ``bridge.params_from_jax``, the same
weights: reduced hymba at 25 q over 5 kv heads (JAX's tp=1 head layout
stores each kv head once per q head: r = 1, 25 kv slots), head_dim 32,
window 16 on layer 1 of 4 (full attention at {0, 2, 3}), 16 SSD heads of
16 with state 16, an odd vocabulary of 515.  Covered: the config and the
layout, the parameter tree (JAX's leaf order, attn before ssm), the
hybrid ``layer_forward`` (attention and SSD heads on one normed input,
fused as ``0.5 * (pa + ps)``) over contiguous lanes and over page pools
with a state slab, model logits over both caches, the engines' greedy
tokens and ticks against JAX's (contiguous; paged with ``overlap`` off
and on; int8 pools and slabs with forced preemptions: the stash holds KV
pages and the slab), and the refusals JAX makes (speculation, the prefix
cache).  Tolerance: fp32 1e-4, the SSD state 1e-3 (the chunked scan sums
in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import ShapeConfig
from repro.core import blocks as jblocks
from repro.core import model as jmodel
from repro.core import steps as jsteps
from repro.core.partition import ShardingPlan as JaxPlan
from repro.core.partition import head_layout as jax_head_layout
from repro.core.partition import model_layout as jax_model_layout
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.core import blocks, model, steps
from repro_torch.core.kvcache import pages_needed
from repro_torch.core.partition import ShardingPlan, head_layout, model_layout
from repro_torch.launch import serve
from repro_torch.serving import Request, ServingEngine

TOL = dict(rtol=1e-4, atol=1e-4)
SSD_TOL = dict(rtol=1e-3, atol=1e-3)
WIN = 16
OVER = dict(dtype="float32", n_heads=25, n_kv_heads=5, head_dim=32,
            sliding_window=WIN, vocab_size=515)
PSZ, CHUNK, SB, SLOTS = 8, 16, 64, 3
# (prompt length, max_new_tokens): lengths on both sides of the window, the
# page and the chunk; more requests than slots
REQS = [(5, 9), (17, 6), (9, 14), (24, 8), (33, 7)]
# the contiguous engine's: two prompt lengths, both past the window (JAX
# compiles its whole-prompt prefill once per length)
REQS_CONTIG = [(17, 9), (33, 6), (17, 14), (33, 8)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def hymba():
    """Reduced hymba in fp32 from JAX's init (one draw for every test),
    carried into the port through the bridge."""
    jcfg = jax_reduced(jax_get_config("hymba-1.5b"), **OVER)
    jp = jmodel.init_params(jcfg, JaxPlan(tp=1, kv_cache_dtype="float32"))
    cfg = reduced(get_config("hymba-1.5b"), **OVER)
    p = params_from_jax(cfg, ShardingPlan(kv_cache_dtype="float32"),
                        _np_tree(jp), device="cpu")
    return jcfg, jp, cfg, p


# ------------------------------------------------------- config, layout
def test_hymba_config_is_jax_s():
    shape = lambda c: (c.family, c.n_layers, c.d_model, c.n_heads,  # noqa: E731
                       c.n_kv_heads, c.head_dim_, c.d_ff, c.vocab_size,
                       c.ssm_state, c.ssm_expand, c.ssm_head_dim, c.ssm_conv,
                       c.sliding_window, c.rope_theta, c.act,
                       c.tie_embeddings, c.source)
    full = get_config("hymba-1.5b")
    assert shape(full) == shape(jax_get_config("hymba-1.5b"))
    assert shape(full)[1:9] == (32, 1600, 25, 5, 64, 5504, 32001, 16)
    specs = full.layer_specs()
    assert {i for i, s in enumerate(specs) if s.attn == "full"} == \
        {0, 16, 31}
    assert all(s.mixer == "hybrid" and s.cache_kinds() == ["kv", "ssm"]
               for s in specs)
    fields = lambda s: (s.mixer, s.attn, s.ffn, s.d_ff)  # noqa: E731
    assert [fields(s) for s in specs] == \
        [fields(s) for s in jax_get_config("hymba-1.5b").layer_specs()]
    cfg = reduced(full, **OVER)
    assert shape(cfg)[:-1] == shape(jax_reduced(
        jax_get_config("hymba-1.5b"), **OVER))[:-1]
    assert [s.attn for s in cfg.layer_specs()] == \
        ["full", "window", "full", "full"]
    model.check_supported(full)


def test_head_layout_stores_each_kv_head_once_per_q_head():
    """tp=1 gives r = 1 over 25 kv slots, each of the 5 kv heads stored 5
    times (JAX's ``head_layout(25, 5, 1)``), and ``_group_q`` reshapes q
    to (B, 25, 1, S, D)."""
    lay = head_layout(25, 5)
    jlay = jax_head_layout(25, 5, 1)
    assert (lay.r, lay.n_kv_loc, lay.hq_loc) == (jlay.r, jlay.n_kv_loc,
                                                 jlay.hq_loc) == (1, 25, 25)
    assert lay.kv_map == jlay.kv_map[0] == tuple(np.repeat(np.arange(5), 5))
    cfg = reduced(get_config("hymba-1.5b"), **OVER)
    mlay = model_layout(cfg, ShardingPlan())
    assert mlay.attn == lay and mlay.ssm.hq_loc == 16
    q = torch.randn(2, 3, 25, 32)
    assert tuple(blocks._group_q(q, mlay).shape) == (2, 25, 1, 3, 32)


def test_parameter_tree_has_jax_s_order_and_shapes(hymba):
    """The bridged tree and the port's own init have JAX's paths, shapes
    and leaf order (``attn`` before ``ssm`` in every layer); ``wk``/``wv``
    hold 25 slots, the 5 kv heads each repeated 5 times, in both."""
    jcfg, jp, cfg, p = hymba
    layer = p["stacks"][0][0]
    assert list(layer) == ["ln1", "attn", "ssm", "ln2", "ffn"]
    assert tuple(layer["attn"]["wk"].shape) == (1, 128, 25, 32)
    assert tuple(layer["ssm"]["in_B"].shape) == (1, 128, 16)
    ours = model.init_params(cfg, ShardingPlan(), device="cpu")
    paths = [(k, tuple(v.shape)) for k, v in model.tree_paths(p)]
    assert paths == [(k, tuple(v.shape)) for k, v in model.tree_paths(ours)]
    jpaths = [".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
              for path, _ in jax.tree_util.tree_leaves_with_path(jp)]
    assert sorted(k for k, _ in paths) == sorted(jpaths)
    jlayer = jp["stacks"][0][0]
    assert list(jlayer) == ["ln1", "attn", "ssm", "ln2", "ffn"]
    for tree in (p, ours):
        for name in ("wk", "wv"):
            w = tree["stacks"][0][1]["attn"][name]
            for g in range(5):
                for j in range(1, 5):
                    torch.testing.assert_close(w[:, :, 5 * g + j],
                                               w[:, :, 5 * g], rtol=0, atol=0)
            assert not torch.equal(w[:, :, 0], w[:, :, 5])


# ------------------------------------------------------ the hybrid layer
def _layer(jp, p, pi):
    return (jax.tree_util.tree_map(lambda a: a[0], jp["stacks"][0][pi]),
            model.tree_map(lambda a: a[0], p["stacks"][0][pi]))


def _ssm_state(rng, cfg, n):
    H = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    P, N, K = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv
    return {"state": 0.5 * rng.randn(n, H, P, N).astype(np.float32),
            "conv_x": rng.randn(n, K - 1, H * P).astype(np.float32),
            "conv_B": rng.randn(n, K - 1, N).astype(np.float32),
            "conv_C": rng.randn(n, K - 1, N).astype(np.float32)}


def _case(cfg, case):
    """One layer's inputs as numpy: x, positions, pos, the cache and the
    pages (paged: kv pools of 9 pages of 8, slab pools of 4 slabs)."""
    rng = np.random.RandomState(len(case))
    G, D, E = 25, 32, cfg.d_model
    if case.startswith("prefill"):       # a whole 21-token prompt
        B, S = 1, 21
        positions = np.arange(S, dtype=np.int32)[None]
    elif case.startswith("chunk"):       # chunk 2 (positions 16-31), last 9
        B, S = 1, CHUNK
        positions = np.arange(16, 32, dtype=np.int32)[None]
    else:                                # three decode rows, one idle
        B, S = 3, 1
        positions = np.asarray([[20], [5], [0]], np.int32)
    x = rng.randn(B, S, E).astype(np.float32)
    pos = positions[:, 0] if S == 1 else None
    if case.endswith("paged"):
        n_pages, n_slabs = 9, 4
        slabs = {k + "p": v for k, v in _ssm_state(rng, cfg, n_slabs).items()}
        cache = {"kv": {"kp": rng.randn(n_pages, G, PSZ, D).astype(np.float32),
                        "vp": rng.randn(n_pages, G, PSZ, D).astype(np.float32)},
                 "ssm": slabs}
        bt = np.asarray([[3, 7, 1, 5], [2, 8, 6, 4], [0, 0, 0, 0]], np.int32)
        pages = {"block_table": bt[:B], "slab_ids": np.asarray([2, 1, 0][:B],
                                                               np.int32)}
        if S > 1:
            pages["last_idx"] = 9
    else:
        W = WIN                          # layer 1's ring: the window
        if case.startswith("prefill"):   # an empty lane
            k = np.zeros((B, G, W, D), np.float32)
            slot_pos = np.full((B, W), -1, np.int32)
            state = {n: np.zeros_like(v)
                     for n, v in _ssm_state(rng, cfg, B).items()}
        else:                            # a lane that has wrapped
            k = rng.randn(B, G, W, D).astype(np.float32)
            slot_pos = np.stack([np.arange(W) + (W if b == 0 else 0)
                                 for b in range(B)]).astype(np.int32)
            slot_pos[1, 6:] = -1         # row 1 holds positions 0-5
            slot_pos[2, 1:] = -1
            state = _ssm_state(rng, cfg, B)
        cache = {"kv": {"k": k, "v": -k, "pos": slot_pos}, "ssm": state}
        pages = None
    return x, positions, pos, cache, pages


@pytest.mark.parametrize("case", ["prefill-contiguous", "decode-contiguous",
                                  "chunk-paged", "decode-paged"])
def test_hybrid_layer_forward_matches_jax(hymba, mesh1, case):
    """The window layer (1 of 4) on one input through both sides: the
    layer's output (``x + delta`` in the port), the KV lane or pools and the
    SSD lane or slabs it leaves.  A whole prompt past the window over an
    empty lane, a decode step over wrapped and partial lanes, a prefill
    chunk at position 16 whose rows past 9 are padding over a shuffled
    block table, a decode step with an idle row on scratch page 0."""
    jcfg, jp, cfg, p = hymba
    jplan = JaxPlan(tp=1, kv_cache_dtype="float32")
    plan = ShardingPlan(kv_cache_dtype="float32")
    jsteps.prepare_ledger(mesh1)
    jpl, pl = _layer(jp, p, 1)
    spec = cfg.layer_specs()[1]
    assert spec.attn == "window" and spec.mixer == "hybrid"
    x, positions, pos, cache, pages = _case(cfg, case)
    mode = "decode" if case.startswith("decode") else "prefill"
    tcache = {kind: {n: _t(v.copy()) for n, v in leaves.items()}
              for kind, leaves in cache.items()}
    tpages = None
    jpages = None
    if pages is not None:
        tpages = {k: _t(v) for k, v in pages.items() if k != "last_idx"}
        jpages = {k: jnp.asarray(v) for k, v in pages.items()
                  if k != "last_idx"}
        if "last_idx" in pages:
            tpages["last_idx"] = torch.tensor([pages["last_idx"]],
                                              dtype=torch.int32)
            tpages["chunk_start"] = _t(positions[0, :1])
            jpages["last_idx"] = jnp.asarray(pages["last_idx"], jnp.int32)
    (tx, delta), tnew = blocks.layer_forward(
        _t(x), pl, tcache, cfg, plan, model_layout(cfg, plan), spec, mode,
        _t(positions), None if pos is None else _t(pos), tpages)
    jlay = jax_model_layout(jcfg, jplan)
    jx, jnew = jax.jit(
        lambda x, pl, c, positions, pos, pages: jblocks.layer_forward(
            x, pl, c, jcfg, jplan, jlay, spec, mode, positions, pos,
            pages=None if pages is None else {**pages, "page_size": PSZ}))(
        jnp.asarray(x), jpl,
        {kind: {n: jnp.asarray(v) for n, v in leaves.items()}
         for kind, leaves in cache.items()},
        jnp.asarray(positions), None if pos is None else jnp.asarray(pos),
        jpages)
    _close(tx + delta, jx)
    for kind, leaves in tnew.items():
        for name, t in leaves.items():
            want = np.asarray(jnew[kind][name])
            if t.dtype == torch.int32:
                np.testing.assert_array_equal(t.numpy(), want)
            else:
                _close(t, want, SSD_TOL if "state" in name else TOL)


# ------------------------------------------------------------ the model
def test_contiguous_prefill_and_decode_logits_match_jax(hymba, mesh1):
    """A 21-token prompt (past the window) prefilled into a batch-1 lane,
    spliced into slot 1 of 2, then three decode steps: logits and lanes
    (the window layer's ring of 16) after every call."""
    jcfg, jp, cfg, p = hymba
    jplan = JaxPlan(tp=1, kv_cache_dtype="float32")
    plan = ShardingPlan(kv_cache_dtype="float32")
    B, L = 2, 21
    jdec, _, _ = jsteps.make_decode_step(jcfg, jplan, mesh1,
                                         ShapeConfig("s", "decode", SB, B))
    jpre, _, _ = jsteps.make_prefill_step(jcfg, jplan, mesh1,
                                          ShapeConfig("p", "decode", SB, 1))
    jdec, jpre = jax.jit(jdec), jax.jit(jpre)
    dec = steps.make_decode_step(cfg, plan, B, SB)
    pre = steps.make_prefill_step(cfg, plan, SB)
    prompt = np.random.RandomState(L).randint(2, cfg.vocab_size, (1, L))
    jl, jlane = jpre(jp, jnp.asarray(prompt, jnp.int32),
                     jsteps.zero_cache_for(jcfg, jplan, mesh1, 1, SB))
    lane = steps.zero_cache_for(cfg, plan, 1, SB, "cpu")
    assert [e["kv"]["k"].shape[3] for e in lane[0]] == [SB, WIN, SB, SB]
    tl, lane = pre(p, _t(prompt).long(), lane)
    _close(tl, jl)
    jcache = jax.tree_util.tree_map(
        lambda big, ln: big.at[:, 1:2].set(ln[:, 0:1]),
        jsteps.zero_cache_for(jcfg, jplan, mesh1, B, SB), jlane)
    cache = steps.zero_cache_for(cfg, plan, B, SB, "cpu")
    for group, lgroup in zip(cache, lane, strict=True):
        for entry, lentry in zip(group, lgroup, strict=True):
            for kind, leaves in entry.items():
                for name, t in leaves.items():
                    t[:, 1:2].copy_(lentry[kind][name])
    tok, pos = int(np.argmax(np.asarray(jl[0]))), L
    for _ in range(3):
        toks = np.asarray([[0], [tok]], np.int32)
        pos_v = np.asarray([0, pos], np.int32)
        jl, jcache = jdec(jp, jcache, jnp.asarray(toks), jnp.asarray(pos_v))
        tl, cache = dec(p, cache, _t(toks).long(), _t(pos_v))
        _close(tl[1:], jl[1:])
        for group, jgroup in zip(cache, jcache, strict=True):
            for entry, jentry in zip(group, jgroup, strict=True):
                for kind, leaves in entry.items():
                    for name, t in leaves.items():
                        want = np.asarray(jentry[kind][name])[:, 1:]
                        if t.dtype == torch.int32:
                            np.testing.assert_array_equal(t[:, 1:].numpy(),
                                                          want)
                        else:
                            _close(t[:, 1:], want,
                                   SSD_TOL if name == "state" else TOL)
        tok, pos = int(np.argmax(np.asarray(jl[1]))), pos + 1


def test_paged_chunks_then_decode_logits_match_jax(hymba, mesh1):
    """forward_prefill_chunk over a 37-token prompt (three chunks, the
    later ones past the window), then four decode steps with an idle row
    on scratch page 0 and scratch slab 0, float32 pools and slabs (int8
    pools and slabs: the forced-preemption test's tokens)."""
    jcfg, jp, cfg, p = hymba
    jplan = JaxPlan(tp=1, kv_cache_dtype="float32")
    plan = ShardingPlan(kv_cache_dtype="float32")
    n_max, n_pages, n_slabs = 6, 13, 3
    jchunk, _, _ = jsteps.make_prefill_chunk_step(
        jcfg, jplan, mesh1, CHUNK, n_pages, PSZ, n_max, n_slabs=n_slabs)
    jdec, _, _ = jsteps.make_paged_decode_step(
        jcfg, jplan, mesh1, 2, n_pages, PSZ, n_max, n_slabs=n_slabs)
    jchunk, jdec = jax.jit(jchunk), jax.jit(jdec)
    jcache = jsteps.zero_paged_cache_for(jcfg, jplan, mesh1, n_pages, PSZ,
                                         n_slabs=n_slabs)
    chunk = steps.make_prefill_chunk_step(cfg, plan, CHUNK, n_max)
    dec = steps.make_paged_decode_step(cfg, plan, 2, n_max)
    cache = steps.zero_paged_cache_for(cfg, plan, n_pages, PSZ, "cpu",
                                       n_slabs)
    prompt = np.random.RandomState(0).randint(2, cfg.vocab_size, 37)
    bt_row = np.asarray([7, 2, 11, 4, 9, 1], np.int32)
    L = len(prompt)
    for c0 in range(0, L, CHUNK):
        toks = np.zeros((1, CHUNK), np.int32)
        toks[0, :min(CHUNK, L - c0)] = prompt[c0:c0 + CHUNK]
        last = min(L - 1 - c0, CHUNK - 1)
        jl, jcache = jchunk(jp, jcache, jnp.asarray(toks),
                            jnp.asarray([c0], jnp.int32),
                            jnp.asarray([last], jnp.int32),
                            jnp.asarray(bt_row[None]),
                            jnp.asarray([2], jnp.int32))
        tl, cache = chunk(p, cache, _t(toks).long(), c0, last,
                          _t(bt_row[None]), torch.tensor([2], dtype=torch.int32))
        _close(tl, jl)
    bt = np.stack([bt_row, np.zeros(n_max, np.int32)])
    tok, pos = int(np.argmax(np.asarray(jl[0]))), L
    for _ in range(4):
        toks = np.asarray([[tok], [0]], np.int32)
        pos_v = np.asarray([pos, 0], np.int32)
        sid = np.asarray([2, 0], np.int32)
        jl, jcache = jdec(jp, jcache, jnp.asarray(toks), jnp.asarray(pos_v),
                          jnp.asarray(bt), jnp.asarray(sid))
        tl, cache = dec(p, cache, _t(toks).long(), _t(pos_v), _t(bt), _t(sid))
        _close(tl[0:1], jl[0:1])
        tok, pos = int(np.argmax(np.asarray(jl[0]))), pos + 1


# ------------------------------------------------------------- engines
def _prompts(vocab, reqs=REQS):
    rng = np.random.RandomState(3)
    return [(rng.randint(2, vocab, L).astype(np.int32), m) for L, m in reqs]


def _serve(eng, cls, prompts):
    reqs = [cls(rid=i, prompt=pr.copy(), max_new_tokens=m)
            for i, (pr, m) in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_ticks=2000)
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs]


def _leak_free(eng):
    assert eng.drain() == 0
    assert eng.allocator.n_free == eng.allocator.n_pages - 1
    assert eng.slab_allocator.n_free == eng.n_slabs - 1


@pytest.mark.parametrize("overlap", [False, True], ids=["serial", "overlap"])
def test_paged_engine_matches_jax(hymba, mesh1, overlap):
    """Greedy tokens and ticks against JAX's paged engine (no prefix
    cache), float32 pools and slabs; requests run past the window; the
    pools and slabs are free after ``drain()``."""
    jcfg, jp, cfg, p = hymba
    prompts = _prompts(cfg.vocab_size)
    assert max(len(pr) + m for pr, m in prompts) > 2 * WIN
    kw = dict(page_size=PSZ, prefill_chunk=CHUNK, overlap=overlap)
    jeng = JaxEngine.build_paged(jcfg, JaxPlan(tp=1, kv_cache_dtype="float32"),
                                 mesh1, SLOTS, SB, jp, prefix_cache=False, **kw)
    want = _serve(jeng, JaxRequest, prompts)
    eng = ServingEngine.build_paged(cfg, ShardingPlan(kv_cache_dtype="float32"),
                                    SLOTS, SB, p, device="cpu", **kw)
    got = _serve(eng, Request, prompts)
    assert got == want
    assert len({t for r in got for t in r}) > 10            # not degenerate
    assert (eng.stats.ticks, eng.stats.plan_ahead_ticks) == \
        (jeng.stats.ticks, jeng.stats.plan_ahead_ticks)
    assert eng.stats.slab_restores == 0 and eng.slab_allocator.total_allocated \
        == len(prompts)
    _leak_free(eng)


def test_contiguous_engine_matches_jax(hymba, mesh1):
    """The contiguous engine (KV lanes with a ring of 16 on the window
    layer, an SSD lane per slot, each prompt prefilled whole): greedy
    tokens, ticks and prefills against JAX's contiguous engine, and the
    tokens equal to the paged engine's."""
    jcfg, jp, cfg, p = hymba
    jplan = JaxPlan(tp=1, kv_cache_dtype="float32")
    plan = ShardingPlan(kv_cache_dtype="float32")
    dec, _, _ = jsteps.make_decode_step(jcfg, jplan, mesh1,
                                        ShapeConfig("s", "decode", SB, SLOTS))
    pre, _, _ = jsteps.make_prefill_step(jcfg, jplan, mesh1,
                                         ShapeConfig("p", "decode", SB, 1))
    jeng = JaxEngine(jcfg, jplan, mesh1, SLOTS, SB, jp, jax.jit(pre),
                     jax.jit(dec))
    prompts = _prompts(cfg.vocab_size, REQS_CONTIG)
    want = _serve(jeng, JaxRequest, prompts)
    eng = ServingEngine(cfg, plan, SLOTS, SB, p, device="cpu")
    got = _serve(eng, Request, prompts)
    assert got == want
    assert (eng.stats.ticks, eng.stats.prefills) == \
        (jeng.stats.ticks, jeng.stats.prefills)
    paged = ServingEngine.build_paged(cfg, plan, SLOTS, SB, p, page_size=PSZ,
                                      prefill_chunk=CHUNK, device="cpu")
    assert _serve(paged, Request, prompts) == got


# the JAX package's forced-preemption scenario (tests/test_paged_cache.py::
# test_ssm_int8_forced_preemption_identity): 2 slots, budget 32, pages and
# chunks of 8
PRE = [(13, 8), (9, 6)]


def _forced(eng, cls, prompts, pts, garbage=False):
    """Serve ``prompts`` preempting the first live slot before each tick in
    ``pts``.  ``garbage``: right after each preemption every free page of
    every KV pool and every free slab is overwritten with random values,
    so a resumed request reads only what its restore wrote."""
    reqs = [cls(rid=i, prompt=pr.copy(), max_new_tokens=m)
            for i, (pr, m) in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    tick = 0
    while eng.has_pending() or any(a is not None for a in eng.admissions):
        if tick in pts:
            eng.preempt(next(b for b in range(eng.B)
                             if eng.admissions[b] is not None))
            if garbage:
                _scribble(eng)
        eng.tick()
        tick += 1
    eng.run()
    assert all(r.done for r in reqs)
    st = eng.stats
    return ([r.out_tokens for r in reqs], st.slab_restores, st.preemptions,
            st.ticks, st.prefill_tokens_skipped)


def _scribble(eng):
    g = torch.Generator().manual_seed(eng.stats.preemptions)
    free_pages = torch.tensor(eng.allocator._free, dtype=torch.long)
    free_slabs = torch.tensor(eng.slab_allocator._free, dtype=torch.long)
    for kind, ids in (("kv", free_pages), ("ssm", free_slabs)):
        for pool in eng._kind_pools(kind):
            junk = torch.randn((pool.shape[0], len(ids)) + pool.shape[2:],
                               generator=g)
            if pool.dtype == torch.int8:
                junk = (junk * 40).clamp(-127, 127)
            pool[:, ids] = junk.to(pool.dtype)


@pytest.fixture(scope="module")
def preempted(hymba, mesh1):
    """JAX's int8-pool, int8-slab engine with preemptions forced at ticks
    1, 2 and 3 (mid-prefill and mid-decode), and the port's float32
    engine without preemptions: the oracle."""
    jcfg, jp, cfg, p = hymba
    prompts = [(np.random.RandomState(3).randint(2, cfg.vocab_size, L)
                .astype(np.int32), m) for L, m in PRE]
    kw = dict(page_size=8, prefill_chunk=8, overlap=False)
    jeng = JaxEngine.build_paged(
        jcfg, JaxPlan(tp=1, kv_cache_dtype="int8", ssm_cache_dtype="int8"),
        mesh1, 2, 32, jp, **kw)
    fp = ServingEngine.build_paged(cfg, ShardingPlan(kv_cache_dtype="float32"),
                                   2, 32, p, device="cpu", **kw)
    return prompts, {"i8": _forced(jeng, JaxRequest, prompts, {1, 2, 3}),
                     "fp": _forced(fp, Request, prompts, set())}


@pytest.mark.parametrize("pts", [{1}, {3}, {1, 2, 3}],
                         ids=["mid-prefill", "mid-decode", "three"])
def test_int8_forced_preemption_restores_kv_and_slab(hymba, preempted, pts):
    """int8 pools and slabs with ``preempt(b)`` forced: the stash holds the
    slab and the KV pages covering the resident tokens, so the tokens equal
    the fp oracle's and JAX's, with one restore per preemption and JAX's
    ticks and skipped prefill tokens (the three-preemption run); free pages
    and slabs scribbled over after each preemption change nothing; pools
    and slabs free after ``drain()``."""
    _, _, cfg, p = hymba
    prompts, jax_out = preempted
    plan = ShardingPlan(kv_cache_dtype="int8", ssm_cache_dtype="int8")

    def engine():
        return ServingEngine.build_paged(cfg, plan, 2, 32, p, page_size=8,
                                         prefill_chunk=8, overlap=False,
                                         device="cpu")

    eng = engine()
    got = _forced(eng, Request, prompts, pts)
    assert got[0] == jax_out["fp"][0]
    assert got[1] == got[2] == len(pts)
    if pts == {1, 2, 3}:
        assert got == jax_out["i8"]
    assert got[4] > 0
    _leak_free(eng)
    eng = engine()
    assert _forced(eng, Request, prompts, pts, garbage=True) == got
    _leak_free(eng)


def test_stash_holds_the_resident_kv_pages_and_the_slab(hymba):
    """A slot preempted mid-decode stashes ``pages_needed(n, 8)`` pages of
    every KV leaf (payload and int8 scale rows, 4 leaves in each of 4
    layers) beside every slab leaf (5 in each layer: state, scales, conv
    tails); ``drain()`` drops the stash."""
    _, _, cfg, p = hymba
    plan = ShardingPlan(kv_cache_dtype="int8", ssm_cache_dtype="int8")
    eng = ServingEngine.build_paged(cfg, plan, 2, 32, p, page_size=8,
                                    prefill_chunk=8, overlap=False,
                                    device="cpu")
    eng.submit(Request(rid=0, prompt=np.arange(2, 15, dtype=np.int32),
                       max_new_tokens=8))
    for _ in range(4):
        eng.tick()
    n = int(eng.pos[0])
    assert eng.slot_state[0] == "decode" and n > 13
    eng.preempt(0)
    st = eng._stash[0]
    k = pages_needed(n, 8)
    assert (st["n"], st["n_kv_pages"], len(st["kv"]), len(st["ssm"])) == \
        (n, k, 16, 20)
    assert all(h.shape[1] == k for h in st["kv"])
    assert {h.dtype for h in st["kv"]} == {torch.int8, torch.float32}
    eng.drain()
    assert not eng._stash


# ----------------------------------------------------------- refusals
def test_speculation_and_prefix_cache_are_refused_as_in_jax(hymba, mesh1,
                                                            capsys):
    jcfg, jp, cfg, p = hymba
    plan = ShardingPlan(kv_cache_dtype="float32")
    jplan = JaxPlan(tp=1, kv_cache_dtype="float32")
    for kw, what in ((dict(speculative=2), "speculative decoding is "
                                           "unsupported"),
                     (dict(prefix_cache=True), "prefix_cache=True is "
                                               "unsupported")):
        with pytest.raises(ValueError, match=what):
            ServingEngine.build_paged(cfg, plan, 2, SB, p, page_size=PSZ,
                                      prefill_chunk=CHUNK, device="cpu", **kw)
        with pytest.raises(ValueError, match=what):
            JaxEngine.build_paged(jcfg, jplan, mesh1, 2, SB, jp,
                                  page_size=PSZ, prefill_chunk=CHUNK, **kw)
    with pytest.raises(ValueError, match="attention-only"):
        steps.make_verify_step(cfg, plan, 2, 3, 4)
    with pytest.raises(SystemExit) as e:
        serve.parse_args(["--arch", "hymba-1.5b", "--speculative", "2"])
    assert e.value.code == 2
    assert "SSM recurrences" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    ["--paged"], [], ["--paged", "--kv-dtype", "int8", "--policy",
                      "priority", "--preemption", "--high-priority-every",
                      "2"]], ids=["paged", "contiguous", "int8-priority"])
def test_launcher_serves_hymba_smoke_on_cpu(flags, capsys):
    serve.main(["--arch", "hymba-1.5b", "--smoke", "--device", "cpu",
                "--kv-dtype", "fp32", "--requests", "3", "--slots", "2",
                "--seq-budget", "128", "--page-size", "8",
                "--prefill-chunk", "16", "--prompt-len", "80",
                "--max-new", "4", *flags])
    out = capsys.readouterr().out
    assert "arch=hymba-1.5b-smoke" in out and "tokens=12" in out
    assert ("engine=paged" in out) == ("--paged" in flags)
    assert ("ssm_slabs: slabs=2" in out) == ("--paged" in flags)
