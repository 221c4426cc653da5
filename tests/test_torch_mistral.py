"""mistral-large-123b's untied LM head in the port, against the JAX package
on the same numpy inputs: the config copies (mistral-large-123b and
pixtral-12b), ``lm_head.w`` through ``bridge.params_from_jax``, the
logits of the whole-prompt prefill, the prefill chunk, the paged decode and
the verify step, and the engines' greedy tokens, at ``reduced()`` (2
layers, d_model 128, 4 q heads over 2 kv heads: group 2) and at a variant
with 12 q heads over 1 kv head (mistral's group of 12).  pixtral-12b is
refused for JAX's reason (its vision frontend).  On the card the verify
kernel takes R x Q <= 16 query rows of a kv slot, so mistral (R 12) is
refused speculation when an engine is built there; the CPU path takes any
k, as the Pallas kernel does, and is held against JAX at group 12.
Tolerances: fp32 1e-4 (``tests/test_kernels.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import ShapeConfig
from repro.core import model as jmodel
from repro.core import steps as jsteps
from repro.core.kvcache import paged_cache_supported
from repro.core.partition import ShardingPlan as JaxPlan
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.core import model, steps
from repro_torch.core.partition import ShardingPlan, model_layout
from repro_torch.kernels import decode_attention as k_decode
from repro_torch.kernels import flash_attention as k_flash
from repro_torch.kernels import matmul as k_matmul
from repro_torch.launch import serve
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving import engine as engine_mod

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "mistral-large-123b"
# the reduced config (4 q over 2 kv heads: group 2) and mistral's group of
# 12 (12 q heads over 1 kv head) at the reduced widths
VARIANTS = {"g2": {}, "g12": dict(n_heads=12, n_kv_heads=1)}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _shape(c):
    return {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}


@pytest.fixture(scope="module")
def mistral():
    """Each variant in fp32 from JAX's init, weights x10 (greedy decoding
    does not collapse onto one token; at x25 the group-12 verify logits
    of JAX's and the port's fp32 summation orders differ past 1e-4), and
    the port's copy through the bridge."""
    out = {}
    for name, over in VARIANTS.items():
        jcfg = jax_reduced(jax_get_config(ARCH), dtype="float32", **over)
        jp = jax.tree_util.tree_map(
            lambda a: a * 10,
            jmodel.init_params(jcfg, JaxPlan(tp=1, kv_cache_dtype="float32")))
        cfg = reduced(get_config(ARCH), dtype="float32", **over)
        plan = ShardingPlan(kv_cache_dtype="float32")
        out[name] = (jcfg, jp, cfg, params_from_jax(cfg, plan, _np_tree(jp),
                                                     device="cpu"))
    return out


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", [ARCH, "pixtral-12b"])
def test_configs_are_copies_of_jax_s(arch):
    """Every field the port's config has equals JAX's, full and reduced."""
    for ours, theirs in ((get_config(arch), jax_get_config(arch)),
                         (reduced(get_config(arch)),
                          jax_reduced(jax_get_config(arch)))):
        want = _shape(theirs)
        assert {k: want[k] for k in _shape(ours)} == _shape(ours)
        assert not ours.tie_embeddings


def test_mistral_head_layout_is_twelve_q_heads_a_kv_slot():
    """JAX's tp=1 rule gives r = 12 over 8 kv slots at full width, and
    the g12 variant keeps the group."""
    full = model_layout(get_config(ARCH), ShardingPlan()).attn
    assert (full.r, full.n_kv_loc, full.kv_map) == (12, 8, tuple(range(8)))
    g12 = model_layout(reduced(get_config(ARCH), **VARIANTS["g12"]),
                       ShardingPlan()).attn
    assert (g12.r, g12.n_kv_loc) == (12, 1)


# ----------------------------------------------------------------- params
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_params_from_jax_maps_the_untied_head(mistral, variant):
    jcfg, jp, cfg, p = mistral[variant]
    V, E = cfg.vocab_size, cfg.d_model
    assert tuple(np.asarray(jp["lm_head"]["w"]).shape) == (1, V, E)
    assert tuple(p["lm_head"]["w"].shape) == (V, E)
    np.testing.assert_array_equal(p["lm_head"]["w"].numpy(),
                                  np.asarray(jp["lm_head"]["w"])[0])
    assert not torch.equal(p["lm_head"]["w"], p["embed"]["table"])
    ours = model.init_params(cfg, ShardingPlan(), device="cpu")
    assert [(k, tuple(v.shape)) for k, v in model.tree_paths(ours)] == \
        [(k, tuple(v.shape)) for k, v in model.tree_paths(p)]
    assert list(ours)[-1] == "lm_head"          # drawn after the stack


def test_params_from_jax_refuses_a_tree_whose_head_differs(mistral):
    jcfg, jp, cfg, _ = mistral["g2"]
    tree = _np_tree(jp)
    headless = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(ValueError, match=r"tree keys differ: port \['embed', "
                                         r"'final_norm', 'lm_head'"):
        params_from_jax(cfg, ShardingPlan(), headless, device="cpu")
    tied = dataclasses.replace(cfg, tie_embeddings=True)
    with pytest.raises(ValueError, match=r"vs JAX \['embed', 'final_norm', "
                                         r"'lm_head'"):
        params_from_jax(tied, ShardingPlan(), tree, device="cpu")


def test_final_logits_read_the_untied_head(mistral):
    _, _, cfg, p = mistral["g2"]
    x = torch.randn(2, 3, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    got = model.final_logits(p, x)
    np.testing.assert_allclose(got.numpy(), (x @ p["lm_head"]["w"].T).numpy(),
                               rtol=1e-5, atol=1e-5)
    tied = {k: v for k, v in p.items() if k != "lm_head"}
    np.testing.assert_allclose(model.final_logits(tied, x).numpy(),
                               (x @ p["embed"]["table"].T).numpy(),
                               rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------- logits
SB, PSZ, CHUNK, N_MAX, N_PAGES = 64, 8, 16, 6, 13


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_whole_prompt_prefill_then_decode_logits_match_jax(mistral, mesh1,
                                                           variant):
    """The contiguous engine's steps: a 19-token prompt, then two decode
    steps over its lane."""
    jcfg, jp, cfg, p = mistral[variant]
    jplan, plan = JaxPlan(tp=1, kv_cache_dtype="float32"), \
        ShardingPlan(kv_cache_dtype="float32")
    jpre, _, _ = jsteps.make_prefill_step(jcfg, jplan, mesh1,
                                          ShapeConfig("p", "decode", SB, 1))
    jdec, _, _ = jsteps.make_decode_step(jcfg, jplan, mesh1,
                                         ShapeConfig("s", "decode", SB, 1))
    jpre, jdec = jax.jit(jpre), jax.jit(jdec)
    pre = steps.make_prefill_step(cfg, plan, SB)
    dec = steps.make_decode_step(cfg, plan, 1, SB)
    prompt = np.random.RandomState(1).randint(2, cfg.vocab_size, (1, 19))
    jl, jlane = jpre(jp, jnp.asarray(prompt, jnp.int32),
                     jsteps.zero_cache_for(jcfg, jplan, mesh1, 1, SB))
    tl, lane = pre(p, torch.from_numpy(prompt).long(),
                   steps.zero_cache_for(cfg, plan, 1, SB, "cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    tok, pos = int(np.argmax(np.asarray(jl)[0])), 19
    for _ in range(2):
        jl, jlane = jdec(jp, jlane, jnp.asarray([[tok]], jnp.int32),
                         jnp.asarray([pos], jnp.int32))
        tl, lane = dec(p, lane, torch.tensor([[tok]]),
                       torch.tensor([pos], dtype=torch.int32))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok, pos = int(np.argmax(np.asarray(jl)[0])), pos + 1


def _prefill_paged(jchunk, jp, jcache, chunk, p, cache, prompt, bt_row):
    L = len(prompt)
    for c0 in range(0, L, CHUNK):
        toks = np.zeros((1, CHUNK), np.int32)
        toks[0, :min(CHUNK, L - c0)] = prompt[c0:c0 + CHUNK]
        last = min(L - 1 - c0, CHUNK - 1)
        jl, jcache = jchunk(jp, jcache, jnp.asarray(toks),
                            jnp.asarray([c0], jnp.int32),
                            jnp.asarray([last], jnp.int32),
                            jnp.asarray(bt_row[None]))
        tl, cache = chunk(p, cache, torch.from_numpy(toks).long(), c0, last,
                          torch.from_numpy(bt_row[None]))
    return jl, jcache, tl, cache


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_chunks_then_decode_logits_match_jax(mistral, mesh1,
                                                     variant):
    """forward_prefill_chunk over a 21-token prompt (two chunks), then
    three paged decode steps (an idle lane on the scratch page)."""
    jcfg, jp, cfg, p = mistral[variant]
    jplan, plan = JaxPlan(tp=1, kv_cache_dtype="float32"), \
        ShardingPlan(kv_cache_dtype="float32")
    jchunk, _, _ = jsteps.make_prefill_chunk_step(jcfg, jplan, mesh1, CHUNK,
                                                  N_PAGES, PSZ, N_MAX)
    jdec, _, _ = jsteps.make_paged_decode_step(jcfg, jplan, mesh1, 2, N_PAGES,
                                               PSZ, N_MAX)
    jchunk, jdec = jax.jit(jchunk), jax.jit(jdec)
    chunk = steps.make_prefill_chunk_step(cfg, plan, CHUNK, N_MAX)
    dec = steps.make_paged_decode_step(cfg, plan, 2, N_MAX)
    prompt = np.random.RandomState(0).randint(2, cfg.vocab_size, 21)
    bt_row = np.asarray([7, 2, 11, 4, 9, 1], np.int32)
    jl, jcache, tl, cache = _prefill_paged(
        jchunk, jp, jsteps.zero_paged_cache_for(jcfg, jplan, mesh1, N_PAGES,
                                                PSZ),
        chunk, p, steps.zero_paged_cache_for(cfg, plan, N_PAGES, PSZ, "cpu"),
        prompt, bt_row)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    bt = np.stack([bt_row, np.zeros(N_MAX, np.int32)])
    tok, pos = int(np.argmax(np.asarray(jl[0]))), len(prompt)
    for _ in range(3):
        toks = np.asarray([[tok], [0]], np.int32)
        pos_v = np.asarray([pos, 0], np.int32)
        jl, jcache = jdec(jp, jcache, jnp.asarray(toks), jnp.asarray(pos_v),
                          jnp.asarray(bt))
        tl, cache = dec(p, cache, torch.from_numpy(toks).long(),
                        torch.from_numpy(pos_v), torch.from_numpy(bt))
        np.testing.assert_allclose(tl[0:1].numpy(), np.asarray(jl[0:1]),
                                   **TOL)
        tok, pos = int(np.argmax(np.asarray(jl[0]))), pos + 1


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_verify_logits_match_jax(mistral, mesh1, variant):
    """After a 21-token prefill, one verify step of Q = 4 columns (3
    drafts) over two rows, the second with 2 live columns: every live
    column's logits, at group 12 too (the CPU path takes R x Q = 48)."""
    jcfg, jp, cfg, p = mistral[variant]
    jplan, plan = JaxPlan(tp=1, kv_cache_dtype="float32"), \
        ShardingPlan(kv_cache_dtype="float32")
    Q = 4
    jchunk, _, _ = jsteps.make_prefill_chunk_step(jcfg, jplan, mesh1, CHUNK,
                                                  N_PAGES, PSZ, N_MAX)
    jver, _, _ = jsteps.make_verify_step(jcfg, jplan, mesh1, 2, Q, N_PAGES,
                                         PSZ, N_MAX)
    jchunk, jver = jax.jit(jchunk), jax.jit(jver)
    chunk = steps.make_prefill_chunk_step(cfg, plan, CHUNK, N_MAX)
    ver = steps.make_verify_step(cfg, plan, 2, Q, N_MAX)
    rng = np.random.RandomState(4)
    bt = np.asarray([[7, 2, 11, 4, 9, 1], [3, 5, 6, 8, 10, 12]], np.int32)
    jcache = jsteps.zero_paged_cache_for(jcfg, jplan, mesh1, N_PAGES, PSZ)
    cache = steps.zero_paged_cache_for(cfg, plan, N_PAGES, PSZ, "cpu")
    lens = (21, 13)
    for row, L in enumerate(lens):
        prompt = rng.randint(2, cfg.vocab_size, L)
        _, jcache, _, cache = _prefill_paged(jchunk, jp, jcache, chunk, p,
                                             cache, prompt, bt[row])
    toks = rng.randint(2, cfg.vocab_size, (2, Q)).astype(np.int32)
    pos = np.asarray(lens, np.int32)
    qlen = np.asarray([Q, 2], np.int32)
    jl, _ = jver(jp, jcache, jnp.asarray(toks), jnp.asarray(pos),
                 jnp.asarray(qlen), jnp.asarray(bt))
    tl, _ = ver(p, cache, torch.from_numpy(toks).long(),
                torch.from_numpy(pos), torch.from_numpy(qlen),
                torch.from_numpy(bt))
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl[0].numpy(), jl[0], **TOL)
    np.testing.assert_allclose(tl[1, :2].numpy(), jl[1, :2], **TOL)


# ---------------------------------------------------------------- engines
SLOTS = 3
# (prompt length, max_new_tokens): both sides of the page and the chunk,
# more requests than slots
REQS = [(5, 9), (17, 6), (9, 12), (24, 8), (33, 7)]


def _prompts(vocab, motif=False):
    rng = np.random.RandomState(3)
    if not motif:
        return [(rng.randint(2, vocab, L).astype(np.int32), m)
                for L, m in REQS]
    shared = rng.randint(2, vocab, 8)
    return [(np.concatenate([shared, np.tile(rng.randint(2, vocab, 3 + i % 2),
                                             4)[:6 + i]]).astype(np.int32), m)
            for i, (_, m) in enumerate(REQS)]


def _serve(eng, cls, prompts):
    reqs = [cls(rid=i, prompt=p.copy(), max_new_tokens=m)
            for i, (p, m) in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_ticks=2000)
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs]


@pytest.mark.parametrize("overlap", [False, True], ids=["serial", "overlap"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_paged_engine_matches_jax(mistral, mesh1, variant, overlap):
    """Greedy tokens and ticks against JAX's paged engine, the serial loop
    and the pipelined tick on both sides."""
    jcfg, jp, cfg, p = mistral[variant]
    kw = dict(page_size=PSZ, prefill_chunk=CHUNK, overlap=overlap)
    jeng = JaxEngine.build_paged(jcfg, JaxPlan(tp=1, kv_cache_dtype="float32"),
                                 mesh1, SLOTS, SB, jp, **kw)
    prompts = _prompts(cfg.vocab_size)
    want = _serve(jeng, JaxRequest, prompts)
    eng = ServingEngine.build_paged(cfg, ShardingPlan(kv_cache_dtype="float32"),
                                    SLOTS, SB, p, device="cpu", **kw)
    got = _serve(eng, Request, prompts)
    assert got == want
    assert len({t for r in got for t in r}) > 10            # not degenerate
    assert (eng.stats.ticks, eng.stats.plan_ahead_ticks) == \
        (jeng.stats.ticks, jeng.stats.plan_ahead_ticks)
    assert eng.drain() == 0
    assert eng.allocator.n_free == eng.allocator.n_pages - 1


def test_cpu_speculation_at_group_12_matches_jax(mistral, mesh1):
    """speculative=3 at mistral's group of 12 (R x Q = 48 query rows of a
    kv slot, past the card kernel's 16): the CPU path against JAX's engine
    without a prefix cache, serial loop."""
    jcfg, jp, cfg, p = mistral["g12"]
    kw = dict(page_size=PSZ, prefill_chunk=CHUNK, overlap=False,
              speculative=3)
    jeng = JaxEngine.build_paged(jcfg, JaxPlan(tp=1, kv_cache_dtype="float32"),
                                 mesh1, SLOTS, SB, jp, prefix_cache=False, **kw)
    prompts = _prompts(cfg.vocab_size, motif=True)
    want = _serve(jeng, JaxRequest, prompts)
    eng = ServingEngine.build_paged(cfg, ShardingPlan(kv_cache_dtype="float32"),
                                    SLOTS, SB, p, device="cpu", **kw)
    got = _serve(eng, Request, prompts)
    st, jst = eng.stats, jeng.stats
    assert got == want
    assert (st.ticks, st.spec_steps, st.spec_drafted, st.spec_accepted) == \
        (jst.ticks, jst.spec_steps, jst.spec_drafted, jst.spec_accepted)
    assert st.spec_steps > 0


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_contiguous_engine_matches_jax(mistral, mesh1, variant):
    jcfg, jp, cfg, p = mistral[variant]
    jplan = JaxPlan(tp=1, kv_cache_dtype="float32")
    dec, _, _ = jsteps.make_decode_step(jcfg, jplan, mesh1,
                                        ShapeConfig("s", "decode", SB, SLOTS))
    pre, _, _ = jsteps.make_prefill_step(jcfg, jplan, mesh1,
                                         ShapeConfig("p", "decode", SB, 1))
    jeng = JaxEngine(jcfg, jplan, mesh1, SLOTS, SB, jp, jax.jit(pre),
                     jax.jit(dec))
    prompts = _prompts(cfg.vocab_size)
    want = _serve(jeng, JaxRequest, prompts)
    eng = ServingEngine(cfg, ShardingPlan(kv_cache_dtype="float32"), SLOTS,
                        SB, p, device="cpu")
    got = _serve(eng, Request, prompts)
    assert got == want
    assert (eng.stats.ticks, eng.stats.prefills) == \
        (jeng.stats.ticks, jeng.stats.prefills)


# ---------------------------------------------------------------- refusals
def test_pixtral_is_refused_for_jax_s_reason(monkeypatch):
    """pixtral-12b (untied, vision frontend) is registered; the port
    refuses to build it, naming the vision frontend's image embeds as
    JAX's paged engine does, before any engine work."""
    cfg = reduced(get_config("pixtral-12b"))
    ok, why = paged_cache_supported(jax_reduced(jax_get_config("pixtral-12b")))
    assert not ok and "vision" in why
    for build in (lambda: model.init_params(cfg, ShardingPlan(), device="cpu"),
                  lambda: model.check_supported(get_config("pixtral-12b"))):
        with pytest.raises(NotImplementedError,
                           match="vision frontend, whose image embeds need "
                                 "injection at prefill"):
            build()

    def never(*a, **k):
        raise AssertionError("the engine went past check_supported")

    monkeypatch.setattr(engine_mod, "cache_profile", never)
    with pytest.raises(NotImplementedError, match="vision"):
        ServingEngine.build_paged(cfg, ShardingPlan(), 2, 32, {}, page_size=8,
                                  prefill_chunk=8, device="cpu")


def test_check_verify_on_card_refuses_what_the_plan_refuses():
    """The engine's construction-time refusal agrees with the verify
    kernel's plan for every group and query count, and names ROADMAP
    Queue 2 item 1."""
    for r in (1, 2, 4, 12, 16):
        cfg = dataclasses.replace(reduced(get_config(ARCH)), n_heads=r,
                                  n_kv_heads=1)
        for q in range(1, 11):
            try:
                k_decode.plan(8, r, q, 128, 16, 16, torch.bfloat16, group=r)
                fits = True
            except ValueError:
                fits = False
            if fits:
                steps.check_verify_on_card(cfg, ShardingPlan(), q)
            else:
                with pytest.raises(ValueError,
                                   match=r"ROADMAP Queue 2 item 1: R x Q > 16"):
                    steps.check_verify_on_card(cfg, ShardingPlan(), q)
    with pytest.raises(ValueError, match=r"R 12 q heads a slot x Q 2 queries "
                                         r"= 24"):
        steps.check_verify_on_card(get_config(ARCH), ShardingPlan(), 2)
    steps.check_verify_on_card(get_config(ARCH), ShardingPlan(), 1)


def test_engine_on_the_card_refuses_speculation_at_group_12(monkeypatch):
    """Built on the card, a speculative mistral engine raises at
    construction, before its weights move or its pools are allocated (no
    card here: the device is patched, and nothing reaches it)."""
    monkeypatch.setattr(engine_mod, "resolve_device",
                        lambda d: torch.device("cuda"))

    def never(*a, **k):
        raise AssertionError("the engine allocated before refusing")

    monkeypatch.setattr(engine_mod, "zero_paged_cache_for", never)
    monkeypatch.setattr(engine_mod, "Decoder", never)
    cfg = reduced(get_config(ARCH), **VARIANTS["g12"])
    with pytest.raises(ValueError, match="ROADMAP Queue 2 item 1"):
        ServingEngine.build_paged(cfg, ShardingPlan(), 2, SB, {}, page_size=PSZ,
                                  prefill_chunk=CHUNK, speculative=1)


def test_mistral_plans_fit_the_card():
    """Every matmul plan at mistral's widths (M 1 for a lone decode row, 8
    a decode tick, 32 a chunk; K and N up to 28672; the untied head NT)
    fits 227 KB of shared memory with its split inside a cluster; flash
    and paged decode take group 12 at D 128."""
    E, F, V = 12288, 28672, 32768
    shapes = {"wq/wo": (E, E, False), "wk/wv": (1024, E, False),
              "w_gate/w_up": (F, E, False), "w_down": (E, F, False),
              "head": (V, E, True)}
    for M in (1, 8, 32):
        for N, K, tb in shapes.values():
            pl = k_matmul.plan(M, N, K, torch.bfloat16, tb)
            assert pl.kernel == "mma" and pl.smem <= k_matmul.SMEM_MAX
            assert pl.split in k_matmul.SPLITS
    fp = k_flash.plan(96, 32, 288, 128, torch.bfloat16, 0, 12)
    assert fp.kernel == "mma" and fp.smem <= k_matmul.SMEM_MAX
    dp = k_decode.plan(8, 96, 1, 128, 16, 16, torch.bfloat16, group=12)
    assert dp.kernel == "mma" and dp.split in k_decode.SPLITS


@pytest.mark.parametrize("flags", [["--paged"], []],
                         ids=["paged", "contiguous"])
def test_launcher_serves_mistral_smoke_on_cpu(flags, capsys):
    assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--kv-dtype", "fp32", "--requests", "3", "--slots", "2",
                       "--seq-budget", "64", "--page-size", "8",
                       "--prefill-chunk", "16", "--max-new", "4",
                       *flags]) == 0
    out = capsys.readouterr().out
    assert f"arch={ARCH}-smoke" in out and "tokens=12" in out
    assert f"engine={'paged' if flags else 'contiguous'}" in out
