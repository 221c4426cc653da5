"""The port's contiguous serving path against the JAX package: the plain
version of the contiguous decode-attention kernel against the Pallas
``decode_attention`` (interpret mode) and ``kernels/ref.py``, the lane
writes (``_kv_q`` with the fixed ``KVQ`` scale, ``_kv_write``,
``_kv_fill``), ``forward_prefill``/``forward_decode`` logits and lanes for
reduced tinyllama-42m (float and int8 lanes) and reduced mamba2-370m
(state and conv tails), and the contiguous engine's greedy tokens against
JAX's contiguous ``ServingEngine`` and against the port's own paged
engine.  Also the slot_pos mask against the kernel's prefix-length mask
on lanes the engine produced, the launcher's engine selection and the
refusals without a card.

Tolerances: fp32 1e-4 and bf16 2e-2 (``tests/test_kernels.py:16-18``).
int8 lanes: one quantization step (1/16) where float rounding in the two
frameworks puts a value on the other side of a rounding boundary."""
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
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pl_decode
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.core import attention, blocks, steps
from repro_torch.core.partition import ShardingPlan
from repro_torch.kernels import decode_attention as k_decode
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.scheduler import FCFSScheduler

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SB, SLOTS = 64, 3
# (prompt length, max_new_tokens): three distinct lengths (JAX compiles its
# prefill once per length), more requests than slots (lanes are reused),
# and one request that runs into the sequence budget: the contiguous engine
# retires it when its position reaches SB - 1, after SB - 17 tokens
REQS = [(5, 9), (17, 4), (9, 12), (5, 3), (17, 60), (9, 7)]
# the same within the paged engine's budget (prompt + max_new <= SB), which
# ends each request where the contiguous engine does
REQS_FIT = [(L, min(m, SB - L)) for L, m in REQS]


def _t(a):
    return torch.from_numpy(np.array(a))        # a writable copy


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **tol)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------------ kernel
@pytest.mark.parametrize("S,bkv", [(300, 128), (128, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_matches_pallas_and_ref(S, bkv, dtype):
    """Lengths 0, 1, ragged and S; S = 300 is no multiple of the Pallas
    tile (which pads it), S = 128 one tile.  Length 0 gives zeros, as the
    Pallas kernel does; JAX's ref gives the mean of V there, so it is
    compared only where length >= 1."""
    rng = np.random.RandomState(S)
    B, H, D = 5, 2, 32
    q, k, v = (rng.randn(*s).astype(np.float32)
               for s in ((B, H, D), (B, H, S, D), (B, H, S, D)))
    length = np.asarray([0, 1, 13, S - 1, S], np.int32)
    jq, jk, jv = (jnp.asarray(a, JDT[dtype]) for a in (q, k, v))
    tq, tk, tv = (_t(a).to(TDT[dtype]) for a in (q, k, v))
    got = ref.ref_decode_attention(tq, tk, tv, _t(length))
    assert got.dtype == TDT[dtype]
    _close(got, pl_decode(jq, jk, jv, jnp.asarray(length), bkv=bkv,
                          interpret=True), TOL[dtype])
    assert not got[0].float().any()                      # length 0
    _close(got[1:], jref.ref_decode_attention(jq, jk, jv, jnp.asarray(length))[1:],
           TOL[dtype])
    _close(ops.decode_attention(tq, tk, tv, _t(length)), got.float().numpy(),
           TOL["float32"])


# ------------------------------------------------------------- lane writes
def test_kv_q_matches_jax_fixed_scale():
    """Saturation at +-127 (|x| > 7.94) and round half to even on exact
    halves of the 1/16 step."""
    rng = np.random.RandomState(2)
    x = np.concatenate([rng.randn(200) * 4, [7.9, 8.0, -9.5, 100.0],
                        (np.arange(-8, 8) + 0.5) / 16]).astype(np.float32)
    got = blocks._kv_q(_t(x), torch.int8)
    want = np.asarray(jblocks._kv_q(jnp.asarray(x), jnp.int8))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.abs().max() == 127
    np.testing.assert_array_equal(
        blocks._kv_dq(got, torch.float32).numpy(),
        np.asarray(jblocks._kv_dq(jnp.asarray(want), jnp.float32)))


@pytest.mark.parametrize("kvd", ["float32", "int8"])
def test_kv_write_and_fill_match_jax(kvd):
    """Decode writes at ring slot pos % W (one row wraps), and prefill fills
    the last W tokens at their ring slots (S < W and S > W)."""
    rng = np.random.RandomState(3)
    B, G, W, D = 3, 2, 8, 16
    jplan = JaxPlan(tp=1, kv_cache_dtype=kvd)
    tdt = {"float32": torch.float32, "int8": torch.int8}[kvd]

    def lane(b):
        k = (rng.randn(b, G, W, D) * 3).astype(np.float32)
        pos = np.full((b, W), -1, np.int32)
        jkv = {"k": jblocks._kv_q(jnp.asarray(k), jnp.dtype(kvd)),
               "v": jblocks._kv_q(jnp.asarray(-k), jnp.dtype(kvd)),
               "pos": jnp.asarray(pos)}
        return jkv, {n: _t(np.asarray(a)) for n, a in jkv.items()}

    def same(tkv, jkv):
        for n in ("k", "v", "pos"):
            np.testing.assert_array_equal(tkv[n].numpy(), np.asarray(jkv[n]))

    jkv, tkv = lane(B)
    kg = (rng.randn(B, G, 1, D) * 3).astype(np.float32)
    pos = np.asarray([0, 9, 5], np.int32)
    jkv = jblocks._kv_write(jkv, jnp.asarray(kg), jnp.asarray(kg * 2),
                            jnp.asarray(pos), jplan)
    blocks._kv_write(tkv, _t(kg), _t(kg * 2), _t(pos))
    same(tkv, jkv)
    assert tkv["k"].dtype == tdt
    for S in (5, 11):
        jkv, tkv = lane(1)
        kg = (rng.randn(1, G, S, D) * 3).astype(np.float32)
        positions = np.arange(S, dtype=np.int32)[None]
        jkv = jblocks._kv_fill(jkv, jnp.asarray(kg), jnp.asarray(-kg),
                               jnp.asarray(positions), jplan)
        blocks._kv_fill(tkv, _t(kg), _t(-kg), _t(positions))
        same(tkv, jkv)


# ------------------------------------------------------------ model steps
def _tiny(scale=1.0):
    jcfg = jax_reduced(jax_get_config("tinyllama-42m"), dtype="float32")
    jp = jmodel.init_params(jcfg, JaxPlan(tp=1, kv_cache_dtype="float32"))
    jp = jax.tree_util.tree_map(lambda a: a * scale, jp)
    cfg = reduced(get_config("tinyllama-42m"), dtype="float32")
    return jcfg, jp, cfg, params_from_jax(
        cfg, ShardingPlan(kv_cache_dtype="float32"), _np_tree(jp),
        device="cpu")


def _mamba():
    jcfg = jax_reduced(jax_get_config("mamba2-370m"), dtype="float32")
    jp = jmodel.init_params(jcfg, JaxPlan(tp=1, kv_cache_dtype="float32"))
    cfg = reduced(get_config("mamba2-370m"), dtype="float32")
    return jcfg, jp, cfg, params_from_jax(
        cfg, ShardingPlan(kv_cache_dtype="float32"), _np_tree(jp),
        device="cpu")


@pytest.fixture(scope="module")
def tiny():
    return _tiny()


@pytest.fixture(scope="module")
def tiny_x25():
    """x25 weights: greedy decoding does not collapse onto repeating the
    prompt's last token, and int8 lanes saturate often."""
    return _tiny(25.0)


@pytest.fixture(scope="module")
def mamba():
    return _mamba()


def _lanes_close(cache, jcache, kvd):
    """Every leaf of every layer's lanes: int8 within one step, and equal in
    all but a handful of values; float within fp32 1e-4; pos exactly."""
    for group, jgroup in zip(cache, jcache, strict=True):
        for entry, jentry in zip(group, jgroup, strict=True):
            for kind, leaves in entry.items():
                for name, t in leaves.items():
                    want = np.asarray(jentry[kind][name])
                    if t.dtype == torch.int8:
                        diff = np.abs(t.numpy().astype(np.int32) - want)
                        assert diff.max() <= 1 and (diff == 0).mean() > 0.999
                    elif t.dtype == torch.int32:
                        np.testing.assert_array_equal(t.numpy(), want)
                    else:
                        _close(t, want, TOL["float32"])


@pytest.mark.parametrize("kvd", ["float32", "int8"])
def test_tinyllama_prefill_and_decode_match_jax(tiny, mesh1, kvd):
    """A 13-token prompt into lane 1 of 2 (lane 0 idle), then three decode
    steps; logits and both lanes after every call."""
    jcfg, jp, cfg, p = tiny
    jplan, plan = JaxPlan(tp=1, kv_cache_dtype=kvd), ShardingPlan(kv_cache_dtype=kvd)
    _run_prefill_decode(jcfg, jplan, jp, cfg, plan, p, mesh1, 13, kvd)


def test_mamba2_prefill_and_decode_match_jax(mamba, mesh1):
    """Whole-prompt prefill from a zero state (S = 37: more than one of
    JAX's 32-row SSD chunks), then decode: logits, SSD state and conv
    tails."""
    jcfg, jp, cfg, p = mamba
    _run_prefill_decode(jcfg, JaxPlan(tp=1, kv_cache_dtype="float32"), jp, cfg,
                        ShardingPlan(kv_cache_dtype="float32"), p, mesh1, 37,
                        "float32")


def _run_prefill_decode(jcfg, jplan, jp, cfg, plan, p, mesh1, L, kvd):
    B = 2
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
    tl, lane = pre(p, _t(prompt).long(), lane)
    _close(tl, jl, TOL["float32"])
    _lanes_close(lane, jlane, kvd)

    # splice the lane into slot 1, as the JAX engine does
    jcache = jax.tree_util.tree_map(
        lambda big, ln: big.at[:, 1:2].set(ln[:, 0:1]),
        jsteps.zero_cache_for(jcfg, jplan, mesh1, B, SB), jlane)
    cache = steps.zero_cache_for(cfg, plan, B, SB, "cpu")
    for group, lgroup in zip(cache, lane, strict=True):
        for entry, lentry in zip(group, lgroup, strict=True):
            for kind, leaves in entry.items():
                for name, t in leaves.items():
                    t[:, 1:2].copy_(lentry[kind][name])
    tok, pos = int(np.argmax(np.asarray(jl[0], np.float32))), L
    for _ in range(3):
        toks = np.asarray([[0], [tok]], np.int32)
        pos_v = np.asarray([0, pos], np.int32)
        jl, jcache = jdec(jp, jcache, jnp.asarray(toks), jnp.asarray(pos_v))
        tl, cache = dec(p, cache, _t(toks).long(), _t(pos_v))
        _close(tl[1:], jl[1:], TOL["float32"])
        _lanes_close([[{k: {n: t[:, 1:] for n, t in v.items()}
                        for k, v in e.items()} for e in g] for g in cache],
                     jax.tree_util.tree_map(lambda a: a[:, 1:], jcache), kvd)
        tok, pos = int(np.argmax(np.asarray(jl[1], np.float32))), pos + 1


# ------------------------------------------------------------------ engine
def _requests(cls, vocab, reqs=REQS):
    rng = np.random.RandomState(0)
    return [cls(rid=r, prompt=rng.randint(2, vocab, L).astype(np.int32),
                max_new_tokens=m) for r, (L, m) in enumerate(reqs)]


def _jax_contiguous(jcfg, jplan, jp, mesh1):
    dec, _, _ = jsteps.make_decode_step(jcfg, jplan, mesh1,
                                        ShapeConfig("s", "decode", SB, SLOTS))
    pre, _, _ = jsteps.make_prefill_step(jcfg, jplan, mesh1,
                                         ShapeConfig("p", "decode", SB, 1))
    eng = JaxEngine(jcfg, jplan, mesh1, SLOTS, SB, jp, jax.jit(pre),
                    jax.jit(dec))
    reqs = _requests(JaxRequest, jcfg.vocab_size)
    for r in reqs:
        eng.submit(r)
    eng.run(max_ticks=2000)
    assert all(r.done for r in reqs)
    return eng, [r.out_tokens for r in reqs]


def _port(cfg, plan, p, paged, reqs=REQS):
    eng = (ServingEngine.build_paged(cfg, plan, SLOTS, SB, p, page_size=8,
                                     prefill_chunk=16, device="cpu")
           if paged else ServingEngine(cfg, plan, SLOTS, SB, p, device="cpu"))
    reqs = _requests(Request, cfg.vocab_size, reqs)
    for r in reqs:
        eng.submit(r)
    eng.run(max_ticks=2000)
    assert all(r.done for r in reqs)
    assert eng.drain() == 0
    return eng, [r.out_tokens for r in reqs]


@pytest.mark.parametrize("arch,kvd", [("tinyllama-42m", "float32"),
                                      ("tinyllama-42m", "int8"),
                                      ("mamba2-370m", "float32")])
def test_contiguous_engine_matches_jax_contiguous_engine(arch, kvd, tiny_x25,
                                                         mamba, mesh1):
    jcfg, jp, cfg, p = tiny_x25 if arch == "tinyllama-42m" else mamba
    jplan, plan = JaxPlan(tp=1, kv_cache_dtype=kvd), ShardingPlan(kv_cache_dtype=kvd)
    jeng, want = _jax_contiguous(jcfg, jplan, jp, mesh1)
    eng, got = _port(cfg, plan, p, paged=False)
    assert got == want
    assert len({t for r in got for t in r}) > 10           # not degenerate
    assert (eng.stats.ticks, eng.stats.prefills) == \
        (jeng.stats.ticks, jeng.stats.prefills)
    assert len(got[4]) == SB - REQS[4][0] or got[4][-1] == 1   # budget or EOS


@pytest.mark.parametrize("arch", ["tinyllama-42m", "mamba2-370m"])
def test_contiguous_engine_matches_paged_engine(arch, tiny_x25, mamba):
    *_, cfg, p = tiny_x25 if arch == "tinyllama-42m" else mamba
    plan = ShardingPlan(kv_cache_dtype="float32")
    contig, got = _port(cfg, plan, p, paged=False, reqs=REQS_FIT)
    paged, want = _port(cfg, plan, p, paged=True, reqs=REQS_FIT)
    assert got == want
    assert not contig.paged and contig.allocator is None and paged.paged
    assert paged.allocator.n_free == paged.allocator.n_pages - 1


def test_slot_pos_mask_equals_the_length_mask_on_engine_lanes(tiny_x25):
    """The card's kernel masks by ``length = pos + 1``, the CPU path by the
    lane's ``slot_pos``.  On every lane the engine hands the decode step
    (reused lanes included), slot s holds position s up to pos and is
    empty past it, and attention under both masks agrees."""
    *_, cfg, p = tiny_x25
    eng = ServingEngine(cfg, ShardingPlan(kv_cache_dtype="float32"), SLOTS, SB,
                        p, device="cpu")
    decode, admitted, checked = eng.decode_fn, {}, []
    rng = np.random.RandomState(4)

    def spy(params, cache, tokens, pos):
        logits, cache = decode(params, cache, tokens, pos)
        live = [b for b, a in enumerate(eng.admissions) if a is not None]
        for b in live:
            admitted.setdefault(b, set()).add(eng.admissions[b].req.rid)
        for entry in (e for g in cache for e in g):
            kv = entry["kv"]
            slot_pos, cur = kv["pos"][0], pos
            for b in live:
                n = int(cur[b]) + 1
                np.testing.assert_array_equal(slot_pos[b, :n].numpy(),
                                              np.arange(n))
                assert (slot_pos[b, n:] == -1).all()
            G, D = kv["k"].shape[2], kv["k"].shape[-1]
            q = _t(rng.randn(SLOTS, G, 1, D).astype(np.float32))
            by_slot = attention.decode_attention(q, kv["k"][0], kv["v"][0],
                                                 slot_pos, cur)
            by_len = ref.ref_decode_attention(q[:, :, 0], kv["k"][0],
                                              kv["v"][0], cur + 1)
            _close(by_slot[live, :, 0], by_len[live].numpy(), TOL["float32"])
        checked.append(max(len(s) for s in admitted.values()))
        return logits, cache

    eng.decode_fn = spy
    for r in _requests(Request, cfg.vocab_size):
        eng.submit(r)
    eng.run()
    assert checked and checked[-1] > 1                     # a reused lane


# ---------------------------------------------------------- launcher etc.
@pytest.mark.parametrize("arch", ["tinyllama-42m", "mamba2-370m"])
def test_launcher_serves_contiguous_by_default_and_paged_on_request(arch,
                                                                    capsys):
    argv = ["--arch", arch, "--smoke", "--requests", "3", "--slots", "2",
            "--seq-budget", "64", "--prompt-len", "20", "--max-new", "4",
            "--page-size", "8", "--prefill-chunk", "16", "--kv-dtype", "fp32",
            "--device", "cpu"]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "engine=contiguous" in out and "tokens=12" in out
    assert "pages_free" not in out and "ssm_slabs" not in out
    assert serve.main(argv + ["--paged"]) == 0
    out = capsys.readouterr().out
    assert "engine=paged" in out and "tokens=12" in out
    assert "pages_free=16/16" in out or "ssm_slabs: slabs=2" in out


def test_fcfs_scheduler_without_allocator_only_orders_the_queue():
    """JAX's contiguous mode (``FCFSScheduler(seq_budget=16)``): a free slot
    takes the head, a prompt must leave room to decode."""
    sched = FCFSScheduler(seq_budget=16)
    reqs = [Request(rid=i, prompt=np.arange(2, 2 + L, dtype=np.int32),
                    max_new_tokens=40) for i, L in enumerate((3, 15, 4))]
    for r in reqs:
        sched.submit(r)
    with pytest.raises(RuntimeError, match="sequence budget"):
        sched.submit(Request(rid=9, prompt=np.arange(2, 18, dtype=np.int32)))
    adm = sched.plan([2, 0])
    assert [(a.slot, a.req.rid, a.pages, a.slab) for a in adm] == \
        [(2, 0, None, None), (0, 1, None, None)]
    sched.on_finish(adm[0])
    assert sched.has_pending() and sched.plan([1])[0].req.rid == 2


def test_contiguous_entry_points_refuse_cuda_without_a_card(tiny, monkeypatch):
    *_, cfg, p = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, ShardingPlan(), SLOTS, SB, p)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        steps.zero_cache_for(cfg, ShardingPlan(), SLOTS, SB)
    with pytest.raises(ValueError, match="paged engine"):
        ServingEngine(cfg, ShardingPlan(), SLOTS, SB, p, speculative=2,
                      device="cpu")


@pytest.mark.parametrize("R,window", [(2, 0), (1, 64)])
def test_card_decode_refuses_gqa_and_windows(R, window):
    """What the card's decode and verify routes refuse before they launch:
    a group too wide for the kernel's m16 (the kernel's plan: R = 2 q heads
    per kv head x 9 verify queries = 18 rows) and more than 8 queries a
    slot, with or without a window, never a quiet detour through the plain
    version.  R q heads per kv head and sliding windows are served: the
    contiguous plan takes a window's ring (S = the window), the paged plan
    the window itself."""
    k_decode.contiguous_plan(8, 8 * R, window or 256, 64, torch.bfloat16,
                             False, R)
    k_decode.plan(8, 8 * R, 1, 64, 16, 16, torch.bfloat16, False, R, window)
    with pytest.raises(ValueError, match=(
            f"{R} q heads per kv head x 9 queries = {9 * R}" if R > 1
            else "9 queries per slot, not 1 to 8")):
        k_decode.plan(8, 8 * R, 9, 64, 16, 16, torch.bfloat16, False, R,
                      window)
