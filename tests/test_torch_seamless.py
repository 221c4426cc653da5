"""seamless-m4t-large-v2, the encoder-decoder, in the port against the JAX
package on the same numpy inputs and, through ``bridge.params_from_jax``,
the same weights (x10 but the layernorms': greedy decoding does not
collapse, and the attention stays well conditioned), on JAX's own CPU
config: ``reduced(..., dtype="float32", n_enc_layers=1, enc_seq_len=16)``
(2 decoder layers and 1 encoder layer, d_model 128, 4 heads of 32,
layernorm, a plain gelu FFN, 16 frames: 2 cross pages of 8).  Covered:
the config, the parameter tree (the encoder subtree, layernorm's bias,
``ln_x`` and ``xattn``), layernorm and the plain FFN, ``cross_attn_mixer``
over contiguous lanes (float and int8: JAX's bare cast) and paged pools
(float and int8), and the card route's arguments; ``encode``,
``forward_cross_kv``, the contiguous prefill and decode and the paged
chunks and decode; the cross-KV write step (int8 payloads and scales
bitwise); ``CrossKVCache`` and the scheduler's cross-KV budget; both
engines' greedy tokens, ticks and encodes (two frame tensors), priority
preemption, JAX's refusals and the launcher.  Tolerance: fp32 1e-4
(``tests/test_kernels.py:16-18``); tokens exact."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import ShapeConfig
from repro.core import blocks as jblocks
from repro.core import layers as jlayers
from repro.core import model as jmodel
from repro.core import steps as jsteps
from repro.core.kvcache import PageAllocator as JaxAllocator
from repro.core.partition import ShardingPlan as JaxPlan
from repro.core.partition import model_layout as jax_model_layout
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving.policies import PriorityScheduler as JaxPriority
from repro.serving.prefix_cache import CrossKVCache as JaxCrossKVCache
from repro.serving.scheduler import FCFSScheduler as JaxFCFS
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.core import attention, blocks, layers, model, steps
from repro_torch.core.kvcache import PageAllocator, cache_profile
from repro_torch.core.partition import ShardingPlan, model_layout
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.serving import (CrossKVCache, PriorityScheduler, Request,
                                 ServingEngine)
from repro_torch.serving.scheduler import FCFSScheduler

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "seamless-m4t-large-v2"
SMALL = dict(dtype="float32", n_enc_layers=1, enc_seq_len=16)
PSZ, CHUNK, SB, SLOTS = 8, 8, 32, 2
S_ENC, E = 16, 128
# (prompt length, max_new_tokens), request i over frame tensor i % 2: two
# prompt lengths (JAX compiles its contiguous prefill once per length),
# one of them two chunks long
REQS = [(5, 5), (9, 4), (5, 3), (9, 6)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _plans(kvd="float32"):
    return JaxPlan(tp=1, kv_cache_dtype=kvd), ShardingPlan(kv_cache_dtype=kvd)


@pytest.fixture(scope="module")
def seamless():
    """JAX's CPU config in fp32 from JAX's init, every weight x10 but the
    layernorms' scales and biases (layernorm's scale starts at 1, and x10
    there would scale the attention logits x100), one draw for every test,
    carried into the port through the bridge."""
    jcfg = jax_reduced(jax_get_config(ARCH), **SMALL)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: a if any(getattr(k, "key", "").startswith(
            ("ln", "final_norm")) for k in path) else a * 10,
        jmodel.init_params(jcfg, JaxPlan(tp=1, kv_cache_dtype="float32")))
    cfg = reduced(get_config(ARCH), **SMALL)
    p = params_from_jax(cfg, ShardingPlan(kv_cache_dtype="float32"),
                        jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, jp, cfg, p


@pytest.fixture(scope="module")
def frames():
    return [np.random.RandomState(40 + g).randn(S_ENC, E).astype(np.float32)
            for g in range(2)]


# ----------------------------------------------------------- config, tree
def test_config_tree_and_param_count_are_jax_s(seamless):
    """The full config equals JAX's field for field (but the name of the
    reduced one); its template counts JAX's 1,369,901,056 parameters; the
    bridged tree and the port's own init have JAX's paths in JAX's order
    (``ln_x`` and ``xattn`` between the mixer and the FFN, the encoder
    last), layernorm's scale starts at ones and its bias at zeros, and the
    plain FFN has no ``w_gate``."""
    import dataclasses
    full, jfull = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert [s.cross_attn for s in full.layer_specs()] == [True] * 24
    assert [dataclasses.astuple(s) for s in full.encoder_layer_specs()] == \
        [dataclasses.astuple(s) for s in jfull.encoder_layer_specs()]
    n = 0

    def count(spec, reps):
        nonlocal n
        n += (reps or 1) * int(np.prod(spec.full))

    model.map_template(full, count)
    assert n == jmodel.param_count(jfull) == 1_369_901_056
    model.check_supported(full)
    jcfg, jp, cfg, p = seamless
    assert list(p) == ["embed", "stacks", "final_norm", "encoder"]
    layer = p["stacks"][0][0]
    assert list(layer) == ["ln1", "attn", "ln_x", "xattn", "ln2", "ffn"]
    assert list(layer["ffn"]) == ["w_up", "w_down"]
    assert list(layer["ln1"]) == ["scale", "bias"]
    assert list(p["encoder"]["stacks"][0][0]) == ["ln1", "attn", "ln2", "ffn"]
    jpaths = [".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
              for path, _ in jax.tree_util.tree_leaves_with_path(jp)]
    ours = model.init_params(cfg, ShardingPlan(), device="cpu")
    assert sorted(k for k, _ in model.tree_paths(p)) == sorted(jpaths)
    assert [(k, tuple(v.shape)) for k, v in model.tree_paths(p)] == \
        [(k, tuple(v.shape)) for k, v in model.tree_paths(ours)]
    for norm in (ours["final_norm"], ours["encoder"]["final_norm"],
                 model.tree_map(lambda a: a[0], ours["stacks"][0][0]["ln_x"])):
        assert torch.equal(norm["scale"], torch.ones(E))
        assert torch.equal(norm["bias"], torch.zeros(E))


def test_bridge_refuses_a_tree_without_the_encoder(seamless):
    jcfg, jp, cfg, _ = seamless
    tree = jax.tree_util.tree_map(np.asarray, jp)
    del tree["encoder"]
    with pytest.raises(ValueError, match="tree keys differ"):
        params_from_jax(cfg, ShardingPlan(), tree, device="cpu")


# ------------------------------------------------------ layernorm, the FFN
def test_layernorm_and_plain_gelu_ffn_match_jax(seamless):
    """``layernorm`` (float32 inside, cast back) with random scale and
    bias, ``apply_norm`` with a pending delta (the add first, in x's
    dtype), and the plain gelu FFN of layer 0 against JAX's."""
    jcfg, jp, cfg, p = seamless
    rng = np.random.RandomState(0)
    x, d = rng.randn(3, 5, E).astype(np.float32), rng.randn(3, 5, E)
    sc, b = rng.randn(E).astype(np.float32), rng.randn(E).astype(np.float32)
    _close(layers.layernorm(_t(x), _t(sc), _t(b)),
           jlayers.layernorm(jnp.asarray(x), jnp.asarray(sc), jnp.asarray(b)))
    d = d.astype(np.float32)
    s, normed = layers.apply_norm(_t(x), {"scale": _t(sc), "bias": _t(b)},
                                  cfg, _t(d))
    np.testing.assert_array_equal(s.numpy(), x + d)
    _close(normed, jlayers.apply_norm(jnp.asarray(x + d),
                                      {"scale": jnp.asarray(sc),
                                       "bias": jnp.asarray(b)}, jcfg))
    for dt in (torch.bfloat16,):
        got = layers.layernorm(_t(x).to(dt), _t(sc), _t(b))
        assert got.dtype == dt
    pf = model.tree_map(lambda a: a[0], p["stacks"][0][0]["ffn"])
    jpf = jax.tree_util.tree_map(lambda a: a[0], jp["stacks"][0][0]["ffn"])
    _close(blocks.dense_ffn(_t(x), pf, cfg),
           jblocks.dense_ffn(jnp.asarray(x), jpf, jcfg))


# ---------------------------------------------------------- cross mixer
def _mixer_case(cfg, case):
    """One cross sublayer's inputs as numpy: x, the cross cache, the
    encoder memory, the pages (paged: pools of 9 pages of 8, cross block
    tables of 2)."""
    rng = np.random.RandomState(len(case))
    G, D = cfg.n_kv_heads, cfg.head_dim_
    mem = rng.randn(1, S_ENC, E).astype(np.float32)
    B, S = (1, 9) if case.startswith("prefill") else \
        (1, CHUNK) if case.startswith("chunk") else (3, 1)
    x = rng.randn(B, S, E).astype(np.float32)
    pages = None
    if "paged" in case:
        n_pages = 9
        if case.endswith("int8"):
            cache = {"ckp": rng.randint(-127, 128, (n_pages, G, PSZ, D)),
                     "cvp": rng.randint(-127, 128, (n_pages, G, PSZ, D)),
                     "cksp": 0.05 * rng.rand(n_pages, PSZ),
                     "cvsp": 0.05 * rng.rand(n_pages, PSZ)}
            cache = {k: v.astype(np.int8 if k in ("ckp", "cvp") else np.float32)
                     for k, v in cache.items()}
        else:
            cache = {"ckp": rng.randn(n_pages, G, PSZ, D).astype(np.float32),
                     "cvp": rng.randn(n_pages, G, PSZ, D).astype(np.float32)}
        cbt = np.asarray([[5, 2], [7, 1], [0, 0]], np.int32)[:B]   # row 2 idle
        pages = {"cross_block_table": cbt}
    elif case == "prefill-contiguous":
        cache = {"k": np.zeros((1, G, S_ENC, D), np.float32),
                 "v": np.zeros((1, G, S_ENC, D), np.float32)}
    elif case == "prefill-contiguous-int8":
        cache = {"k": np.zeros((1, G, S_ENC, D), np.int8),
                 "v": np.zeros((1, G, S_ENC, D), np.int8)}
    elif case.endswith("int8"):             # the bare cast's lane
        cache = {n: rng.randint(-3, 4, (B, G, S_ENC, D)).astype(np.int8)
                 for n in ("k", "v")}
    else:
        cache = {n: rng.randn(B, G, S_ENC, D).astype(np.float32)
                 for n in ("k", "v")}
    return x, cache, mem, pages


@pytest.mark.parametrize("case", [
    "prefill-contiguous", "prefill-contiguous-int8", "decode-contiguous",
    "decode-contiguous-int8", "chunk-paged", "chunk-paged-int8",
    "decode-paged", "decode-paged-int8"])
def test_cross_attn_mixer_matches_jax(seamless, mesh1, case):
    """Layer 1's cross sublayer through both sides: a whole 9-token prompt
    over the memory (the lane it fills; int8 lanes JAX's bare cast,
    bitwise), decode rows over float lanes and over int8 lanes (a bare
    cast back, no scale), a prefill chunk and decode rows over float and
    int8 pools through shuffled cross block tables (an idle row on scratch
    page 0)."""
    jcfg, jp, cfg, p = seamless
    jplan, plan = _plans()
    jsteps.prepare_ledger(mesh1)
    x, cache, mem, pages = _mixer_case(cfg, case)
    mode = case.split("-")[0]
    mode = "prefill" if mode == "chunk" else mode
    pa = model.tree_map(lambda a: a[1], p["stacks"][0][0]["xattn"])
    jpa = jax.tree_util.tree_map(lambda a: a[1], jp["stacks"][0][0]["xattn"])
    tcache = {k: _t(v.copy()) for k, v in cache.items()}
    out, tnew = blocks.cross_attn_mixer(
        _t(x), pa, cfg, model_layout(cfg, plan), mode, tcache, _t(mem),
        None if pages is None else {k: _t(v) for k, v in pages.items()})
    jlay = jax_model_layout(jcfg, jplan)
    jout, jnew = jax.jit(lambda x, pa, c, mem, pages: jblocks.cross_attn_mixer(
        x, pa, jcfg, jplan, jlay, mode, c, mem, pages))(
        jnp.asarray(x), jpa, {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.asarray(mem),
        None if pages is None else {k: jnp.asarray(v) for k, v in pages.items()})
    _close(out, jout)
    if case.startswith("prefill"):
        for name in ("k", "v"):
            if case.endswith("int8"):
                np.testing.assert_array_equal(tnew[name].numpy(),
                                              np.asarray(jnew[name]))
                assert tnew[name].abs().max() > 0
            else:
                _close(tnew[name], jnew[name])


def test_cross_lane_cast_is_jax_s_saturating_truncation():
    """The contiguous int8 cross lane stores JAX's bare ``astype(int8)``:
    truncation toward zero, saturated at the int8 range (XLA's
    conversion), no ``_kv_q`` scale."""
    x = np.asarray([300.5, -300.5, 127.9, -128.9, 1.7, -1.7, 0.5, -0.5, 0.0],
                   np.float32)
    got = blocks.cross_lane_cast(_t(x), torch.int8)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.asarray(x).astype(jnp.int8)))
    assert got.tolist() == [127, -128, 127, -128, 1, -1, 0, 0, 0]
    assert blocks.cross_lane_cast(_t(x), torch.float32).tolist() == x.tolist()


@pytest.mark.parametrize("case", ["decode-contiguous", "decode-contiguous-int8",
                                  "decode-paged", "decode-paged-int8",
                                  "chunk-paged"])
def test_card_route_reads_every_memory_key(seamless, case, monkeypatch):
    """On the card (``torch.Tensor.is_cuda`` patched; the wrappers run
    their plain versions on CPU tensors) the contiguous cross decode hands
    the decode kernel length S_enc = JAX's ``cur_pos = S_enc`` through
    ``min(cur_pos + 1, S_enc)`` (int8 lanes cast to q's dtype first: no
    ``kv_scale``); the paged cross decode hands the paged kernel the cross
    block table itself (no gather) with length S_enc (``cur_pos = S_enc -
    1``), int8 pools with their scales; a prefill chunk runs flash without
    the causal mask over the first S_enc gathered keys.  Outputs equal
    the plain path's."""
    jcfg, jp, cfg, p = seamless
    _, plan = _plans()
    x, cache, mem, pages = _mixer_case(cfg, case)
    mode = "prefill" if case.startswith("chunk") else "decode"
    pa = model.tree_map(lambda a: a[1], p["stacks"][0][0]["xattn"])
    lay = model_layout(cfg, plan)
    tpages = None if pages is None else {k: _t(v) for k, v in pages.items()}
    want, _ = blocks.cross_attn_mixer(_t(x), pa, cfg, lay, mode,
                                      {k: _t(v) for k, v in cache.items()},
                                      None, tpages)
    seen = []

    def spy(name):
        real = getattr(ops, name)

        def wrapped(*args, **kw):
            seen.append((name, args, kw))
            return real(*args, **kw)
        monkeypatch.setattr(ops, name, wrapped)

    for name in ("decode_attention", "paged_decode_attention",
                 "flash_attention"):
        spy(name)
    gather = attention.gather_pages
    monkeypatch.setattr(attention, "gather_pages", lambda *a: pytest.fail(
        "the paged cross decode gathered its pages")
        if mode == "decode" else gather(*a))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    try:
        got, _ = blocks.cross_attn_mixer(_t(x), pa, cfg, lay, mode,
                                         {k: _t(v) for k, v in cache.items()},
                                         None, tpages)
    finally:
        monkeypatch.undo()
    _close(got, want.numpy())
    (name, args, kw), = [s for s in seen if s[0] != "flash_attention"] or \
        [s for s in seen]
    if case.startswith("decode-contiguous"):
        assert name == "decode_attention" and kw.get("kv_scale") is None
        assert args[1].dtype == torch.float32
        assert args[3].tolist() == [S_ENC] * 3
    elif case.startswith("decode-paged"):
        assert name == "paged_decode_attention"
        assert torch.equal(args[3], tpages["cross_block_table"])
        assert args[4].tolist() == [S_ENC] * 3
        assert (kw.get("k_scale") is not None) == case.endswith("int8")
    else:
        assert name == "flash_attention" and kw["causal"] is False
        assert args[1].shape[1] == S_ENC


# ------------------------------------------------------------- the model
def test_encode_and_cross_kv_match_jax(seamless, frames):
    """``encode`` (JAX's "train" mode: causal flash over the frames, RoPE
    over their positions, the encoder's final norm) and every decoder
    layer's cross K/V of the memory."""
    jcfg, jp, cfg, p = seamless
    jplan, plan = _plans()
    jlay, lay = jax_model_layout(jcfg, jplan), model_layout(cfg, plan)
    f = np.stack(frames)                                   # (2, S_enc, E)
    jmem = jmodel.encode(jp, jnp.asarray(f), jcfg, jplan, jlay)
    mem = model.encode(p, _t(f), cfg, plan, lay)
    _close(mem, jmem)
    jkv = jmodel.forward_cross_kv(jp, jmem, jcfg, jplan, jlay)
    kv = model.forward_cross_kv(p, mem, cfg, plan, lay)
    for name in ("k", "v"):
        _close(kv[0][0][name], jkv[0][0][name])
        assert tuple(kv[0][0][name].shape) == (2, 2, 4, S_ENC, 32)


def test_contiguous_prefill_and_decode_match_jax(seamless, frames, mesh1):
    """A 9-token prompt over frame tensor 0 prefilled into a batch-1 lane
    (the encoder at admission, every cross lane filled), spliced into slot
    1 of 2, then three decode steps: logits and every lane (cross lanes
    too) after each call."""
    jcfg, jp, cfg, p = seamless
    jplan, plan = _plans()
    B, L = 2, 9
    jdec, _, _ = jsteps.make_decode_step(jcfg, jplan, mesh1,
                                         ShapeConfig("s", "decode", SB, B))
    jpre, _, _ = jsteps.make_prefill_step(jcfg, jplan, mesh1,
                                          ShapeConfig("p", "decode", SB, 1))
    jdec, jpre = jax.jit(jdec), jax.jit(jpre)
    dec, pre = steps.make_decode_step(cfg, plan, B, SB), \
        steps.make_prefill_step(cfg, plan, SB)
    prompt = np.random.RandomState(L).randint(2, cfg.vocab_size, (1, L))
    jl, jlane = jpre(jp, jnp.asarray(frames[0][None]),
                     jnp.asarray(prompt, jnp.int32),
                     jsteps.zero_cache_for(jcfg, jplan, mesh1, 1, SB))
    lane = steps.zero_cache_for(cfg, plan, 1, SB, "cpu")
    assert set(lane[0][0]) == {"kv", "cross"}
    tl, lane = pre(p, _t(frames[0][None]), _t(prompt).long(), lane)
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
                            np.testing.assert_array_equal(t[:, 1:].numpy(), want)
                        else:
                            _close(t[:, 1:], want)
        tok, pos = int(np.argmax(np.asarray(jl[1]))), pos + 1


@pytest.mark.parametrize("kvd", ["float32", "int8"])
def test_paged_write_chunks_then_decode_match_jax(seamless, frames, mesh1,
                                                  kvd):
    """The cross-KV write step (frame tensor 1 into cross pages [7, 3]),
    then ``forward_prefill_chunk`` over a 13-token prompt (two chunks) and
    four decode steps with an idle row on scratch pages, through the steps
    JAX jits: the cross pools after the write (float within 1e-4, int8
    payloads within one step) and the logits of every step over JAX's
    cross pools."""
    jcfg, jp, cfg, p = seamless
    jplan, plan = _plans(kvd)
    n_max, n_pages = SB // PSZ, 13
    jw, _, _ = jsteps.make_cross_kv_write_step(jcfg, jplan, mesh1, n_pages, PSZ)
    jchunk, _, _ = jsteps.make_prefill_chunk_step(jcfg, jplan, mesh1, CHUNK,
                                                  n_pages, PSZ, n_max)
    jdec, _, _ = jsteps.make_paged_decode_step(jcfg, jplan, mesh1, 2, n_pages,
                                               PSZ, n_max)
    jw, jchunk, jdec = jax.jit(jw), jax.jit(jchunk), jax.jit(jdec)
    jcache = jsteps.zero_paged_cache_for(jcfg, jplan, mesh1, n_pages, PSZ)
    write = steps.make_cross_kv_write_step(cfg, plan, PSZ)
    chunk = steps.make_prefill_chunk_step(cfg, plan, CHUNK, n_max, PSZ)
    dec = steps.make_paged_decode_step(cfg, plan, 2, n_max, PSZ)
    cache = steps.zero_paged_cache_for(cfg, plan, n_pages, PSZ, "cpu")
    cbt = np.asarray([[7, 3]], np.int32)
    jcache = jw(jp, jcache, jnp.asarray(frames[1][None]), jnp.asarray(cbt))
    cache = write(p, cache, _t(frames[1][None]), _t(cbt))
    for name, pool in cache[0][0]["cross"].items():
        want = np.array(jcache[0][0]["cross"][name])[:, 0]
        # int8 payloads: a K/V value on a rounding boundary may land one
        # step apart (the encoders' float32 sums differ in order; the
        # scatter itself is bitwise, test below); the steps after read
        # JAX's pools, so their logits compare at 1e-4
        _close(pool, want, dict(rtol=0, atol=1.0)
               if pool.dtype == torch.int8 else TOL)
        pool.copy_(_t(want))
    prompt = np.random.RandomState(0).randint(2, cfg.vocab_size, 13)
    bt_row = np.asarray([9, 2, 11, 4], np.int32)
    L = len(prompt)
    for c0 in range(0, L, CHUNK):
        toks = np.zeros((1, CHUNK), np.int32)
        toks[0, :min(CHUNK, L - c0)] = prompt[c0:c0 + CHUNK]
        last = min(L - 1 - c0, CHUNK - 1)
        jl, jcache = jchunk(jp, jcache, jnp.asarray(toks),
                            jnp.asarray([c0], jnp.int32),
                            jnp.asarray([last], jnp.int32),
                            jnp.asarray(bt_row[None]), jnp.asarray(cbt))
        tl, cache = chunk(p, cache, _t(toks).long(), c0, last,
                          _t(bt_row[None]), _t(cbt))
        _close(tl, jl)
    bt = np.stack([bt_row, np.zeros(n_max, np.int32)])
    cbt2 = np.stack([cbt[0], np.zeros(2, np.int32)])
    tok, pos = int(np.argmax(np.asarray(jl[0]))), L
    for _ in range(4):
        toks = np.asarray([[tok], [0]], np.int32)
        pos_v = np.asarray([pos, 0], np.int32)
        jl, jcache = jdec(jp, jcache, jnp.asarray(toks), jnp.asarray(pos_v),
                          jnp.asarray(bt), jnp.asarray(cbt2))
        tl, cache = dec(p, cache, _t(toks).long(), _t(pos_v), _t(bt), _t(cbt2))
        _close(tl[0:1], jl[0:1])
        tok, pos = int(np.argmax(np.asarray(jl[0]))), pos + 1


def test_cross_write_scatter_is_bitwise_jax_s(seamless, frames, mesh1,
                                              monkeypatch):
    """The write step's scatter and int8 row quantization given the same
    cross K/V on both sides (``forward_cross_kv`` patched to return one
    numpy draw, with an exact .5 tie and a zero row): int8 payloads and
    scales, and float pools, bitwise equal to JAX's."""
    jcfg, jp, cfg, p = seamless
    rng = np.random.RandomState(5)
    G, D = cfg.n_kv_heads, cfg.head_dim_
    kv = {n: rng.randn(2, 1, G, S_ENC, D).astype(np.float32) for n in "kv"}
    kv["k"][0, 0, :, 3] = 0.0                                 # a zero row
    kv["v"][1, 0, 0, 5, :2] = [127.0, 63.5]                   # a .5 tie
    monkeypatch.setattr(jmodel, "forward_cross_kv", lambda *a: [[
        {n: jnp.asarray(v) for n, v in kv.items()}]])
    monkeypatch.setattr(model, "forward_cross_kv", lambda *a: [[
        {n: _t(v) for n, v in kv.items()}]])
    for kvd in ("int8", "float32"):
        jplan, plan = _plans(kvd)
        jw, _, _ = jsteps.make_cross_kv_write_step(jcfg, jplan, mesh1, 9, PSZ)
        jw = jax.jit(jw)
        jcache = jsteps.zero_paged_cache_for(jcfg, jplan, mesh1, 9, PSZ)
        cbt = np.asarray([[6, 2]], np.int32)
        jcache = jw(jp, jcache, jnp.asarray(frames[0][None]), jnp.asarray(cbt))
        cache = steps.make_cross_kv_write_step(cfg, plan, PSZ)(
            p, steps.zero_paged_cache_for(cfg, plan, 9, PSZ, "cpu"),
            _t(frames[0][None]), _t(cbt))
        cr = cache[0][0]["cross"]
        assert sorted(cr) == (["ckp", "cksp", "cvp", "cvsp"] if kvd == "int8"
                              else ["ckp", "cvp"])
        for name, pool in cr.items():
            np.testing.assert_array_equal(
                pool.numpy(), np.asarray(jcache[0][0]["cross"][name])[:, 0])
        if kvd == "int8":
            assert float(cr["cksp"][0, 6, 3]) == 0.0


# ------------------------------------------------ the cache, the scheduler
class _Req:
    def __init__(self, rid, L, frames, max_new=4):
        self.rid, self.prompt = rid, np.arange(2, 2 + L, dtype=np.int32)
        self.max_new_tokens, self.frames, self.out_tokens = max_new, frames, []


def _sched(side, n_pages, frames_per_req):
    fcfs, alloc_cls, cache_cls = {
        "jax": (JaxFCFS, JaxAllocator, JaxCrossKVCache),
        "port": (FCFSScheduler, PageAllocator, CrossKVCache)}[side]
    alloc = alloc_cls(n_pages)
    cc = cache_cls(alloc)

    class Stats:
        prefix_lookups = prefix_hits = cross_lookups = cross_hits = 0
        spec_denied = 0

    st = Stats()
    s = fcfs(seq_budget=SB, allocator=alloc, page_size=PSZ, stats=st,
             cross_cache=cc, cross_pages_per_req=2)
    return s, alloc, cc, st


def _scheduler_trace(side, frames):
    """One operation sequence: 5 requests (frames A, A, B, A, C) into 2
    slots of a 9-page pool (a request: 1 self page and 2 cross pages), the
    oldest admission retiring after each plan.  -> every observable
    decision."""
    f = [frames[0], frames[0], frames[1], frames[0], frames[1] * 2]
    s, alloc, cc, st = _sched(side, 9, f)
    for i, fr in enumerate(f):
        s.submit(_Req(i, 5, fr))
    trace, live = [], []
    for _ in range(6):
        busy = {a.slot for a in live}
        adms = s.plan([b for b in range(2) if b not in busy])
        for a in adms:
            if a.needs_encode:
                s.on_cross_written(a)
        trace.append([(a.slot, a.req.rid, a.pages, a.cross_pages,
                       a.needs_encode) for a in adms])
        live.extend(adms)
        if live:
            s.on_finish(live.pop(0))
        trace.append((alloc.n_free, cc.n_entries, cc.n_cached_pages,
                      cc.n_evictable_pages, st.cross_lookups, st.cross_hits,
                      s.backlog_pages, s.has_pending()))
    for a in live:
        s.on_finish(a)
    trace.append(sorted(k for k, _ in cc.entries()))
    trace.append((cc.evict(100), cc.evictions, alloc.n_free))
    return trace


def test_cross_cache_and_scheduler_decide_as_jax(frames):
    """The same operations on JAX's and the port's FCFS scheduler with
    their ``CrossKVCache``: admissions (pages, cross pages, encode or
    share: the second request with frames A in the first tick shares the
    pending encode), the joint rollback when the cross pages do not fit
    (the head blocks), hit counters, the backlog, the cache's entries and
    evictable pages, release at finish and a full eviction."""
    out = {side: _scheduler_trace(side, frames) for side in ("jax", "port")}
    assert out["port"] == out["jax"]
    first = out["port"][0]
    assert [a[4] for a in first] == [True, False]       # one encode, shared
    assert first[0][3] == first[1][3]
    assert CrossKVCache.digest(frames[0]) == JaxCrossKVCache.digest(frames[0])


def test_scheduler_preemption_and_rollback_release_cross_pages(frames):
    """``on_preempt`` drops the slot's cross refs (the cache keeps the
    entry, so the re-admission hits); a miss whose cross pages do not fit
    rolls back its self pages, and the cache evicts an unshared entry to
    make room, as JAX's."""
    out = {}
    for side in ("jax", "port"):
        s, alloc, cc, st = _sched(side, 7, None)
        a, b = _Req(0, 5, frames[0]), _Req(1, 5, frames[1])
        s.submit(a)
        adm, = s.plan([0])
        s.on_cross_written(adm)
        s.on_preempt(adm, np.arange(3))
        re, = s.plan([0])                         # a hit on its own encode
        s.submit(b)
        blocked = s.plan([1])                     # 1 + 2 pages: 3 free
        rows = [(alloc.n_free, re.needs_encode, re.cross_pages == adm.cross_pages,
                 [x.needs_encode for x in blocked], cc.n_entries)]
        s.on_finish(re)
        c = _Req(2, 5, frames[1] * 3)
        s.submit(c)
        got = s.plan([0])
        rows.append((alloc.n_free, len(got), cc.n_entries, cc.evictions,
                     st.cross_lookups, st.cross_hits))
        out[side] = rows
    assert out["port"] == out["jax"]


# ---------------------------------------------------------------- engines
def _requests(cls, vocab, frames):
    rng = np.random.RandomState(3)
    return [cls(rid=i, prompt=rng.randint(2, vocab, L).astype(np.int32),
                max_new_tokens=m, frames=frames[i % 2])
            for i, (L, m) in enumerate(REQS)]


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run(max_ticks=2000)
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs]


def _cached(eng):
    return eng.cross_caches[0] if hasattr(eng, "cross_caches") else \
        eng.cross_cache


@pytest.fixture(scope="module")
def jax_runs(seamless, frames, mesh1):
    """JAX's engines, built once each: (tokens, ticks, encodes, free +
    cross-cached pages after the run) by (engine, kv dtype, overlap)."""
    jcfg, jp, cfg, _ = seamless
    memo = {}

    def run(kind, kvd, overlap=False):
        key = (kind, kvd, overlap)
        if key not in memo:
            jplan = JaxPlan(tp=1, kv_cache_dtype=kvd)
            if kind == "contiguous":
                dec, _, _ = jsteps.make_decode_step(
                    jcfg, jplan, mesh1, ShapeConfig("s", "decode", SB, SLOTS))
                pre, _, _ = jsteps.make_prefill_step(
                    jcfg, jplan, mesh1, ShapeConfig("p", "decode", SB, 1))
                eng = JaxEngine(jcfg, jplan, mesh1, SLOTS, SB, jp, jax.jit(pre),
                                jax.jit(dec))
            else:
                eng = JaxEngine.build_paged(jcfg, jplan, mesh1, SLOTS, SB, jp,
                                            page_size=PSZ, prefill_chunk=CHUNK,
                                            overlap=overlap)
            toks = _serve(eng, _requests(JaxRequest, cfg.vocab_size, frames))
            leak = None
            if kind == "paged":
                a = eng.allocators[0]
                leak = a.n_free + _cached(eng).n_cached_pages - a.n_pages
            memo[key] = (toks, eng.stats.ticks, eng.stats.cross_encodes, leak)
        return memo[key]

    return run


@pytest.mark.parametrize("kvd", ["float32", "int8"])
@pytest.mark.parametrize("overlap", [False, True], ids=["serial", "overlap"])
def test_paged_engine_matches_jax(seamless, frames, jax_runs, kvd, overlap):
    """Greedy tokens, ticks and encodes against JAX's paged engine, float
    and int8 pools (the cross pools int8 too), two frame tensors: 2
    encodes and 2 hits; every page free or cross-cached after ``drain()``
    (the cache holds both encodes), free after a full eviction."""
    jcfg, jp, cfg, p = seamless
    eng = ServingEngine.build_paged(cfg, ShardingPlan(kv_cache_dtype=kvd),
                                    SLOTS, SB, p, page_size=PSZ,
                                    prefill_chunk=CHUNK, overlap=overlap,
                                    device="cpu")
    got = _serve(eng, _requests(Request, cfg.vocab_size, frames))
    want, ticks, encodes, leak = jax_runs("paged", kvd, overlap)
    assert got == want
    assert len({t for r in got for t in r}) > 5             # not degenerate
    assert (eng.stats.ticks, eng.stats.cross_encodes) == (ticks, encodes) == \
        (ticks, 2)
    assert (eng.stats.cross_hits, eng.stats.cross_lookups) == (2, 4)
    assert eng.stats.cross_hit_rate == 0.5
    assert eng.allocator.n_pages == SLOTS * (SB // PSZ + 2) + 1
    assert eng.drain() == 0
    a, cc = eng.allocator, eng.cross_cache
    assert a.n_free + cc.n_cached_pages - a.n_pages == leak == -1
    assert cc.n_entries == 2 and cc.evict(a.n_pages) == 4
    assert a.n_free == a.n_pages - 1


@pytest.mark.parametrize("kvd", ["float32", "int8"])
def test_contiguous_engine_matches_jax(seamless, frames, jax_runs, kvd):
    """The contiguous engine (the encoder at every admission, cross lanes;
    int8: fixed-scale self lanes and JAX's bare-cast cross lanes): greedy
    tokens and ticks against JAX's contiguous engine; float lanes' tokens
    equal to the paged engine's."""
    jcfg, jp, cfg, p = seamless
    eng = ServingEngine(cfg, ShardingPlan(kv_cache_dtype=kvd), SLOTS, SB, p,
                        device="cpu")
    got = _serve(eng, _requests(Request, cfg.vocab_size, frames))
    want, ticks, _, _ = jax_runs("contiguous", kvd)
    assert got == want
    assert eng.stats.ticks == ticks and eng.stats.prefills == len(REQS)
    if kvd == "float32":
        assert got == jax_runs("paged", "float32")[0]
    else:
        assert got != jax_runs("contiguous", "float32")[0]   # the cast bites


def test_priority_preemption_matches_jax(seamless, frames, mesh1):
    """Requests arriving while others run under priority preemption (every
    3rd urgent; no prefix cache, so a victim re-prefills, and its cross
    pages come back as a hit): tokens, ticks, preemptions, encodes and hits
    equal JAX's, and the tokens equal FCFS's without preemption."""
    jcfg, jp, cfg, p = seamless
    rng = np.random.RandomState(11)
    mix = [(i, rng.randint(2, cfg.vocab_size, int(rng.randint(4, 12))).astype(
        np.int32), int(rng.randint(6, 12)), 10 if i % 3 == 2 else 0)
        for i in range(7)]
    runs = {}
    for side in ("jax", "port", "fcfs"):
        if side == "jax":
            eng = JaxEngine.build_paged(
                jcfg, JaxPlan(tp=1, kv_cache_dtype="float32"), mesh1, SLOTS,
                SB, jp, page_size=PSZ, prefill_chunk=CHUNK,
                scheduler=functools.partial(JaxPriority, preemption=True))
            cls = JaxRequest
        else:
            eng = ServingEngine.build_paged(
                cfg, ShardingPlan(kv_cache_dtype="float32"), SLOTS, SB, p,
                page_size=PSZ, prefill_chunk=CHUNK, device="cpu",
                scheduler=None if side == "fcfs" else functools.partial(
                    PriorityScheduler, preemption=True))
            cls = Request
        rs = [cls(rid=i, prompt=pr, max_new_tokens=m, priority=pri,
                  frames=frames[i % 2]) for i, pr, m, pri in mix]
        waiting, tick = list(rs), 0
        while waiting or eng.has_pending() or \
                any(a is not None for a in eng.admissions):
            if waiting and (tick < 1 or tick % 3 == 0):
                eng.submit(waiting.pop(0))
            eng.tick()
            tick += 1
        eng.run()
        st = eng.stats
        runs[side] = ([r.out_tokens for r in rs], st.ticks, st.preemptions,
                      st.cross_encodes, st.cross_hits)
        if side == "port":
            assert eng.drain() == 0
            assert eng.allocator.n_free + eng.cross_cache.n_cached_pages == \
                eng.allocator.n_pages - 1
    assert runs["port"] == runs["jax"]
    assert runs["port"][0] == runs["fcfs"][0]
    assert runs["port"][2] > 0 and runs["fcfs"][2] == 0


# --------------------------------------------------------------- refusals
def _jax_error(fn):
    with pytest.raises((ValueError, RuntimeError)) as e:
        fn()
    return type(e.value), str(e.value)


def test_refusals_are_jax_s(seamless, frames, mesh1):
    """The prefix cache and speculation are refused at construction, and
    a request without frames or with misshapen ones at submit, with JAX's
    errors and messages; MoE and the vision frontend keep their
    refusals."""
    import dataclasses
    jcfg, jp, cfg, p = seamless
    jplan, plan = _plans()
    for kw in (dict(prefix_cache=True), dict(speculative=2)):
        want = _jax_error(lambda: JaxEngine.build_paged(
            jcfg, jplan, mesh1, SLOTS, SB, jp, page_size=PSZ,
            prefill_chunk=CHUNK, **kw))
        got = _jax_error(lambda: ServingEngine.build_paged(
            cfg, plan, SLOTS, SB, p, page_size=PSZ, prefill_chunk=CHUNK,
            device="cpu", **kw))
        assert got == want
    jeng = JaxEngine.build_paged(jcfg, jplan, mesh1, SLOTS, SB, jp,
                                 page_size=PSZ, prefill_chunk=CHUNK)
    eng = ServingEngine.build_paged(cfg, plan, SLOTS, SB, p, page_size=PSZ,
                                    prefill_chunk=CHUNK, device="cpu")
    for fr in (None, frames[0][:8], frames[0].T):
        want = _jax_error(lambda: jeng.submit(JaxRequest(
            rid=0, prompt=np.arange(2, 6, dtype=np.int32), frames=fr)))
        got = _jax_error(lambda: eng.submit(Request(
            rid=0, prompt=np.arange(2, 6, dtype=np.int32), frames=fr)))
        assert got == want
    assert "frames" in want[1]
    with pytest.raises(NotImplementedError, match="vision frontend"):
        model.check_supported(dataclasses.replace(cfg,
                                                  frontend="vision_patches"))
    assert cache_profile(cfg) == {"kv", "cross_kv"}


def test_entry_points_refuse_cuda_without_a_card(seamless, monkeypatch):
    _, _, cfg, p = seamless
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine.build_paged(cfg, ShardingPlan(), SLOTS, SB, p,
                                  page_size=PSZ, prefill_chunk=CHUNK)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, ShardingPlan(), SLOTS, SB, p)


# --------------------------------------------------------------- launcher
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_launcher_serves_seamless_with_frame_groups(paged, capsys):
    """``--arch seamless-m4t-large-v2 --smoke --frame-groups 2`` on the
    CPU: the paged engine prints JAX's ``cross_kv:`` line (2 encodes for
    2 frame tensors, the other 4 requests hits); the contiguous engine
    encodes at every admission and prints none."""
    argv = ["--arch", ARCH, "--smoke", "--requests", "6", "--slots", "2",
            "--seq-budget", "64", "--prompt-len", "12", "--max-new", "3",
            "--kv-dtype", "fp32", "--frame-groups", "2", "--device", "cpu"]
    assert serve.main(argv + (["--paged", "--page-size", "8",
                               "--prefill-chunk", "16"] if paged else [])) == 0
    out = capsys.readouterr().out
    assert "tokens=18" in out
    if paged:
        assert "cross_kv: hit_rate=0.67 (4/6 lookups) encodes=2 " \
               "cached_entries=2" in out
    else:
        assert "engine=contiguous" in out and "cross_kv:" not in out
