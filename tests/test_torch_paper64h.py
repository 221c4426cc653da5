"""tinyllama-42m-64h (the paper's Fig. 6 scalability variant: 64 heads of
head_dim 8) in the port, against the JAX package on the same numpy inputs,
at full width (d_model 512, 64 q = 64 kv heads x 8, d_ff 2048, vocab 32000,
tied) and 2 of its 8 layers.  ``reduced()`` would turn the 64 heads into 4
of 32 on both sides, so the cut here is ``dataclasses.replace`` of the
depth alone.

- The four attention kernels' plain versions at D 8 (flash, paged decode
  and verify over float and int8 pools, contiguous decode) against the
  Pallas kernels in interpret mode, which take D 8.
- The kernels' plans at D 8 (shared memory mirrored from the sources, no
  padding: the wrappers hand D 8 and the tensors as given to the C
  entries), and the sources' D 8 instantiations.
- Logits of the whole-prompt prefill, the prefill chunk, the paged decode
  and the verify step against JAX through ``bridge.params_from_jax``.
- Greedy tokens against JAX's engines (``overlap=False``): float and int8
  pools, speculation k = 3, the prefix cache, and the contiguous engine;
  and the launcher's ``--arch tinyllama-42m-64h`` on the CPU.

Tolerances: fp32 1e-4, bf16 2e-2 (``tests/test_kernels.py``)."""
import contextlib
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from paged_cases import paged_case, quant_pool_case

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import ShapeConfig
from repro.core import model as jmodel
from repro.core import steps as jsteps
from repro.core.partition import ShardingPlan as JaxPlan
from repro.kernels.decode_attention import decode_attention as pl_decode
from repro.kernels.decode_attention import paged_decode_attention as pl_paged
from repro.kernels.decode_attention import paged_verify_attention as pl_verify
from repro.kernels.flash_attention import flash_attention as pl_flash
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.core import steps
from repro_torch.core.partition import ShardingPlan, model_layout
from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as k_decode
from repro_torch.kernels import flash_attention as k_flash
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.serving import Request, ServingEngine

ARCH = "tinyllama-42m-64h"
TOL = dict(rtol=1e-4, atol=1e-4)
DTYPES = [("float32", jnp.float32, torch.float32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16)]
CSRC = Path(k_decode.__file__).parent / "csrc"
SMEM_MAX = 227 * 1024
CUT = dict(n_layers=2, dtype="float32")


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else \
        dict(rtol=1e-4, atol=1e-4)


def _both(x, jdt, tdt):
    x = np.asarray(x, np.float32)
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(got, want, name):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(name))


# ---------------------------------------------------------------- config
def test_the_cut_keeps_64_heads_of_8_where_reduced_does_not():
    full = get_config(ARCH)
    assert (full.n_heads, full.n_kv_heads, full.head_dim_, full.d_model,
            full.d_ff, full.vocab_size, full.tie_embeddings) == \
        (64, 64, 8, 512, 2048, 32000, True)
    for r in (reduced(full), jax_reduced(jax_get_config(ARCH))):
        assert (r.n_heads, r.head_dim) == (4, 32)
    cut = dataclasses.replace(full, **CUT)
    assert (cut.n_heads, cut.head_dim_, cut.n_layers) == (64, 8, 2)
    lay = model_layout(full, ShardingPlan()).attn
    assert (lay.r, lay.n_kv_loc) == (1, 64)


# ----------------------------------------------- plain kernels vs Pallas
@pytest.mark.parametrize("sq,skv,causal", [(32, 32, True), (32, 96, True),
                                           (16, 16, False)])
@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_flash_attention_at_head_dim_8_matches_pallas(sq, skv, causal, name,
                                                      jdt, tdt):
    rng = np.random.RandomState(sq + skv)
    qj, qt = _both(rng.randn(64, sq, 8), jdt, tdt)
    kj, kt = _both(rng.randn(64, skv, 8), jdt, tdt)
    vj, vt = _both(rng.randn(64, skv, 8), jdt, tdt)
    got = ops.flash_attention(qt, kt, vt, causal=causal)
    _close(got, pl_flash(qj, kj, vj, causal=causal, bq=16, bkv=16,
                         interpret=True), name)


def _paged_inputs(rng, nq, quant):
    B, H, D, psz, n_max = 5, 64, 8, 8, 4
    n_pages = B * n_max + 1
    bt = paged_case(rng, B, n_max, n_pages)
    length = np.asarray([1, 8, 9, 32 - nq + 1, 1], np.int32)
    q = rng.randn(B, H, nq, D).astype(np.float32)
    if quant:
        (kp, ks), (vp, vs) = (quant_pool_case(rng, n_pages, H, psz, D)
                              for _ in range(2))
        return q, kp, vp, bt, length, dict(k_scale=ks, v_scale=vs)
    kp, vp = (rng.randn(n_pages, H, psz, D).astype(np.float32)
              for _ in range(2))
    return q, kp, vp, bt, length, {}


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("nq", [1, 4])
@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_paged_attention_at_head_dim_8_matches_pallas(nq, quant, name, jdt,
                                                      tdt):
    """Paged decode (Q 1) and verify (Q 4) at 64 heads of 8 over float or
    int8 pools: page-crossing lengths, a shuffled block table, an idle lane
    on the scratch page, a zero-scale page."""
    q, kp, vp, bt, length, sc = _paged_inputs(np.random.RandomState(nq), nq,
                                              quant)
    pool_t = (lambda a: torch.from_numpy(a)) if quant else \
        (lambda a: torch.from_numpy(a).to(tdt))
    pool_j = (lambda a: jnp.asarray(a)) if quant else \
        (lambda a: jnp.asarray(a, jdt))
    qj, qt = _both(q if nq > 1 else q[:, :, 0], jdt, tdt)
    args_t = (pool_t(kp), pool_t(vp), torch.from_numpy(bt),
              torch.from_numpy(length))
    args_j = (pool_j(kp), pool_j(vp), jnp.asarray(bt), jnp.asarray(length))
    sct = {k: torch.from_numpy(v) for k, v in sc.items()}
    scj = {k: jnp.asarray(v) for k, v in sc.items()}
    if nq == 1:
        got = ops.paged_decode_attention(qt, *args_t, **sct)
        want = pl_paged(qj, *args_j, interpret=True, **scj)
    else:
        got = ops.paged_verify_attention(qt, *args_t, **sct)
        want = pl_verify(qj, *args_j, interpret=True, **scj)
    assert got.dtype == tdt and got.shape[-1] == 8
    _close(got, want, name)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_contiguous_decode_at_head_dim_8_matches_pallas(quant, name, jdt,
                                                        tdt):
    """Lanes (B, 64, S, 8), lengths 1 to S; int8 lanes are the Pallas
    kernel's input dequantised at the engine's fixed scale 1/16."""
    rng = np.random.RandomState(11)
    B, H, S, D = 4, 64, 40, 8
    q = rng.randn(B, H, D)
    length = np.asarray([1, 17, 33, 40], np.int32)
    qj, qt = _both(q, jdt, tdt)
    if quant:
        k8, v8 = (rng.randint(-127, 128, (B, H, S, D)).astype(np.int8)
                  for _ in range(2))
        got = ops.decode_attention(qt, torch.from_numpy(k8),
                                   torch.from_numpy(v8),
                                   torch.from_numpy(length), kv_scale=1 / 16)
        kj, vj = (jnp.asarray(a.astype(np.float32) / 16, jdt) for a in (k8, v8))
    else:
        kj, kt = _both(rng.randn(B, H, S, D), jdt, tdt)
        vj, vt = _both(rng.randn(B, H, S, D), jdt, tdt)
        got = ops.decode_attention(qt, kt, vt, torch.from_numpy(length))
    _close(got, pl_decode(qj, kj, vj, jnp.asarray(length), bkv=8,
                          interpret=True), name)


# ------------------------------------------------------------------ plans
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("nq", [1, 5, 8])
def test_paged_plans_at_head_dim_8_fit(nq, quant):
    """Serve's shapes at 64 heads of 8 (B 8, pages of 16, n_max 16): at
    B x 64 clusters the split stays 1 (more blocks than SMs already), and
    shared memory is the source's formula: an int8 row of 8 bytes in one
    16-byte chunk, a bf16 row in one at a stride of two."""
    p = k_decode.plan(8, 64, nq, 8, 16, 16, torch.bfloat16, quant)
    assert p.kernel == "mma" and p.split == 1 and p.nw == 4
    assert p.smem == k_decode._smem_bytes(8, quant, nq, 4, 1) <= SMEM_MAX
    stage = 2 * 16 * (1 if quant else 2) * 16 + (128 if quant else 0)
    assert p.smem == 4 * 2 * stage + 4 * (4 * nq * 10 + 5 * nq)
    c = k_decode.contiguous_plan(8, 64, 256, 8, torch.bfloat16, quant)
    assert c.kernel == "mma" and c.smem <= SMEM_MAX


@pytest.mark.parametrize("sq,skv", [(32, 256), (32, 32), (160, 160)])
def test_flash_plan_at_head_dim_8_fits(sq, skv):
    p = k_flash.plan(64, sq, skv, 8, torch.bfloat16)
    assert p.kernel == "mma" and k_flash.kv_tile(8) == 64
    assert p.smem == k_flash._smem_bytes(8, p.wq, p.split) <= SMEM_MAX
    assert k_flash._smem_bytes(8, 2, 1) == 2 * 2 * 64 * 2 * 16
    assert k_flash.plan(64, sq, skv, 8, torch.float32).kernel == "simt"


def test_sources_instantiate_head_dim_8():
    """The C entries take D 8 and each kernel has its D 8 instantiation:
    the k8 tensor-core step, the 8-byte int8 row, the float32 kernels'
    lanes past D."""
    common = (CSRC / "common.cuh").read_text()
    assert "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32" in common
    assert "cp.async.ca.shared.global [%0], [%1], 8, %2;" in common
    for name in ("flash_attention.cu", "paged_decode.cu"):
        src = (CSRC / name).read_text()
        assert "mma_bf16_k8(" in src and "ldsm_x2_trans(" in src
        assert "constexpr bool K8 = D == 8;" in src
        assert re.search(r"case 8:\s*return launch_\w+<8>|case 8: return "
                         r"REPRO_PAGED_MMA\(8\)", src)
    paged = (CSRC / "paged_decode.cu").read_text()
    assert "cp_async_8(st + r * RB, KP + off, in ? 8 : 0);" in paged
    for macro in ("REPRO_PAGED_SIMT", "REPRO_CONTIG_SIMT"):
        assert f"case 8: {macro}(8); break;" in paged
    assert "D != 8 && D != 32" in (CSRC / "flash_attention.cu").read_text()


class _Entry:
    """A C entry that records its arguments instead of launching."""

    def __call__(self, *args):
        self.args = args
        return 0


@pytest.fixture
def card_stub(monkeypatch):
    call = _Entry()

    def check(t, name, ndim, dtypes):
        if t.dim() != ndim or t.dtype not in dtypes or not t.is_contiguous():
            raise ValueError(f"{name}: {t.dim()} dims, {t.dtype}")

    monkeypatch.setattr(build, "check_cuda_tensor", check)
    monkeypatch.setattr(build, "kernel_function", lambda *a: call)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    return call


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_wrappers_hand_head_dim_8_unpadded(card_stub, quant):
    """The paged and contiguous wrappers hand D 8 and the tensors as given
    (no copy padded to D 16) to the C entries."""
    B, H, psz, n_max, bf = 8, 64, 16, 16, torch.bfloat16
    q = torch.zeros(B, H, 8, dtype=bf)
    pool_dt = torch.int8 if quant else bf
    pools = [torch.zeros(B * n_max + 1, H, psz, 8, dtype=pool_dt)
             for _ in range(2)]
    sc = dict(k_scale=torch.zeros(B * n_max + 1, psz),
              v_scale=torch.zeros(B * n_max + 1, psz)) if quant else {}
    bt = torch.zeros(B, n_max, dtype=torch.int32)
    k_decode.paged_decode_attention(q, *pools, bt,
                                    torch.ones(B, dtype=torch.int32), **sc)
    a = card_stub.args
    assert a[0] == q.data_ptr() and a[1] == pools[0].data_ptr()
    p = k_decode.plan(B, H, 1, 8, psz, n_max, bf, quant)
    assert a[-9:-5] == (psz, n_max, 0, 8 ** -0.5)
    assert a[-10] == 8 and a[-4:-1] == (p.nw, p.split, p.smem)
    lanes = [torch.zeros(B, H, 64, 8, dtype=pool_dt) for _ in range(2)]
    k_decode.decode_attention(q, *lanes, torch.ones(B, dtype=torch.int32),
                              kv_scale=1 / 16 if quant else None)
    assert card_stub.args[1] == lanes[0].data_ptr()


def test_flash_wrapper_hands_head_dim_8_unpadded(card_stub, monkeypatch):
    monkeypatch.setattr(k_flash, "offset_tensor",
                        lambda v, d: torch.zeros(1, dtype=torch.int32))
    q = torch.zeros(64, 32, 8, dtype=torch.bfloat16)
    k = torch.zeros(64, 256, 8, dtype=torch.bfloat16)
    k_flash.flash_attention(q, k, k.clone(), q_offset=224)
    a = card_stub.args
    p = k_flash.plan(64, 32, 256, 8, torch.bfloat16)
    assert a[0] == q.data_ptr() and a[4:9] == (64, 1, 32, 256, 8)
    assert a[-4:-1] == (p.wq, p.split, p.smem)


# ------------------------------------------------------ model against JAX
@pytest.fixture(scope="module")
def paper64h():
    """JAX's init at the cut in fp32, weights x10 (greedy decoding does not
    collapse onto one token), and the port's copies through the bridge
    (float32 and int8 pools); ``ports["spec"]``: the same weights at x1,
    where greedy decoding repeats itself and prompt-lookup drafts meet it
    (at x10 no draft is ever found)."""
    jcfg = dataclasses.replace(jax_get_config(ARCH), **CUT)
    jp1 = jmodel.init_params(jcfg, JaxPlan(tp=1, kv_cache_dtype="float32"))
    jp = jax.tree_util.tree_map(lambda a: a * 10, jp1)
    cfg = dataclasses.replace(get_config(ARCH), **CUT)
    ports = {kvd: params_from_jax(cfg, ShardingPlan(kv_cache_dtype=kvd),
                                  jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
             for kvd in ("float32", "int8")}
    ports["spec"] = params_from_jax(cfg, ShardingPlan(kv_cache_dtype="float32"),
                                    jax.tree_util.tree_map(np.asarray, jp1),
                                    device="cpu")
    return jcfg, {"x10": jp, "x1": jp1}, cfg, ports


SB, PSZ, CHUNK, N_MAX, N_PAGES = 64, 8, 16, 8, 17


def _plans(kvd="float32"):
    return JaxPlan(tp=1, kv_cache_dtype=kvd), ShardingPlan(kv_cache_dtype=kvd)


def test_whole_prompt_prefill_then_decode_logits_match_jax(paper64h, mesh1):
    jcfg, jps, cfg, ports = paper64h
    jp, p = jps["x10"], ports["float32"]
    jplan, plan = _plans()
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


@pytest.mark.parametrize("kvd", ["float32", "int8"])
def test_prefill_chunks_decode_and_verify_logits_match_jax(paper64h, mesh1,
                                                           kvd):
    """forward_prefill_chunk over a 21-token prompt (two chunks), two
    paged decode steps (an idle lane on the scratch page), then one verify
    step of Q = 4 over both rows (the second with 2 live columns)."""
    jcfg, jps, cfg, ports = paper64h
    jp, p = jps["x10"], ports[kvd]
    jplan, plan = _plans(kvd)
    jchunk, _, _ = jsteps.make_prefill_chunk_step(jcfg, jplan, mesh1, CHUNK,
                                                  N_PAGES, PSZ, N_MAX)
    jdec, _, _ = jsteps.make_paged_decode_step(jcfg, jplan, mesh1, 2, N_PAGES,
                                               PSZ, N_MAX)
    jver, _, _ = jsteps.make_verify_step(jcfg, jplan, mesh1, 2, 4, N_PAGES,
                                         PSZ, N_MAX)
    jchunk, jdec, jver = jax.jit(jchunk), jax.jit(jdec), jax.jit(jver)
    chunk = steps.make_prefill_chunk_step(cfg, plan, CHUNK, N_MAX)
    dec = steps.make_paged_decode_step(cfg, plan, 2, N_MAX)
    ver = steps.make_verify_step(cfg, plan, 2, 4, N_MAX)
    rng = np.random.RandomState(0)
    bt = np.asarray([[7, 2, 11, 4, 9, 1, 13, 15], [3, 5, 6, 8, 10, 12, 14, 16]],
                    np.int32)
    jcache = jsteps.zero_paged_cache_for(jcfg, jplan, mesh1, N_PAGES, PSZ)
    cache = steps.zero_paged_cache_for(cfg, plan, N_PAGES, PSZ, "cpu")
    prompt = rng.randint(2, cfg.vocab_size, 21)
    jl, jcache, tl, cache = _prefill_paged(jchunk, jp, jcache, chunk, p,
                                           cache, prompt, bt[0])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    idle = np.stack([bt[0], np.zeros(N_MAX, np.int32)])
    tok, pos = int(np.argmax(np.asarray(jl[0]))), len(prompt)
    for _ in range(2):
        toks = np.asarray([[tok], [0]], np.int32)
        pos_v = np.asarray([pos, 0], np.int32)
        jl, jcache = jdec(jp, jcache, jnp.asarray(toks), jnp.asarray(pos_v),
                          jnp.asarray(idle))
        tl, cache = dec(p, cache, torch.from_numpy(toks).long(),
                        torch.from_numpy(pos_v), torch.from_numpy(idle))
        np.testing.assert_allclose(tl[0:1].numpy(), np.asarray(jl[0:1]),
                                   **TOL)
        tok, pos = int(np.argmax(np.asarray(jl[0]))), pos + 1
    second = rng.randint(2, cfg.vocab_size, 13)
    _, jcache, _, cache = _prefill_paged(jchunk, jp, jcache, chunk, p, cache,
                                         second, bt[1])
    toks = rng.randint(2, cfg.vocab_size, (2, 4)).astype(np.int32)
    pos_v = np.asarray([pos, len(second)], np.int32)
    qlen = np.asarray([4, 2], np.int32)
    jl, _ = jver(jp, jcache, jnp.asarray(toks), jnp.asarray(pos_v),
                 jnp.asarray(qlen), jnp.asarray(bt))
    tl, _ = ver(p, cache, torch.from_numpy(toks).long(),
                torch.from_numpy(pos_v), torch.from_numpy(qlen),
                torch.from_numpy(bt))
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl[0].numpy(), jl[0], **TOL)
    np.testing.assert_allclose(tl[1, :2].numpy(), jl[1, :2], **TOL)


# ---------------------------------------------------------------- engines
SLOTS = 3
# (prompt length, max_new_tokens): both sides of the page and the chunk,
# more requests than slots
REQS = [(5, 9), (17, 6), (9, 12), (24, 8), (33, 7)]


def _prompts(vocab, kind):
    rng = np.random.RandomState(3)
    if kind in ("random", "contiguous"):
        # the contiguous mix: two prompt lengths (JAX compiles its
        # whole-prompt prefill once per length)
        reqs = REQS if kind == "random" else [(5, 9), (17, 6), (5, 12),
                                              (17, 8)]
        return [(rng.randint(2, vocab, L).astype(np.int32), m)
                for L, m in reqs]
    shared = rng.randint(2, vocab, 21)     # a system prompt: mid-page hits
    if kind == "prefix":
        return [(np.concatenate([shared, rng.randint(2, vocab, 3 + i)])
                 .astype(np.int32), m) for i, (_, m) in enumerate(REQS)]
    return [(np.concatenate([shared[:8], np.tile(rng.randint(2, vocab, 3 + i % 2),
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


@pytest.mark.parametrize("kvd,k,prefix", [
    ("float32", 0, False), ("int8", 0, False), ("float32", 3, False),
    ("float32", 0, True)], ids=["float", "int8", "spec3", "prefix-cache"])
def test_paged_engine_matches_jax(paper64h, mesh1, kvd, k, prefix):
    """Greedy tokens, ticks and the mode's counters against JAX's paged
    engine with ``overlap=False``: float and int8 pools, speculation
    k = 3 (repetitive prompts, weights at x1: drafts accepted), the prefix
    cache (a shared 21-token prefix: skipped tokens, COW copies)."""
    jcfg, jps, cfg, ports = paper64h
    jp = jps["x1" if k else "x10"]
    jplan, plan = _plans(kvd)
    kw = dict(page_size=PSZ, prefill_chunk=CHUNK, overlap=False,
              speculative=k, prefix_cache=prefix)
    jeng = JaxEngine.build_paged(jcfg, jplan, mesh1, SLOTS, SB, jp, **kw)
    prompts = _prompts(cfg.vocab_size, "prefix" if prefix else
                       "motif" if k else "random")
    want = _serve(jeng, JaxRequest, prompts)
    eng = ServingEngine.build_paged(cfg, plan, SLOTS, SB,
                                    ports["spec" if k else kvd], device="cpu",
                                    **kw)
    got = _serve(eng, Request, prompts)
    assert got == want
    # not degenerate (at x1 greedy decoding repeats, as drafting needs)
    assert len({t for r in got for t in r}) > (3 if k else 10)
    st, jst = eng.stats, jeng.stats
    fields = ("ticks", "prefills", "spec_steps", "spec_drafted",
              "spec_accepted", "prefix_hits", "prefill_tokens_skipped",
              "cow_copies")
    assert [getattr(st, f) for f in fields] == [getattr(jst, f)
                                                for f in fields]
    assert not k or st.spec_accepted > 0
    assert not prefix or (st.prefill_tokens_skipped > 0 and st.cow_copies > 0)
    assert eng.drain() == 0


def test_contiguous_engine_matches_jax(paper64h, mesh1):
    jcfg, jps, cfg, ports = paper64h
    jp = jps["x10"]
    jplan, plan = _plans()
    dec, _, _ = jsteps.make_decode_step(jcfg, jplan, mesh1,
                                        ShapeConfig("s", "decode", SB, SLOTS))
    pre, _, _ = jsteps.make_prefill_step(jcfg, jplan, mesh1,
                                         ShapeConfig("p", "decode", SB, 1))
    jeng = JaxEngine(jcfg, jplan, mesh1, SLOTS, SB, jp, jax.jit(pre),
                     jax.jit(dec))
    prompts = _prompts(cfg.vocab_size, "contiguous")
    want = _serve(jeng, JaxRequest, prompts)
    eng = ServingEngine(cfg, plan, SLOTS, SB, ports["float32"], device="cpu")
    got = _serve(eng, Request, prompts)
    assert got == want
    assert (eng.stats.ticks, eng.stats.prefills) == \
        (jeng.stats.ticks, jeng.stats.prefills)


@pytest.mark.parametrize("flags", [["--paged", "--kv-dtype", "int8"], []],
                         ids=["paged-int8", "contiguous"])
def test_launcher_serves_64h_at_full_width_on_cpu(flags, capsys):
    """``--arch tinyllama-42m-64h`` without ``--smoke``: all 8 layers of 64
    heads of 8 (random weights from the seed)."""
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "2",
                       "--slots", "2", "--seq-budget", "32", "--page-size",
                       "8", "--prefill-chunk", "16", "--prompt-len", "8",
                       "--max-new", "3", *flags]) == 0
    out = capsys.readouterr().out
    assert f"arch={ARCH} " in out and "tokens=6" in out
    assert f"engine={'paged' if flags else 'contiguous'}" in out
