"""Grouped-query attention and qk-norm in the port, against the JAX package
on the same numpy inputs: the plain versions of the four attention kernels
(flash, contiguous decode, paged decode and paged verify, float and int8
pools or lanes) at R = 2 q heads per kv head against ``repro.core.attention``
(the Pallas kernels have no GQA; JAX's model path groups q heads as (G, R),
so q head h reads kv head h // R), the card route's head flattening, the
launch plans' limits (R x Q query rows in the m16), ``_project_qkv`` with
qk-norm and RoPE at theta 1e6 against ``repro.core.blocks``, and reduced
qwen3-0.6b (2 layers, d_model 128, 4 q heads over 2 kv heads, head_dim 32)
through the bridge: prefill-chunk and decode logits and the engines' greedy
tokens against JAX's paged engine (float pools, int8 pools, speculative=3)
and contiguous engine.  Tolerances: fp32 1e-4 (``tests/test_kernels.py``)."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from paged_cases import paged_case, quant_pool_case

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.configs.base import ShapeConfig
from repro.core import attention as jattn
from repro.core import blocks as jblocks
from repro.core import layers as jlayers
from repro.core import model as jmodel
from repro.core import steps as jsteps
from repro.core.partition import ShardingPlan as JaxPlan
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.core import attention as tattn
from repro_torch.core import blocks, layers, model, steps
from repro_torch.core.partition import ShardingPlan
from repro_torch.kernels import build, ops
from repro_torch.kernels import decode_attention as k_decode
from repro_torch.kernels import flash_attention as k_flash
from repro_torch.launch import serve
from repro_torch.serving import Request, ServingEngine

TOL = dict(rtol=1e-4, atol=1e-4)
G, R, D = 2, 2, 32                   # kv heads, q heads per kv head, head_dim
H = G * R


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------- plain versions vs JAX
@pytest.mark.parametrize("sq,skv,q_off,window", [
    (16, 48, 32, 0), (23, 23, 0, 0), (16, 48, 32, 8), (5, 40, 11, 0)])
def test_flash_plain_gqa_matches_jax_core(sq, skv, q_off, window):
    rng = np.random.RandomState(sq + window)
    q = rng.randn(1, G, R, sq, D).astype(np.float32)
    k, v = (rng.randn(1, G, skv, D).astype(np.float32) for _ in range(2))
    got = ops.flash_attention(_t(q[0]).reshape(H, sq, D), _t(k[0]), _t(v[0]),
                              window=window, q_offset=q_off)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), window=window,
                                 q_offset=q_off)
    _close(got.reshape(1, G, R, sq, D), want)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_decode_plain_gqa_matches_jax_core(quant):
    """The contiguous decode over (B, G, S, D) lanes, float or fixed-scale
    int8 (dq 1/16; JAX reads the dequantized lanes), lengths >= 1."""
    rng = np.random.RandomState(3 + quant)
    B, S = 4, 40
    q = rng.randn(B, G, R, D).astype(np.float32)
    length = np.asarray([1, 17, 40, 9], np.int32)
    if quant:
        k, v = (rng.randint(-127, 128, (B, G, S, D)).astype(np.int8)
                for _ in range(2))
        got = ops.decode_attention_i8(_t(q).reshape(B, H, D),
                                      torch.from_numpy(k), torch.from_numpy(v),
                                      torch.from_numpy(length), 1 / 16)
        k, v = k.astype(np.float32) / 16, v.astype(np.float32) / 16
    else:
        k, v = (rng.randn(B, G, S, D).astype(np.float32) for _ in range(2))
        got = ops.decode_attention(_t(q).reshape(B, H, D), _t(k), _t(v),
                                   torch.from_numpy(length))
    slot_pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(slot_pos),
                                  jnp.asarray(length - 1))
    _close(got.reshape(B, G, R, D), want)


def _pools(rng, quant, n_pages, psz):
    if quant:
        kp, ks = quant_pool_case(rng, n_pages, G, psz, D)
        vp, vs = quant_pool_case(rng, n_pages, G, psz, D)
        return ((torch.from_numpy(kp), torch.from_numpy(vp)),
                dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs)),
                (jnp.asarray(kp), jnp.asarray(vp)),
                dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    kp, vp = (rng.randn(n_pages, G, psz, D).astype(np.float32)
              for _ in range(2))
    return (_t(kp), _t(vp)), {}, (jnp.asarray(kp), jnp.asarray(vp)), {}


@pytest.mark.parametrize("nq", [1, 8], ids=["decode", "verify-Q8"])
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_paged_plain_gqa_matches_jax_core(nq, quant):
    """Paged decode (nq 1) and verify at Q = 8 (R x Q = 16 rows, the most
    the card's m16 takes) over float or int8 pools through a shuffled
    block table; the deepest query of one slot passes n_max * psz."""
    rng = np.random.RandomState(10 * nq + quant)
    B, psz, n_max = 4, 8, 4
    n_pages = B * n_max + 1
    bt = paged_case(rng, B, n_max, n_pages)
    bt[0, 0] = 3                               # zero-scale rows (int8)
    length = np.asarray([6, 9, 31, 1], np.int32)
    q = rng.randn(B, G, R, nq, D).astype(np.float32)
    pools_t, sc_t, pools_j, sc_j = _pools(rng, quant, n_pages, psz)
    args_t = (*pools_t, torch.from_numpy(bt), torch.from_numpy(length))
    args_j = (*pools_j, jnp.asarray(bt), jnp.asarray(length - 1))
    if nq == 1:
        got = ops.paged_decode_attention(_t(q[:, :, :, 0]).reshape(B, H, D),
                                         *args_t, **sc_t)
        want = jattn.paged_decode_attention(jnp.asarray(q[:, :, :, 0]),
                                            *args_j, **sc_j)
        _close(got.reshape(B, G, R, D), want)
    else:
        got = ops.paged_verify_attention(_t(q).reshape(B, H, nq, D), *args_t,
                                         **sc_t)
        want = jattn.paged_verify_attention(jnp.asarray(q), *args_j, **sc_j)
        _close(got.reshape(B, G, R, nq, D), want)


def _head_probe(entry, B=2, S=16, psz=8):
    """q of ones over kv heads whose values are the constant 1 + kv head:
    every q head's output is the value of the kv head it reads.
    -> (G R,) that value per q head, from the plain version of ``entry``."""
    q = torch.ones(B, H, D)
    k = torch.zeros(B, G, S, D)
    v = (1.0 + torch.arange(G, dtype=torch.float32))[None, :, None, None] \
        .expand(B, G, S, D).contiguous()
    length = torch.full((B,), S, dtype=torch.int32)
    if entry == "flash":
        out = ops.flash_attention(q[0][:, None], k[0], v[0])[:, 0]
    elif entry == "decode":
        out = ops.decode_attention(q, k, v, length)
    else:
        n_max = S // psz
        pool = lambda t: t.reshape(B, G, n_max, psz, D).permute(0, 2, 1, 3, 4) \
            .reshape(B * n_max, G, psz, D).contiguous()          # noqa: E731
        bt = torch.arange(B * n_max, dtype=torch.int32).reshape(B, n_max)
        if entry == "paged_decode":
            out = ops.paged_decode_attention(q, pool(k), pool(v), bt, length)
        else:
            out = ops.paged_verify_attention(q[:, :, None], pool(k), pool(v),
                                             bt, length)[:, :, 0]
    return out[0, :, 0] if out.dim() == 3 else out[:, 0]


@pytest.mark.parametrize("entry", ["flash", "decode", "paged_decode",
                                   "paged_verify"])
def test_plain_gqa_reads_kv_head_h_div_r(entry):
    """q head h reads kv head h // R (JAX's (G, R) grouping), not h % R:
    with R = 2 over 2 kv heads, q heads 0, 1 read kv head 0 and 2, 3 kv
    head 1 (h % R would give 0, 1, 0, 1)."""
    got = _head_probe(entry)
    np.testing.assert_allclose(got.numpy(), [1.0, 1.0, 2.0, 2.0], atol=1e-6)


@contextlib.contextmanager
def _card_route(monkeypatch):
    """``core.attention``'s card branch on CPU tensors: the branch flattens
    q's (G, R) heads and calls ``kernels.ops``, whose wrappers run their
    plain versions on a CPU tensor."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    try:
        yield
    finally:
        monkeypatch.undo()


@pytest.mark.parametrize("entry", ["flash", "decode", "paged_decode",
                                   "paged_verify"])
def test_core_card_route_flattens_groups_as_the_plain_path(entry,
                                                           monkeypatch):
    """The card route hands the kernels q with G R heads (q head g R + r)
    and the G kv heads as they are: its output equals the plain path's
    grouped computation at R = 2 (verify at Q = 8)."""
    rng = np.random.RandomState(7)
    B, S, psz, n_max, Q = 3, 24, 8, 3, 8
    cur_pos = torch.tensor([0, 11, 23], dtype=torch.int32)
    if entry == "flash":
        q = _t(rng.randn(1, G, R, 16, D))
        k, v = _t(rng.randn(1, G, S, D)), _t(rng.randn(1, G, S, D))
        call = lambda: tattn.flash_attention(q, k, v, q_offset=8)  # noqa: E731
    elif entry == "decode":
        q = _t(rng.randn(B, G, R, D))
        k, v = _t(rng.randn(B, G, S, D)), _t(rng.randn(B, G, S, D))
        slot_pos = torch.arange(S, dtype=torch.int32).expand(B, S)
        call = lambda: tattn.decode_attention(q, k, v, slot_pos,  # noqa: E731
                                              cur_pos)
    else:
        n_pages = B * n_max + 1
        kp, vp = (_t(rng.randn(n_pages, G, psz, D)) for _ in range(2))
        bt = torch.from_numpy(paged_case(rng, B, n_max, n_pages))
        if entry == "paged_decode":
            q = _t(rng.randn(B, G, R, D))
            call = lambda: tattn.paged_decode_attention(  # noqa: E731
                q, kp, vp, bt, cur_pos)
        else:
            q = _t(rng.randn(B, G, R, Q, D))
            call = lambda: tattn.paged_verify_attention(  # noqa: E731
                q, kp, vp, bt, cur_pos)
    want = call()
    with _card_route(monkeypatch):
        got = call()
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("R_,Q,window,err,match", [
    (2, 9, 0, ValueError, "2 q heads per kv head x 9 queries = 18"),
    (3, 6, 0, ValueError, "3 q heads per kv head x 6 queries = 18"),
    (2, 9, 64, ValueError, "2 q heads per kv head x 9 queries = 18"),
])
def test_card_verify_route_refuses_what_no_kernel_takes(R_, Q, window, err,
                                                        match, monkeypatch):
    """R x Q query rows past the m16's 16 (the verify wrapper's plan)
    raise before a launch, with or without a sliding window, naming what
    is missing; R x Q = 16 reaches the kernel's C entry, the window with
    it.  The wrapper runs here with the device check and the kernel build
    taken out."""
    reached = []

    def check(t, name, ndim, dtypes):
        assert t.dim() == ndim and t.dtype in dtypes, name

    monkeypatch.setattr(k_decode.build, "check_cuda_tensor", check)
    monkeypatch.setattr(k_decode.build, "kernel_function",
                        lambda *a: reached.append(a[1]) or (lambda *b: 0))
    monkeypatch.setattr(k_decode.build, "stream_of", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())

    def verify(r, nq):
        q = torch.zeros(2, G * r, nq, 128, dtype=torch.bfloat16)
        pools = [torch.zeros(5, G, 16, 128, dtype=torch.bfloat16)
                 for _ in range(2)]
        return k_decode.paged_verify_attention(
            q, *pools, torch.zeros(2, 2, dtype=torch.int32),
            torch.ones(2, dtype=torch.int32), window=window)

    with pytest.raises(err, match=match):
        verify(R_, Q)
    assert reached == []
    verify(2, 8)
    assert reached == ["repro_paged_verify"]


# --------------------------------------------------------------- plans
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_paged_plan_refuses_rows_past_the_m16(quant, dt):
    """plan() takes group x nq <= 16 query rows of a kv head and refuses
    more with a message naming both, for either kernel (no fall-through to
    the plain version); 16 rows fit, shared memory sized for them."""
    for group, nq, h in ((2, 9, 16), (3, 6, 6), (4, 5, 8)):
        with pytest.raises(ValueError, match=f"{group} q heads per kv head x "
                                             f"{nq} queries = {group * nq} "
                                             f"query rows per slot"):
            k_decode.plan(8, h, nq, 128, 16, 16, dt, quant, group)
    p = k_decode.plan(8, 16, 8, 128, 16, 16, dt, quant, 2)
    if dt == torch.bfloat16:
        assert p.kernel == "mma"
        assert p.smem == k_decode._smem_bytes(128, quant, 16, p.nw, p.split)
        assert p.smem <= 232448
    else:
        assert (p.kernel, p.nw, p.split, p.smem) == ("simt", 4, 1, 0)
    with pytest.raises(ValueError, match="groups of 3"):
        k_decode.plan(8, 16, 1, 128, 16, 16, dt, quant, 3)


@pytest.mark.parametrize("nq", [1, 5, 8])
def test_paged_plan_sizes_clusters_by_kv_heads(nq):
    """qwen3's decode (B 8, 16 q heads over 8 kv heads, D 128, pages of 16):
    one cluster per (kv head, slot), so the split and warps are those of 8
    heads at group 1, and the inbox holds 2 nq rows."""
    gqa = k_decode.plan(8, 16, nq, 128, 16, 16, torch.bfloat16, False, 2)
    mha = k_decode.plan(8, 8, nq, 128, 16, 16, torch.bfloat16, False, 1)
    assert (gqa.nw, gqa.split) == (mha.nw, mha.split) == (4, 4)
    assert gqa.smem == k_decode._smem_bytes(128, False, 2 * nq, 4, 4)
    assert k_decode.contiguous_plan(8, 16, 256, 128, torch.bfloat16, False,
                                    2) == \
        k_decode.plan(8, 16, 1, 128, 256, 1, torch.bfloat16, False, 2)


@pytest.mark.parametrize("group,sq,want_rb,want_wq", [
    (1, 32, 1, 2), (2, 32, 2, 4), (2, 16, 2, 2), (2, 160, 2, 4),
    (4, 32, 4, 4), (8, 32, 4, 4), (5, 32, 1, 2), (12, 160, 4, 4)])
def test_flash_plan_puts_heads_of_a_group_on_one_block(group, sq, want_rb,
                                                       want_wq):
    """One block per row tile and rb q heads of one kv head (rb the largest
    divisor of the group up to 4), rb x row warps, at most 4 warps; the
    grid and the split counted in head groups."""
    H_ = 8 * group
    p = k_flash.plan(H_, sq, 256, 128, torch.bfloat16, 0, group)
    rb = k_flash.heads_per_block(group)
    wr = k_flash.row_warps(sq, rb)
    assert rb == want_rb and p.wq == want_wq == rb * wr <= 4
    row_tiles = -(-sq // (16 * wr))
    if p.split < 8 and p.split * 2 <= 4:
        assert (H_ // rb) * row_tiles * p.split >= 132
    assert p.smem == k_flash._smem_bytes(128, p.wq, p.split) <= 232448
    assert k_flash.plan(H_, sq, 256, 128, torch.float32, 0, group).kernel \
        == "simt"


@pytest.mark.parametrize("H_,group", [(16, 3), (12, 5), (8, 0)])
def test_flash_plan_refuses_groups_no_kernel_takes(H_, group):
    with pytest.raises(ValueError, match="q heads"):
        k_flash.plan(H_, 32, 256, 64, torch.bfloat16, 0, group)


def test_gqa_plans_mirror_the_kernel_sources():
    """The C entries check the same limits the plans apply: the flash
    block's row warps, and R x nq rows in the paged m16."""
    csrc = build.CSRC
    fl = (csrc / "flash_attention.cu").read_text()
    assert "for (int d = 2; d <= WQ_MAX; ++d)" in fl
    assert "return (sq + 15) / 16 < WQ_MAX / rb ? (sq + 15) / 16 : WQ_MAX / rb;" in fl
    assert "wq != rb * wr" in fl and "__launch_bounds__(WQ_MAX * 32)" in fl
    pd = (csrc / "paged_decode.cu").read_text()
    assert "mma_plan_fits(D, QUANT, R * nq, nw, split, smem)" in pd
    assert "rows >= 1 && rows <= 16" in pd
    assert "R * nq > 16" in pd


def test_paged_kernel_finds_each_rows_query_without_division():
    """The paged kernel's m16 row e (q head e // nq of the group, query e %
    nq) takes its query by the source's subtraction loop, not a runtime %:
    the loop, run as the source writes it, gives e % nq for every row of
    every group R and query count nq with R nq <= 16, and no step at R = 1."""
    pd = (build.CSRC / "paged_decode.cu").read_text()
    assert "for (int k = 1; k < R && i >= nq; ++k) i -= nq;" in pd
    assert "see[r] = e < nr ? min(length + i, n_max * psz) : 0;" in pd
    for R_ in range(1, 17):
        for nq in range(1, 16 // R_ + 1):
            for e in range(R_ * nq):
                i, k, steps = e, 1, 0
                while k < R_ and i >= nq:
                    i -= nq
                    k += 1
                    steps += 1
                assert i == e % nq, (R_, nq, e)
                assert R_ > 1 or steps == 0


class _Call:
    """The C entry a wrapper reached, with its arguments."""

    def __init__(self):
        self.args = None

    def __call__(self, *args):
        self.args = args
        return 0


@pytest.fixture
def card_stub(monkeypatch):
    """The wrappers with the card taken out: every check and the plan run,
    and the C entry records its arguments instead of launching."""
    call = _Call()

    def check(t, name, ndim, dtypes):
        if t.dim() != ndim or t.dtype not in dtypes or not t.is_contiguous():
            raise ValueError(f"{name}: {t.dim()} dims, {t.dtype}")

    monkeypatch.setattr(build, "check_cuda_tensor", check)
    monkeypatch.setattr(build, "kernel_function", lambda *a: call)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    return call


@pytest.mark.parametrize("entry", ["paged_decode", "paged_verify",
                                   "contiguous", "flash"])
def test_wrappers_hand_the_group_to_the_kernel(card_stub, entry):
    """16 q heads over 8 kv heads: the wrapper passes R = 2 right after H,
    and the plan it launches is the GQA plan."""
    B, Hq, Hk, Dq, psz, n_max = 8, 16, 8, 128, 16, 2
    bf = torch.bfloat16
    if entry == "flash":
        q = torch.zeros(Hq, 32, Dq, dtype=bf)
        k = torch.zeros(Hk, 256, Dq, dtype=bf)
        k_flash.flash_attention(q, k, k.clone(),
                                q_offset=torch.tensor([224], dtype=torch.int32))
        p = k_flash.plan(Hq, 32, 256, Dq, bf, 0, 2)
        assert card_stub.args[4:9] == (Hq, 2, 32, 256, Dq)
        assert card_stub.args[-5:-1] == (1, p.wq, p.split, p.smem)
        return
    length = torch.ones(B, dtype=torch.int32)
    if entry == "contiguous":
        q = torch.zeros(B, Hq, Dq, dtype=bf)
        k = torch.zeros(B, Hk, 256, Dq, dtype=bf)
        k_decode.decode_attention(q, k, k.clone(), length)
        p = k_decode.contiguous_plan(B, Hq, 256, Dq, bf, False, 2)
        assert card_stub.args[5:10] == (B, Hq, 2, 256, Dq)
    else:
        nq = 1 if entry == "paged_decode" else 8
        q = torch.zeros(B, Hq, nq, Dq, dtype=bf)
        pools = [torch.zeros(B * n_max, Hk, psz, Dq, dtype=bf)
                 for _ in range(2)]
        bt = torch.zeros(B, n_max, dtype=torch.int32)
        if nq == 1:
            k_decode.paged_decode_attention(q[:, :, 0].contiguous(), *pools,
                                            bt, length)
            assert card_stub.args[6:9] == (B, Hq, 2)
        else:
            k_decode.paged_verify_attention(q, *pools, bt, length)
            assert card_stub.args[6:10] == (B, Hq, 2, nq)
        p = k_decode.plan(B, Hq, nq, Dq, psz, n_max, bf, False, 2)
    assert card_stub.args[-4:-1] == (p.nw, p.split, p.smem)


@pytest.mark.parametrize("entry", ["paged", "contiguous", "flash"])
def test_wrappers_refuse_kv_heads_that_do_not_divide(card_stub, entry):
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="divid"):
        if entry == "flash":
            k_flash.flash_attention(torch.zeros(6, 32, 64, dtype=bf),
                                    torch.zeros(4, 64, 64, dtype=bf),
                                    torch.zeros(4, 64, 64, dtype=bf))
        elif entry == "contiguous":
            k_decode.decode_attention(torch.zeros(2, 6, 64, dtype=bf),
                                      torch.zeros(2, 4, 64, 64, dtype=bf),
                                      torch.zeros(2, 4, 64, 64, dtype=bf),
                                      torch.ones(2, dtype=torch.int32))
        else:
            k_decode.paged_decode_attention(
                torch.zeros(2, 6, 64, dtype=bf),
                torch.zeros(4, 4, 8, 64, dtype=bf),
                torch.zeros(4, 4, 8, 64, dtype=bf),
                torch.zeros(2, 2, dtype=torch.int32),
                torch.ones(2, dtype=torch.int32))


# --------------------------------------------------- qk-norm and rope
@pytest.fixture(scope="module")
def qwen3():
    """Reduced qwen3 in fp32 from JAX's init, weights x25 (greedy decoding
    does not collapse onto one token) and random q_norm/k_norm scales (JAX
    inits them to zeros), through the bridge."""
    jcfg = jax_reduced(jax_get_config("qwen3-0.6b"), dtype="float32")
    jplan = JaxPlan(tp=1, kv_cache_dtype="float32")
    jp = jax.tree_util.tree_map(lambda a: a * 25,
                                jmodel.init_params(jcfg, jplan))
    rng = np.random.RandomState(5)
    for group in jp["stacks"]:
        for layer in group:
            for name in ("q_norm", "k_norm"):
                shape = layer["attn"][name].shape
                layer["attn"][name] = jnp.asarray(
                    0.3 * rng.randn(*shape).astype(np.float32))
    cfg = reduced(get_config("qwen3-0.6b"), dtype="float32")
    plan = ShardingPlan(kv_cache_dtype="float32")
    return jcfg, jp, cfg, params_from_jax(cfg, plan, _np_tree(jp),
                                          device="cpu")


def test_reduced_qwen3_is_jax_s():
    cfg = reduced(get_config("qwen3-0.6b"))
    jcfg = jax_reduced(jax_get_config("qwen3-0.6b"))
    shape = lambda c: (c.n_layers, c.d_model, c.n_heads,  # noqa: E731
                       c.n_kv_heads, c.head_dim_, c.d_ff, c.vocab_size,
                       c.qk_norm, c.rope_theta, c.tie_embeddings)
    assert shape(cfg) == shape(jcfg) == (2, 128, 4, 2, 32, 256, 512, True,
                                         1e6, True)
    full = get_config("qwen3-0.6b")
    assert shape(full) == shape(jax_get_config("qwen3-0.6b")) == \
        (28, 1024, 16, 8, 128, 3072, 151936, True, 1e6, True)


def test_qwen3_params_from_jax_carry_the_qk_norm_scales(qwen3):
    jcfg, jp, cfg, p = qwen3
    attn = p["stacks"][0][0]["attn"]
    assert attn["q_norm"].shape == attn["k_norm"].shape == (2, 32)
    np.testing.assert_array_equal(
        attn["k_norm"].numpy(), np.asarray(jp["stacks"][0][0]["attn"]["k_norm"]))
    ours = model.init_params(cfg, ShardingPlan(), device="cpu")
    assert [(k, tuple(v.shape)) for k, v in model.tree_paths(ours)] == \
        [(k, tuple(v.shape)) for k, v in model.tree_paths(p)]
    assert not ours["stacks"][0][0]["attn"]["q_norm"].any()       # zeros


def test_project_qkv_with_qk_norm_then_rope_matches_jax(qwen3):
    """q and k RMS-normed per head over head_dim, then rotated at theta
    1e6, at positions up to the config's 40960."""
    jcfg, jp, cfg, p = qwen3
    rng = np.random.RandomState(1)
    xn = rng.randn(2, 5, cfg.d_model).astype(np.float32)
    pos = np.stack([np.arange(5), 40955 + np.arange(5)]).astype(np.int32)
    jpa = jax.tree_util.tree_map(lambda a: a[1],
                                 jp["stacks"][0][0]["attn"])    # rep 1
    pa = {k: v[1] for k, v in p["stacks"][0][0]["attn"].items()}
    q, k, v = blocks._project_qkv(_t(xn), pa, cfg)
    jq, jk, jv = jblocks._project_qkv(jnp.asarray(xn), jpa, jcfg, None)
    for a, b in ((q, jq), (k, jk), (v, jv)):
        _close(a, b)
    q, k = blocks._rope_qk(q, k, torch.from_numpy(pos), cfg)
    jq, jk = jblocks._rope_qk(jq, jk, jnp.asarray(pos), jcfg)
    _close(q, jq)
    _close(k, jk)


def test_apply_rope_at_theta_1e6_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(3, 7, 128).astype(np.float32)
    pos = np.asarray([0, 1, 2, 1000, 8191, 32768, 40959], np.int32)
    _close(layers.apply_rope(_t(x), torch.from_numpy(pos), 1e6),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))


# --------------------------------------------------------------- model
PSZ, CHUNK, N_MAX, N_PAGES = 8, 16, 6, 13


@pytest.mark.parametrize("kvd", ["float32", "int8"])
def test_qwen3_prefill_chunks_then_decode_match_jax(qwen3, mesh1, kvd):
    """forward_prefill_chunk over a 21-token prompt (two chunks), then three
    decode steps, through the steps JAX jits, float32 or int8 pools."""
    jcfg, jp, cfg, p = qwen3
    jplan, plan = JaxPlan(tp=1, kv_cache_dtype=kvd), \
        ShardingPlan(kv_cache_dtype=kvd)
    jchunk, _, _ = jsteps.make_prefill_chunk_step(jcfg, jplan, mesh1, CHUNK,
                                                  N_PAGES, PSZ, N_MAX)
    jdec, _, _ = jsteps.make_paged_decode_step(jcfg, jplan, mesh1, 2, N_PAGES,
                                               PSZ, N_MAX)
    jchunk, jdec = jax.jit(jchunk), jax.jit(jdec)
    jcache = jsteps.zero_paged_cache_for(jcfg, jplan, mesh1, N_PAGES, PSZ)
    chunk = steps.make_prefill_chunk_step(cfg, plan, CHUNK, N_MAX)
    dec = steps.make_paged_decode_step(cfg, plan, 2, N_MAX)
    cache = steps.zero_paged_cache_for(cfg, plan, N_PAGES, PSZ, "cpu")
    rng = np.random.RandomState(0)
    prompt = rng.randint(2, cfg.vocab_size, 21).astype(np.int32)
    bt_row = np.asarray([7, 2, 11, 4, 9, 1], np.int32)
    L = len(prompt)
    tol = TOL if kvd == "float32" else dict(rtol=1e-3, atol=2e-3)
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
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    bt = np.stack([bt_row, np.zeros(N_MAX, np.int32)])
    tok, pos = int(np.argmax(np.asarray(jl[0]))), L
    for _ in range(3):
        toks = np.asarray([[tok], [0]], np.int32)
        pos_v = np.asarray([pos, 0], np.int32)
        jl, jcache = jdec(jp, jcache, jnp.asarray(toks), jnp.asarray(pos_v),
                          jnp.asarray(bt))
        tl, cache = dec(p, cache, torch.from_numpy(toks).long(),
                        torch.from_numpy(pos_v), torch.from_numpy(bt))
        np.testing.assert_allclose(tl[0:1].numpy(), np.asarray(jl[0:1]),
                                   **tol)
        tok, pos = int(np.argmax(np.asarray(jl[0]))), pos + 1


# --------------------------------------------------------------- engines
SB, SLOTS = 64, 3
# (prompt length, max_new_tokens): lengths on both sides of the 8-token
# page and the 16-token chunk, more requests than slots
REQS = [(5, 9), (17, 6), (9, 12), (24, 8), (33, 7)]
# repetitive prompts (a shared prefix, tiled motifs): prompt lookup drafts
# on them


def _prompts(vocab, spec):
    rng = np.random.RandomState(3)
    if not spec:
        return [(rng.randint(2, vocab, L).astype(np.int32), m)
                for L, m in REQS]
    shared = rng.randint(2, vocab, 8)
    out = []
    for i, (_, m) in enumerate(REQS):
        motif = rng.randint(2, vocab, 3 + i % 2)
        out.append((np.concatenate([shared, np.tile(motif, 4)[:6 + i]])
                    .astype(np.int32), m))
    return out


def _serve(eng, cls, prompts):
    reqs = [cls(rid=i, prompt=p.copy(), max_new_tokens=m)
            for i, (p, m) in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_ticks=2000)
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs]


@pytest.mark.parametrize("kvd,k", [("float32", 0), ("int8", 0),
                                   ("float32", 3)],
                         ids=["float-pools", "int8-pools", "speculative-3"])
def test_qwen3_paged_engine_matches_jax(qwen3, mesh1, kvd, k):
    """Greedy tokens and ticks against JAX's paged engine in its serial
    loop (no prefix cache, as the port's drafts come from the request's
    own context)."""
    jcfg, jp, cfg, p = qwen3
    jplan, plan = JaxPlan(tp=1, kv_cache_dtype=kvd), \
        ShardingPlan(kv_cache_dtype=kvd)
    prompts = _prompts(cfg.vocab_size, spec=bool(k))
    kw = dict(page_size=PSZ, prefill_chunk=CHUNK, speculative=k,
              overlap=False)
    jeng = JaxEngine.build_paged(jcfg, jplan, mesh1, SLOTS, SB, jp,
                                 prefix_cache=False, **kw)
    want = _serve(jeng, JaxRequest, prompts)
    eng = ServingEngine.build_paged(cfg, plan, SLOTS, SB, p, device="cpu",
                                    **kw)
    got = _serve(eng, Request, prompts)
    assert got == want
    assert len({t for r in got for t in r}) > 10            # not degenerate
    assert eng.stats.ticks == jeng.stats.ticks
    if k:
        st, jst = eng.stats, jeng.stats
        assert st.spec_steps > 0
        assert (st.spec_drafted, st.spec_accepted) == \
            (jst.spec_drafted, jst.spec_accepted)
    assert eng.drain() == 0
    assert eng.allocator.n_free == eng.allocator.n_pages - 1


def test_qwen3_contiguous_engine_matches_jax(qwen3, mesh1):
    jcfg, jp, cfg, p = qwen3
    jplan = JaxPlan(tp=1, kv_cache_dtype="float32")
    dec, _, _ = jsteps.make_decode_step(jcfg, jplan, mesh1,
                                        ShapeConfig("s", "decode", SB, SLOTS))
    pre, _, _ = jsteps.make_prefill_step(jcfg, jplan, mesh1,
                                         ShapeConfig("p", "decode", SB, 1))
    jeng = JaxEngine(jcfg, jplan, mesh1, SLOTS, SB, jp, jax.jit(pre),
                     jax.jit(dec))
    prompts = _prompts(cfg.vocab_size, spec=False)
    want = _serve(jeng, JaxRequest, prompts)
    eng = ServingEngine(cfg, ShardingPlan(kv_cache_dtype="float32"), SLOTS,
                        SB, p, device="cpu")
    got = _serve(eng, Request, prompts)
    assert got == want
    assert (eng.stats.ticks, eng.stats.prefills) == \
        (jeng.stats.ticks, jeng.stats.prefills)


def test_launcher_serves_qwen3_smoke_on_cpu(capsys):
    serve.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                "--kv-dtype", "fp32", "--requests", "3", "--slots", "2",
                "--seq-budget", "64", "--paged", "--page-size", "8",
                "--prefill-chunk", "16", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "arch=qwen3-0.6b-smoke" in out and "engine=paged" in out


def test_qwen3_lm_head_plan_takes_the_full_vocab():
    """The tied head's NT product at qwen3's width (N = 151936 = 1187 x
    128, K 1024) has a bf16 plan at every row count a step hands it, and
    greedy_ids takes a vocab that wide."""
    from repro_torch.kernels import matmul as k_matmul
    from repro_torch.serving.sampler import greedy_ids
    for M in (8, 16, 32, 40, 160):
        p = k_matmul.plan(M, 151936, 1024, torch.bfloat16, True)
        assert p.kernel == "mma"
    logits = torch.zeros(2, 151936 + 64)
    logits[0, 151935], logits[1, 151936] = 1.0, 5.0    # the pad never wins
    assert greedy_ids(logits, 151936).tolist() == [151935, 0]
