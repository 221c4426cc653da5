"""The port's layer and attention functions against their JAX twins in
``repro.core.layers`` / ``repro.core.attention``, on the same numpy inputs,
at fp32 1e-4 and bf16 2e-2."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention as jattn
from repro.core import layers as jlayers
from repro_torch.core import attention as tattn
from repro_torch.core import layers as tlayers

DTYPES = [("float32", jnp.float32, torch.float32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16)]


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else \
        dict(rtol=1e-4, atol=1e-4)


def _both(x, jdt, tdt):
    x = np.asarray(x, np.float32)
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(got, want, name):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(name))


@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_rmsnorm(name, jdt, tdt):
    rng = np.random.RandomState(0)
    xj, xt = _both(rng.randn(2, 5, 128), jdt, tdt)
    sj, st = _both(rng.randn(128) * 0.1, jdt, tdt)
    _close(tlayers.rmsnorm(xt, st, 1e-6), jlayers.rmsnorm(xj, sj, 1e-6), name)


@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_apply_rope(name, jdt, tdt):
    rng = np.random.RandomState(1)
    xj, xt = _both(rng.randn(2, 4, 7, 32), jdt, tdt)
    pos = rng.randint(0, 500, (2, 1, 7)).astype(np.int32)
    _close(tlayers.apply_rope(xt, torch.from_numpy(pos), 10_000.0),
           jlayers.apply_rope(xj, jnp.asarray(pos), 10_000.0), name)


@pytest.mark.parametrize("q_offset,window,causal", [
    (0, 0, True), (16, 0, True), (40, 8, True), (0, 0, False)])
@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_flash_attention(q_offset, window, causal, name, jdt, tdt):
    """Grouped layout (B, G, R, Sq, D) with R = 2 q heads per kv slot."""
    rng = np.random.RandomState(q_offset + window)
    qj, qt = _both(rng.randn(2, 2, 2, 16, 32), jdt, tdt)
    kj, kt = _both(rng.randn(2, 2, 64, 32), jdt, tdt)
    vj, vt = _both(rng.randn(2, 2, 64, 32), jdt, tdt)
    _close(tattn.flash_attention(qt, kt, vt, causal=causal, window=window,
                                 q_offset=q_offset),
           jattn.flash_attention(qj, kj, vj, causal=causal, window=window,
                                 q_offset=q_offset), name)


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_decode_attention(window, name, jdt, tdt):
    rng = np.random.RandomState(2 + window)
    qj, qt = _both(rng.randn(3, 2, 2, 32), jdt, tdt)
    kj, kt = _both(rng.randn(3, 2, 20, 32), jdt, tdt)
    vj, vt = _both(rng.randn(3, 2, 20, 32), jdt, tdt)
    slot_pos = np.where(rng.rand(3, 20) < 0.8, np.arange(20), -1).astype(np.int32)
    cur = np.asarray([5, 19, 0], np.int32)
    _close(tattn.decode_attention(qt, kt, vt, torch.from_numpy(slot_pos),
                                  torch.from_numpy(cur), window=window),
           jattn.decode_attention(qj, kj, vj, jnp.asarray(slot_pos),
                                  jnp.asarray(cur), window=window), name)


def _pools(rng, n_pages=10, G=2, psz=4, D=32, B=3, n_max=3):
    bt = (rng.permutation(n_pages - 1)[:B * n_max] + 1).reshape(B, n_max)
    return (rng.randn(n_pages, G, psz, D), rng.randn(n_pages, G, psz, D),
            bt.astype(np.int32))


def test_gather_pages():
    rng = np.random.RandomState(3)
    kp, _, bt = _pools(rng)
    kp = kp.astype(np.float32)
    got = tattn.gather_pages(torch.from_numpy(kp), torch.from_numpy(bt))
    want = jattn.gather_pages(jnp.asarray(kp), jnp.asarray(bt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_paged_decode_attention_inclusive_cur_pos(name, jdt, tdt):
    """``cur_pos`` is the inclusive position of the current token: position
    cur_pos itself attends (cur_pos 0 sees exactly one key)."""
    rng = np.random.RandomState(4)
    kp, vp, bt = _pools(rng)
    qj, qt = _both(rng.randn(3, 2, 2, 32), jdt, tdt)
    kj, kt = _both(kp, jdt, tdt)
    vj, vt = _both(vp, jdt, tdt)
    cur = np.asarray([0, 4, 11], np.int32)       # page boundaries and the end
    got = tattn.paged_decode_attention(qt, kt, vt, torch.from_numpy(bt),
                                       torch.from_numpy(cur))
    _close(got, jattn.paged_decode_attention(qj, kj, vj, jnp.asarray(bt),
                                             jnp.asarray(cur)), name)
    # cur_pos 0: the output is the value row at position 0
    np.testing.assert_allclose(got[0, :, 0].float().numpy(),
                               vt[bt[0, 0], :, 0].float().numpy(), **_tol(name))
