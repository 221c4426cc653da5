"""The port's host-offload executor (``repro_torch.runtime.offload``)
against the JAX package's (``repro.runtime.offload``) on the same numpy
layer groups, on the CPU: the streamed result (fp32 1e-5), the stats'
fields and counts, ``required_bandwidth``, and the refusals (a ``"cuda"``
default without a card; a group that cannot be pinned raises at
construction, never streaming from pageable memory).  The side-stream
overlap itself runs only on the card (``chip_smoke.py``'s offload phase)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import offload as joff
from repro_torch.runtime import offload as toff

TOL = dict(rtol=1e-5, atol=1e-5)
E, F, B, S = 32, 64, 2, 8


def _groups(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"w1": rng.randn(E, F).astype(np.float32) * 0.2,
             "w2": rng.randn(F, E).astype(np.float32) * 0.2}
            for _ in range(n)]


@jax.jit
def _jax_group(x, p):
    return x + jax.nn.silu(x @ p["w1"]) @ p["w2"]


def _torch_group(x, p):
    return x + torch.nn.functional.silu(x @ p["w1"]) @ p["w2"]


@pytest.mark.parametrize("n_groups", [1, 2, 3, 8])
def test_stream_forward_matches_jax(n_groups):
    groups = _groups(n_groups, seed=n_groups)
    x = np.random.RandomState(9).randn(B, S, E).astype(np.float32)
    jex = joff.OffloadExecutor(groups)
    want = np.asarray(jex.stream_forward(jnp.asarray(x),
                                         [_jax_group] * n_groups))
    tex = toff.OffloadExecutor(groups, device="cpu")
    got = tex.stream_forward(torch.from_numpy(x), [_torch_group] * n_groups)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the all-resident run equals the streamed one exactly
    ref = torch.from_numpy(x)
    for g in groups:
        ref = _torch_group(ref, {k: torch.from_numpy(v) for k, v in g.items()})
    assert torch.equal(got, ref)
    assert tex.stats.groups == jex.stats.groups == n_groups


def test_stats_have_jax_s_fields_and_count_every_call():
    assert [f.name for f in dataclasses.fields(toff.StreamStats)] == \
        [f.name for f in dataclasses.fields(joff.StreamStats)]
    assert toff.StreamStats() == toff.StreamStats(0, 0.0, 0.0)
    groups = _groups(3)
    tex = toff.OffloadExecutor(groups, device="cpu")
    x = torch.zeros(B, E)
    for _ in range(2):
        tex.stream_forward(x, [_torch_group] * 3)
    st = tex.stats
    assert st.groups == 6 and st.stage_s >= 0.0 and st.compute_s >= 0.0
    assert tex.timeline == []               # events are the card's
    with pytest.raises(AssertionError):
        tex.stream_forward(x, [_torch_group] * 2)


def test_staged_groups_are_copies_of_the_host_groups():
    """On the CPU each group the functions see is a fresh copy: writing to
    it leaves the host group as it was (JAX's device_put semantics; on the
    card the copies land in the two staging buffers)."""
    groups = _groups(2)
    tex = toff.OffloadExecutor(groups, device="cpu")
    seen = []

    def scribble(x, p):
        seen.append(p["w1"])
        p["w1"].fill_(7.0)
        return x

    tex.stream_forward(torch.zeros(B, E), [scribble] * 2)
    for g, host, s in zip(groups, tex.host_groups, seen):
        np.testing.assert_array_equal(host["w1"].numpy(), g["w1"])
        assert s.data_ptr() != host["w1"].data_ptr()


def test_nested_groups_and_tensor_leaves():
    rng = np.random.RandomState(2)
    groups = [[torch.from_numpy(rng.randn(E, E).astype(np.float32)),
               (rng.randn(E).astype(np.float32),)] for _ in range(2)]

    def fn(x, p):
        w, (b,) = p
        assert isinstance(b, torch.Tensor)
        return x @ w + b

    x = torch.from_numpy(rng.randn(B, E).astype(np.float32))
    got = toff.OffloadExecutor(groups, device="cpu").stream_forward(x, [fn] * 2)
    want = x
    for w, (b,) in groups:
        want = want @ w + torch.from_numpy(b)
    assert torch.equal(got, want)
    assert toff.tree_leaves({"a": [1, (2, 3)], "b": 4}) == [1, 2, 3, 4]


@pytest.mark.parametrize("nbytes,secs", [(4.2e6, 1e-3), (2.11e9, 8.7e-4),
                                         (1.0, 0.0), (0.0, 2.0)])
def test_required_bandwidth_equals_jax(nbytes, secs):
    assert toff.required_bandwidth(nbytes, secs) == \
        joff.required_bandwidth(nbytes, secs)


def test_cuda_default_raises_without_a_card(monkeypatch):
    with pytest.raises(ValueError, match="a card's"):
        toff.host_link_rate(_groups(1)[0], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        toff.OffloadExecutor(_groups(1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        toff.host_link_rate(_groups(1)[0])


def test_unpinnable_group_raises_at_construction(monkeypatch):
    """Built for the card, the executor pins every host group first; a
    group that cannot be pinned raises there (no card here: pinning
    fails), before any stream or copy exists."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def never(*a, **k):
        raise AssertionError("the executor went past pinning")

    monkeypatch.setattr(torch.cuda, "Stream", never)
    with pytest.raises(RuntimeError):
        toff.OffloadExecutor(_groups(2), device="cuda")

    class Unpinned(torch.Tensor):
        def pin_memory(self):
            return self                      # pinning that silently fails

    t = torch.zeros(4).as_subclass(Unpinned)
    with pytest.raises(RuntimeError, match="could not be pinned"):
        toff.OffloadExecutor([{"w": t}], device="cuda")
