"""The port's model against the JAX package's on the same weights: JAX's
``init_params`` loaded through ``bridge.params_from_jax``, then prefill
chunks and decode steps over the paged cache.  Logits and pool contents
must agree at fp32 1e-4 and bf16 2e-2 (reduced tinyllama-42m: 2 layers,
d_model 128)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import model as jmodel
from repro.core import steps as jsteps
from repro.core.partition import ShardingPlan as JaxPlan
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.core import model, steps
from repro_torch.core.partition import ShardingPlan

PSZ, CHUNK, N_MAX, N_PAGES, B = 8, 16, 6, 13, 2


def _configs(dtype):
    return (reduced(get_config("tinyllama-42m"), dtype=dtype),
            jax_reduced(jax_get_config("tinyllama-42m"), dtype=dtype))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_params_from_jax_keeps_reps_and_strips_the_tp_axis():
    cfg, jcfg = _configs("float32")
    jp = jmodel.init_params(jcfg, JaxPlan(tp=1, kv_cache_dtype="float32"))
    p = params_from_jax(cfg, ShardingPlan(kv_cache_dtype="float32"),
                        _np_tree(jp), device="cpu")
    layer = p["stacks"][0][0]
    assert layer["attn"]["wq"].shape == (2, 128, 4, 32)       # JAX (2,1,128,4,32)
    assert layer["ln1"]["scale"].shape == (2, 128)            # replicated
    assert p["embed"]["table"].shape == (512, 128)            # JAX (1,512,128)
    np.testing.assert_array_equal(layer["attn"]["wq"].numpy(),
                                  np.asarray(jp["stacks"][0][0]["attn"]["wq"])[:, 0])
    ours = model.init_params(cfg, ShardingPlan(), device="cpu")
    assert [(k, tuple(v.shape)) for k, v in model.tree_paths(ours)] == \
        [(k, tuple(v.shape)) for k, v in model.tree_paths(p)]
    assert all(v.dtype == torch.float32 for _, v in model.tree_paths(ours))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_prefill_chunks_then_decode_match_jax(mesh1, dtype, tol):
    cfg, jcfg = _configs(dtype)
    jplan = JaxPlan(tp=1, kv_cache_dtype=dtype)
    plan = ShardingPlan(kv_cache_dtype=dtype)
    jp = jmodel.init_params(jcfg, jplan)
    p = params_from_jax(cfg, plan, _np_tree(jp), device="cpu")

    jchunk, _, _ = jsteps.make_prefill_chunk_step(jcfg, jplan, mesh1, CHUNK,
                                                  N_PAGES, PSZ, N_MAX)
    jdec, _, _ = jsteps.make_paged_decode_step(jcfg, jplan, mesh1, B, N_PAGES,
                                               PSZ, N_MAX)
    jchunk, jdec = jax.jit(jchunk), jax.jit(jdec)
    jcache = jsteps.zero_paged_cache_for(jcfg, jplan, mesh1, N_PAGES, PSZ)
    chunk = steps.make_prefill_chunk_step(cfg, plan, CHUNK, N_MAX)
    dec = steps.make_paged_decode_step(cfg, plan, B, N_MAX)
    cache = steps.zero_paged_cache_for(cfg, plan, N_PAGES, PSZ, "cpu")

    rng = np.random.RandomState(0)
    prompt = rng.randint(2, cfg.vocab_size, 21).astype(np.int32)   # 2 chunks
    bt_row = np.asarray([7, 2, 11, 4, 9, 1], np.int32)             # shuffled
    L = len(prompt)

    def close(a, b):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), rtol=tol, atol=tol)

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
    close(tl, jl)

    # decode: row 0 continues the prompt, row 1 is an idle lane on scratch
    bt = np.stack([bt_row, np.zeros(N_MAX, np.int32)])
    tok, pos = int(np.argmax(np.asarray(jl[0], np.float32))), L
    for _ in range(3):
        toks = np.asarray([[tok], [0]], np.int32)
        pos_v = np.asarray([pos, 0], np.int32)
        jl, jcache = jdec(jp, jcache, jnp.asarray(toks), jnp.asarray(pos_v),
                          jnp.asarray(bt))
        tl, cache = dec(p, cache, torch.from_numpy(toks).long(),
                        torch.from_numpy(pos_v), torch.from_numpy(bt))
        close(tl[0:1], jl[0:1])
        tok, pos = int(np.argmax(np.asarray(jl[0], np.float32))), pos + 1

    # pool contents of every live page (the scratch page holds garbage)
    jkv = jcache[0][0]["kv"]
    for name in ("kp", "vp"):
        live = bt_row[:-(-pos // PSZ)]
        close(cache[0][0]["kv"][name][:, live], np.asarray(jkv[name])[:, 0][:, live])


def test_steps_keep_their_shapes():
    """Request lengths reach the steps only as data: a call with another
    shape is refused, never silently served by a differently shaped step."""
    cfg, _ = _configs("float32")
    plan = ShardingPlan(kv_cache_dtype="float32")
    p = model.init_params(cfg, plan, device="cpu")
    cache = steps.zero_paged_cache_for(cfg, plan, N_PAGES, PSZ, "cpu")
    dec = steps.make_paged_decode_step(cfg, plan, B, N_MAX)
    chunk = steps.make_prefill_chunk_step(cfg, plan, CHUNK, N_MAX)
    bt = torch.zeros((B, N_MAX), dtype=torch.int32)
    with pytest.raises(ValueError, match="tokens"):
        dec(p, cache, torch.zeros((B + 1, 1), dtype=torch.long),
            torch.zeros(B + 1, dtype=torch.int32), bt)
    with pytest.raises(ValueError, match="tokens"):
        chunk(p, cache, torch.zeros((1, CHUNK - 1), dtype=torch.long), 0, 0,
              bt[:1])
    with pytest.raises(ValueError, match="last_idx"):
        chunk(p, cache, torch.zeros((1, CHUNK), dtype=torch.long), 0, CHUNK,
              bt[:1])
    logits, _ = dec(p, cache, torch.zeros((B, 1), dtype=torch.long),
                    torch.zeros(B, dtype=torch.int32), bt)
    assert logits.shape == (B, cfg.vocab_size)
