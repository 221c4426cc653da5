"""Paged-pool inputs shared by the port's kernel tests: numpy arrays from a
seeded RandomState, handed to both the JAX package and the port."""
import numpy as np


def quant_pool_case(rng, n_pages, H, psz, D):
    """An int8 pool with per-row scales; page 3's last rows have scale 0
    (a recycled page's reset rows) and dequantize to exact zeros."""
    pool = rng.randint(-127, 128, (n_pages, H, psz, D)).astype(np.int8)
    scales = (rng.rand(n_pages, psz) * 0.05).astype(np.float32)
    scales[3, psz // 2:] = 0.0
    return pool, scales


def paged_case(rng, B, n_max, n_pages):
    """A shuffled block table whose last row is an idle lane on scratch
    page 0."""
    bt = (rng.permutation(n_pages - 1)[:B * n_max] + 1).reshape(B, n_max)
    bt[-1] = 0
    return bt.astype(np.int32)


def gather_np(pool, bt):
    """(n_pages, H, psz, D) through bt (B, n_max) -> (B, H, n_max*psz, D)."""
    B, n_max = bt.shape
    _, H, psz, D = pool.shape
    g = pool[bt.reshape(-1)].reshape(B, n_max, H, psz, D)
    return g.transpose(0, 2, 1, 3, 4).reshape(B, H, n_max * psz, D)
