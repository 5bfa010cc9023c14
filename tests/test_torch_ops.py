"""Port parity: batched Cholesky and Cholesky solve (``dgsqp_torch.ops.linalg``).

The plain versions, which the CPU path runs, are held against the JAX package's
wrappers ``dgsqp_tpu.ops.linalg_pallas.cholesky``/``cho_solve`` vmapped on the CPU (where
they run their ``jnp`` reference).  The CUDA kernels are held against the plain versions
in ``test_torch_cuda.py``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgsqp_tpu.ops import linalg_pallas as jlin
from dgsqp_torch.ops import linalg

RTOL = 1e-12


def _spd(rng, B, n):
    X = rng.standard_normal((B, n, n))
    return X @ np.swapaxes(X, 1, 2) / n + np.eye(n)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize('B', [1, 5])
@pytest.mark.parametrize('n', [7, 24, 64])
def test_cholesky_plain_matches_jax(B, n):
    A = _spd(np.random.default_rng(n + B), B, n)
    L_j = np.asarray(jax.vmap(jlin.cholesky)(jnp.asarray(A)))
    L_t = linalg.cholesky(torch.tensor(A)).numpy()
    assert _rel(L_t, L_j) < RTOL
    assert np.all(np.triu(L_t, 1) == 0)


@pytest.mark.parametrize('B', [1, 5])
@pytest.mark.parametrize('n', [7, 24, 64])
@pytest.mark.parametrize('k', [1, 8])
def test_cho_solve_plain_matches_jax(B, n, k):
    rng = np.random.default_rng(100 * n + 10 * B + k)
    A = _spd(rng, B, n)
    L = np.linalg.cholesky(A)
    b = rng.standard_normal((B, n) if k == 1 else (B, n, k))
    x_j = np.asarray(jax.vmap(jlin.cho_solve)(jnp.asarray(L), jnp.asarray(b)))
    x_t = linalg.cho_solve(torch.tensor(L), torch.tensor(b)).numpy()
    assert x_t.shape == b.shape
    assert _rel(x_t, x_j) < RTOL


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor is dispatched to the plain version: no kernel launch is counted."""
    A = torch.tensor(_spd(np.random.default_rng(0), 3, 6))
    before = (linalg.cholesky.launches, linalg.cho_solve.launches)
    L = linalg.cholesky(A)
    linalg.cho_solve(L, torch.ones(3, 6, dtype=A.dtype))
    assert (linalg.cholesky.launches, linalg.cho_solve.launches) == before
    assert torch.equal(L, linalg.cholesky_plain(A))


def test_non_pd_input_gives_nan_not_an_error():
    """Masked-out games may carry a non-PD matrix: the factor turns non-finite, as
    ``jnp.linalg.cholesky`` does, and nothing raises."""
    A = torch.tensor(_spd(np.random.default_rng(1), 2, 5))
    A[1] = -A[1]
    L = linalg.cholesky(A)
    assert torch.isfinite(L[0]).all() and not torch.isfinite(L[1]).all()


def test_shared_memory_sizes_cover_the_main_path():
    """The kernels keep the whole matrix in shared memory: n = 100 (bench) and n = 150
    (the approximate game) fit in Hopper's 227 KB in both dtypes; too large an n is a
    clear error, never a fallback."""
    for n in (64, 100, 150):
        for it in (4, 8):
            assert linalg.chol_smem_bytes(n, it) <= linalg.SMEM_OPTIN_BYTES
            assert linalg.cho_solve_smem_bytes(n, it) <= linalg.SMEM_OPTIN_BYTES
    assert linalg.chol_smem_bytes(200, 8) > linalg.SMEM_OPTIN_BYTES
