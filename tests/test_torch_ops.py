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

from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-12


def _spd(rng, B, n):
    X = rng.standard_normal((B, n, n))
    return X @ np.swapaxes(X, 1, 2) / n + np.eye(n)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


# 37 and 100 are ragged for the blocked kernels: not a multiple of the 8-column panel of
# chol.cu nor of the 32-row blocks of cho_solve.cu; k = 33 is one past a 32-column tile
@pytest.mark.parametrize('B', [1, 5])
@pytest.mark.parametrize('n', [7, 24, 37, 64, 100])
def test_cholesky_plain_matches_jax(B, n):
    A = _spd(np.random.default_rng(n + B), B, n)
    L_j = np.asarray(jax.vmap(jlin.cholesky)(jnp.asarray(A)))
    L_t = linalg.cholesky(torch.tensor(A)).numpy()
    assert _rel(L_t, L_j) < RTOL
    assert np.all(np.triu(L_t, 1) == 0)


@pytest.mark.parametrize('B', [1, 5])
@pytest.mark.parametrize('n', [7, 24, 37, 64, 100])
@pytest.mark.parametrize('k', [1, 8, 33])
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
    (the approximate game) fit in Hopper's 227 KB in both dtypes, for every number of
    right-hand sides; too large an n is a clear error, never a fallback."""
    for n in (64, 100, 150):
        for it in (4, 8):
            assert linalg.chol_smem_bytes(n, it) <= linalg.SMEM_OPTIN_BYTES
            assert linalg.chol_smem_bytes(n, it) >= n * n * it
            for k in (1, 8, linalg.WARP_PATH_MAX_K, linalg.WARP_PATH_MAX_K + 1, 33, 64, 500):
                assert n * n * it <= linalg.cho_solve_smem_bytes(n, it, k) \
                    <= linalg.SMEM_OPTIN_BYTES
    assert linalg.chol_smem_bytes(200, 8) > linalg.SMEM_OPTIN_BYTES
    assert linalg.cho_solve_smem_bytes(200, 8) > linalg.SMEM_OPTIN_BYTES


@pytest.mark.parametrize('itemsize', [4, 8])
def test_row_stride_keeps_rows_aligned_and_off_the_same_banks(itemsize):
    """The stride the kernels share: rows start on 16-byte boundaries, hold n elements
    rounded up to 4, and lie an odd number of 16-byte chunks apart."""
    vec = 16 // itemsize
    for n in range(1, 257):
        ld = linalg.row_stride(n, itemsize)
        assert ld % vec == 0 and (ld // vec) % 2 == 1
        assert (n + 3) // 4 * 4 <= ld <= (n + 3) // 4 * 4 + vec


@pytest.mark.parametrize('itemsize', [4, 8])
def test_cho_solve_plan_is_a_pure_function_of_n_k_dtype(itemsize):
    """Which of the two cho_solve kernels runs is decided from (n, k, dtype) alone, with
    no card: few right-hand sides take the warp path, many the column path, and the
    main path's shapes land where the kernels were designed for them."""
    before = (linalg.cholesky.launches, linalg.cho_solve.launches)
    for n in (1, 37, 64, 100, 150):
        for k in (1, 2, 8, linalg.WARP_PATH_MAX_K, linalg.WARP_PATH_MAX_K + 1, 33, 64, 65):
            path, width, smem = linalg.cho_solve_plan(n, k, itemsize)
            assert (path, width, smem) == linalg.cho_solve_plan(n, k, itemsize)
            assert path == ('warp' if k <= linalg.WARP_PATH_MAX_K else 'column')
            if path == 'warp':
                assert width == min(k, linalg.WARP_PATH_WARPS)
            else:
                assert width in (32, linalg.COLUMN_TILE) and (k > 32 or width == 32)
            assert smem == linalg.cho_solve_smem_bytes(n, itemsize, k)
    assert linalg.cho_solve_plan(100, 1, itemsize)[:2] == ('warp', 1)
    assert linalg.cho_solve_plan(64, 1, itemsize)[:2] == ('warp', 1)
    assert linalg.cho_solve_plan(100, 64, itemsize)[:2] == ('column', 64)
    # n = 150 in float64 leaves room for a 32-column tile only
    assert linalg.cho_solve_plan(150, 64, 8)[:2] == ('column', 32)
    assert (linalg.cholesky.launches, linalg.cho_solve.launches) == before


def test_shared_memory_limit_is_raised_once_per_kernel_and_largest_size():
    """The wrappers ask for a kernel's shared-memory limit to be raised on its first
    launch and when a larger size comes, not on every launch."""
    class Wrapper:
        attr_sets = 0
    key = ('test-kernel', 'warp', torch.float32, 0)
    try:
        asked = [linalg._needs_attr(Wrapper, key, smem)
                 for smem in (40000, 40000, 17000, 40000, 90000, 40000, 90000)]
        assert asked == [1, 0, 0, 0, 1, 0, 0]
        assert Wrapper.attr_sets == 2
        assert linalg._needs_attr(Wrapper, key[:1] + ('column',) + key[2:], 40000) == 1
    finally:
        for k in [k for k in linalg._attr_smem if k[0] == 'test-kernel']:
            del linalg._attr_smem[k]
