"""Port parity: the batched interior-point QP solver (``dgsqp_torch.solvers.qp``).

The same QPs (numpy, fixed seed) go through the JAX package's ``solve_qp`` vmapped on
the CPU and through the port's batched ``solve_qp`` on the CPU in float64: primal and
dual solutions agree within 1e-8, and the ``ok`` certificate and the IPM iteration
counts are equal (the same IPM decisions).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgsqp_tpu.solvers.qp import solve_qp as jax_solve_qp
from dgsqp_torch.solvers.qp import solve_qp as torch_solve_qp

from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-8


def _random_qps(rng, B, n, m):
    X = rng.standard_normal((B, n, n))
    Q = X @ np.swapaxes(X, 1, 2) / n + 0.1 * np.eye(n)
    q = rng.standard_normal((B, n))
    A = rng.standard_normal((B, m, n))
    x_feas = rng.standard_normal((B, n)) * 0.1
    b = np.einsum('bmn,bn->bm', A, x_feas) + rng.uniform(0.01, 1.0, (B, m))
    A[:, 0] = 0.0                          # one degenerate (all-zero) row
    return Q, q, A, b


def _compare(sol_j, sol_t):
    # within 1e-8, absolute or relative to the value (a dual can be ~1e12 on a game
    # whose warm start is far from its solution)
    np.testing.assert_allclose(sol_t.x.numpy(), np.asarray(sol_j.x), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(sol_t.lam.numpy(), np.asarray(sol_j.lam), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(sol_t.ok.numpy(), np.asarray(sol_j.ok))
    np.testing.assert_array_equal(sol_t.iters.numpy(), np.asarray(sol_j.iters))


@pytest.mark.parametrize('correctors', [0, 2])
@pytest.mark.parametrize('warm', [False, True])
def test_random_batch_matches_jax(correctors, warm):
    rng = np.random.default_rng(10 + correctors + 2 * warm)
    B, n, m = 6, 10, 27
    Q, q, A, b = _random_qps(rng, B, n, m)
    w = (rng.uniform(0.01, 2.0, (B, m)), rng.uniform(0.01, 2.0, (B, m))) if warm else None

    def jax_one(Q_, q_, A_, b_, w_):
        return jax_solve_qp(Q_, q_, A_, b_, tol=1e-8, max_iters=30, polish_iters=4,
                            warm=w_, correctors=correctors)
    w_j = None if w is None else tuple(jnp.asarray(a) for a in w)
    sol_j = jax.vmap(jax_one)(jnp.asarray(Q), jnp.asarray(q), jnp.asarray(A),
                              jnp.asarray(b), w_j)
    w_t = None if w is None else tuple(torch.tensor(a) for a in w)
    sol_t = torch_solve_qp(torch.tensor(Q), torch.tensor(q), torch.tensor(A),
                           torch.tensor(b), tol=1e-8, max_iters=30, polish_iters=4,
                           warm=w_t, correctors=correctors)
    _compare(sol_j, sol_t)
    if not warm:
        assert np.asarray(sol_j.ok).all()


@pytest.fixture(scope='module')
def chicane_qp():
    """The convexified QP of the bench problem (N=5) at the first iterate of 4 games
    (built by the port, whose derivatives match the JAX package's to ~1e-14; both QP
    solvers then get these bit-identical arrays)."""
    from dgsqp_torch.harness.bench_setup import build_bench_batch, build_bench_solver
    from dgsqp_torch.utils.math import regularized_convexification
    sc, solver = build_bench_solver(horizon=5, dtype=torch.float64, device='cpu')
    u0, l0, x0, up = build_bench_batch(sc, solver, 4, seed=0)
    Q, q, G, g, _ = solver.problem.evaluate(u0, l0, x0, up)
    Qh = regularized_convexification(Q, 1e-3, method='ns')
    return (Qh.numpy(), q.numpy(), G.numpy(), -g.numpy(), solver._qp_box, solver._qp_pairs)


@pytest.mark.parametrize('warm', [False, True])
def test_chicane_qp_box_pairs_correctors_polish(chicane_qp, warm):
    """The bench's QP options: box/pair row folding, 2 correctors, warm start, polish."""
    Q, q, A, b, box, pairs = chicane_qp
    rng = np.random.default_rng(5)
    w = (rng.uniform(0.01, 2.0, b.shape), rng.uniform(0.01, 2.0, b.shape)) if warm else None

    def jax_one(Q_, q_, A_, b_, w_):
        return jax_solve_qp(Q_, q_, A_, b_, tol=1e-8, max_iters=25, polish_iters=4,
                            warm=w_, box=box, pairs=pairs, correctors=2)
    w_j = None if w is None else tuple(jnp.asarray(a) for a in w)
    sol_j = jax.vmap(jax_one)(*(jnp.asarray(a) for a in (Q, q, A, b)), w_j)
    w_t = None if w is None else tuple(torch.tensor(a) for a in w)
    sol_t = torch_solve_qp(*(torch.tensor(a) for a in (Q, q, A, b)), tol=1e-8,
                           max_iters=25, polish_iters=4, warm=w_t, box=box, pairs=pairs,
                           correctors=2)
    _compare(sol_j, sol_t)
    # the row folding is exact: the unfolded solve gives the same solution
    sol_plain = torch_solve_qp(*(torch.tensor(a) for a in (Q, q, A, b)), tol=1e-8,
                               max_iters=25, polish_iters=4, warm=w_t, correctors=2)
    np.testing.assert_allclose(sol_plain.x.numpy(), sol_t.x.numpy(), rtol=0, atol=TOL)


def test_polish_pads_candidates_to_a_multiple_of_8():
    """K = 49 candidates (n = 70 -> n // 2 + 14) pads 7 always-inactive rows scattered to
    the sentinel index m and dropped; the result still matches JAX."""
    rng = np.random.default_rng(3)
    Q, q, A, b = _random_qps(rng, 2, 70, 80)
    sol_j = jax.vmap(lambda *a: jax_solve_qp(*a, tol=1e-8, max_iters=40))(
        *(jnp.asarray(a) for a in (Q, q, A, b)))
    sol_t = torch_solve_qp(*(torch.tensor(a) for a in (Q, q, A, b)), tol=1e-8, max_iters=40)
    _compare(sol_j, sol_t)


@pytest.mark.parametrize('correctors', [0, 2])
def test_indefinite_branch_matches_jax(correctors):
    """``indefinite=True``: a symmetric Q with negative eigenvalues, the normal matrix
    factorized by Levenberg-shifted LU, no polish.  Box-bounded, so that every QP has a
    KKT point the iteration can reach."""
    rng = np.random.default_rng(20 + correctors)
    B, n = 6, 10
    X = rng.standard_normal((B, n, n))
    Q = 0.5 * (X + np.swapaxes(X, 1, 2))
    assert (np.linalg.eigvalsh(Q)[:, 0] < -0.5).all()
    q = rng.standard_normal((B, n))
    A = np.broadcast_to(np.concatenate([np.eye(n), -np.eye(n)]), (B, 2 * n, n)).copy()
    b = np.ones((B, 2 * n))
    sol_j = jax.vmap(lambda *a: jax_solve_qp(*a, tol=1e-8, max_iters=50, indefinite=True,
                                             correctors=correctors))(
        *(jnp.asarray(a) for a in (Q, q, A, b)))
    sol_t = torch_solve_qp(*(torch.tensor(a) for a in (Q, q, A, b)), tol=1e-8, max_iters=50,
                           indefinite=True, correctors=correctors)
    _compare(sol_j, sol_t)
    np.testing.assert_allclose(sol_t.t.numpy(), np.asarray(sol_j.t), rtol=TOL, atol=TOL)
    assert np.asarray(sol_j.ok).any()


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_eigh_convexification_gives_nan_where_eigh_fails(dtype):
    """The eigenvalue clipping on a batch with a matrix the eigendecomposition cannot
    take (a NaN entry) gives NaN for that matrix and the JAX package's values for the
    others, as the JAX package's ``eigh`` does, where ``torch.linalg.eigh`` raises for
    the whole batch."""
    from dgsqp_tpu.utils.math import regularized_convexification as jax_conv
    from dgsqp_torch.utils.math import regularized_convexification
    rng = np.random.default_rng(7)
    A = rng.normal(size=(5, 12, 12))
    A[3, 2, 4] = A[3, 4, 2] = np.nan
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    with pytest.raises(torch.linalg.LinAlgError):
        torch.linalg.eigh(torch.as_tensor(A, dtype=dtype))
    Qh = regularized_convexification(torch.as_tensor(A, dtype=dtype), 1e-3).numpy()
    Qj = np.asarray(jax_conv(jnp.asarray(A.astype(np_dtype)), 1e-3))
    assert np.isnan(Qh[3]).all() and np.isnan(Qj[3]).all()
    ok = [0, 1, 2, 4]
    assert np.isfinite(Qh[ok]).all()
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    np.testing.assert_allclose(Qh[ok], Qj[ok], rtol=0, atol=tol * np.abs(Qj[ok]).max())
