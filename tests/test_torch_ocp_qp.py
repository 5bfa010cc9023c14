"""Port parity: the Riccati OCP-QP and the equality and elastic QPs, on the CPU in
float64, against the JAX package on the problems of ``tests/test_ocp_qp.py`` (N = 6,
nx = 4, nv = 2, mi = 6).

* ``_lqr_solve``: the states and inputs within 1e-12 of the JAX package's.
* ``solve_ocp_qp`` (active constraints; moderate; a batch of two): the same ``ok`` and
  iteration counts, x, v and the duals within ``SOL_ATOL`` of the JAX package's, and
  the JAX test's KKT checks on the port's solution.
* ``solve_eq_qp`` on the same problems assembled densely: x, lam, nu, ok and iterations
  against the JAX package's; ``solve_elastic_qp`` on a feasible and an infeasible
  problem likewise; ``solve_qp_batch`` is ``solve_qp``.
* A stage block that is not positive definite: the factor is NaN in both packages, and
  both end not ``ok``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgsqp_tpu.solvers import ocp_qp as jocp
from dgsqp_tpu.solvers import qp as jqp
from dgsqp_torch.solvers import ocp_qp as tocp
from dgsqp_torch.solvers import qp as tqp

from test_ocp_qp import N, NV, NX, _dense_equivalent, _problem
from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

# float64 on both sides with the same iterations: rounding only
SOL_ATOL = 1e-9


def _t(a):
    """One problem as a batch of one."""
    return torch.as_tensor(np.array(a))[None]


def _close(a, b, what, atol=SOL_ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol, err_msg=what)


def _same(jsol, tsol, fields, atol=SOL_ATOL, batch=0):
    assert bool(np.asarray(jsol.ok)) == bool(tsol.ok[batch])
    assert int(np.asarray(jsol.iters)) == int(tsol.iters[batch])
    for f in fields:
        _close(getattr(tsol, f)[batch].numpy(), getattr(jsol, f), f, atol)


def test_lqr_solve_matches_jax():
    p = _problem(seed=1)
    x, v = jocp._lqr_solve(*p[:8], p[11])
    xt, vt = tocp._lqr_solve(*map(_t, p[:8]), _t(p[11]))
    _close(xt[0].numpy(), x, 'x', 1e-12)
    _close(vt[0].numpy(), v, 'v', 1e-12)


def test_ocp_qp_active_constraints_match_jax_and_kkt():
    p = _problem(seed=2, active=True)
    sol_j = jocp.solve_ocp_qp(*p, tol=1e-10)
    sol = tocp.solve_ocp_qp(*map(_t, p), tol=1e-10)
    assert bool(sol.ok[0])
    _same(sol_j, sol, ('x', 'v', 'lam'))

    # the JAX test's KKT checks on the port's solution
    H, h, A_in, b_in, Eq, d = map(np.asarray, _dense_equivalent(*p))
    z = np.concatenate([sol.x[0].numpy().ravel(), sol.v[0].numpy().ravel()])
    lam = sol.lam[0].numpy().ravel()
    assert np.abs(Eq @ z - d).max() < 1e-8
    gap = A_in @ z - b_in
    assert gap.max() < 1e-6
    assert (lam >= 0).all() and np.abs(lam * gap).max() < 1e-5
    grad = H @ z + h + A_in.T @ lam
    Z = np.linalg.svd(Eq)[2].T[:, Eq.shape[0]:]
    assert np.linalg.norm(Z.T @ grad, ord=np.inf) < 1e-5
    assert gap.max() > -1e-4


def test_ocp_qp_matches_dense_eq_qp_and_jax():
    A, B, g, Qx, S, Rv, qx, rv, D, E, b, x0 = _problem(seed=5, active=False)
    b = jnp.where(b >= 50.0, 8.0, b)
    p = (A, B, g, Qx, S, Rv, qx, rv, D, E, b, x0)
    sol = tocp.solve_ocp_qp(*map(_t, p), tol=1e-10)
    _same(jocp.solve_ocp_qp(*p, tol=1e-10), sol, ('x', 'v', 'lam'))

    dense_p = _dense_equivalent(*p)
    dense_j = jqp.solve_eq_qp(*dense_p, tol=1e-10)
    dense = tqp.solve_eq_qp(*map(_t, dense_p), tol=1e-10)
    assert bool(dense.ok[0])
    _same(dense_j, dense, ('x', 'lam', 'nu'))
    n = dense_p[1].shape[0]
    x_d = dense.x[0, :(N + 1) * NX].numpy().reshape(N + 1, NX)
    v_d = dense.x[0, (N + 1) * NX:n].numpy().reshape(N, NV)
    _close(sol.x[0].numpy(), x_d, 'x', 1e-5)
    _close(sol.v[0].numpy(), v_d, 'v', 1e-5)


def test_ocp_qp_batched_matches_jax_vmap_and_singles():
    probs = [_problem(seed=s) for s in (3, 4)]
    batched = [torch.as_tensor(np.stack([np.asarray(p[i]) for p in probs]))
               for i in range(12)]
    sols = tocp.solve_ocp_qp(*batched, tol=1e-9)
    assert bool(sols.ok.all())
    jsols = jax.vmap(lambda *a: jocp.solve_ocp_qp(*a, tol=1e-9))(
        *(jnp.stack([p[i] for p in probs]) for i in range(12)))
    for i, p in enumerate(probs):
        single = tocp.solve_ocp_qp(*map(_t, p), tol=1e-9)
        _close(sols.v[i].numpy(), single.v[0].numpy(), 'v', 1e-12)
        assert int(sols.iters[i]) == int(single.iters[0]) == int(jsols.iters[i])
        _close(sols.v[i].numpy(), jsols.v[i], 'v')


@pytest.mark.parametrize('seed,active', [(2, True), (5, False), (7, True)])
def test_eq_qp_matches_jax(seed, active):
    dense_p = _dense_equivalent(*_problem(seed=seed, active=active))
    sol_j = jqp.solve_eq_qp(*dense_p, tol=1e-9)
    sol = tqp.solve_eq_qp(*map(_t, dense_p), tol=1e-9)
    # lam and nu of a problem that stops at the iteration cap are those of an
    # unconverged iterate: held only where the solve certified
    _same(sol_j, sol, ('x', 'lam', 'nu') if bool(sol_j.ok) else ('x',))


def test_ruiz_equilibrate_with_equality_block_matches_jax():
    H, h, A_in, b_in, Eq, d = _dense_equivalent(*_problem(seed=2))
    ref = jqp._ruiz_equilibrate(H, A_in, Eq)
    out = tqp._ruiz_equilibrate(_t(H), _t(A_in), _t(Eq))
    assert len(out) == len(ref) == 3
    for a, b in zip(out, ref):
        _close(a[0].numpy(), b, 'scaling', 1e-13)


@pytest.mark.parametrize('feasible', [True, False])
def test_elastic_qp_matches_jax(feasible):
    H, h, A_in, b_in, _, _ = map(np.asarray, _dense_equivalent(*_problem(seed=2)))
    if not feasible:
        # two contradicting rows: x_0 <= -1 and -x_0 <= -1
        row = np.zeros((2, A_in.shape[1]))
        row[0, 0], row[1, 0] = 1.0, -1.0
        A_in = np.concatenate([A_in, row])
        b_in = np.concatenate([b_in, [-1.0, -1.0]])
    sol_j = jqp.solve_elastic_qp(*map(jnp.asarray, (H, h, A_in, b_in)))
    sol = tqp.solve_elastic_qp(*map(_t, (H, h, A_in, b_in)))
    _same(sol_j, sol, ('x', 'lam', 't'), atol=1e-7)


def test_solve_qp_batch_is_solve_qp():
    H, h, A_in, b_in, _, _ = _dense_equivalent(*_problem(seed=2))
    args = [torch.as_tensor(np.stack([np.asarray(a)] * 2)) for a in (H, h, A_in, b_in)]
    a = tqp.solve_qp_batch(*args, tol=1e-8, max_iters=50)
    b = tqp.solve_qp(*args, tol=1e-8, max_iters=50)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_indefinite_stage_block_fails_as_in_jax():
    """A stage input block that is not positive definite: ``jnp.linalg.cholesky``
    returns NaN, and the port's ``cholesky_ex`` factor is made NaN, so both solves end
    not ok, with the same iteration count."""
    A, B, g, Qx, S, Rv, qx, rv, D, E, b, x0 = _problem(seed=2)
    Rv = Rv.at[3].set(-1e6 * jnp.eye(NV))
    p = (A, B, g, Qx, S, Rv, qx, rv, D, E, b, x0)
    sol_j = jocp.solve_ocp_qp(*p, tol=1e-10)
    sol = tocp.solve_ocp_qp(*map(_t, p), tol=1e-10)
    assert not bool(sol_j.ok) and not bool(sol.ok[0])
    assert int(sol_j.iters) == int(sol.iters[0])
    assert not np.isfinite(float(sol_j.res)) and not torch.isfinite(sol.res[0])
    L = tqp.cholesky_nan(torch.stack([-torch.eye(NV), torch.eye(NV)]).double())
    assert torch.isnan(L[0]).all() and torch.equal(L[1], torch.eye(NV).double())
