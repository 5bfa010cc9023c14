"""Port parity: the ALGAMES baseline on the CPU in float64.

* At one random point (states, inputs, dynamics multipliers, duals >= 0, a per-row
  penalty vector), on the integrator game of ``tests/test_algames.py`` and on the
  chicane duel at N=4 (its joint constraint stack from ``joint_constraints_for_algames``,
  on the JAX package's track tables): ``_constraints``, ``_dyn_residual``, ``_G``,
  ``_G_prox`` and the Newton matrix with the residual of ``_newton_system`` (Gauss-Newton
  and ``dynamics_hessians=True``) within 1e-10 of each quantity's scale; ``joint_constraints_for_algames`` lists the
  same rows.
* ``solve_batch_traced`` for 8 outer iterations on four games: every traced quantity of
  every iteration (status, iterations and Newton solves equal, the others within 1e-7
  of their scale), then the result.
* ``solve_batch_chunked``: statuses, iterations and Newton solves equal, ``u`` within
  1e-8; the host interface converges and certifies the KKT conditions as
  ``tests/test_algames.py``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgsqp_tpu.harness.scenarios import build_chicane_scenario as jax_chicane
from dgsqp_tpu.harness.scenarios import joint_constraints_for_algames as jax_joint
from dgsqp_tpu.solvers.algames import ALGAMES as JaxALGAMES
from dgsqp_tpu.solvers.solver_types import ALGAMESParams as JaxParams
from dgsqp_torch import interop
from dgsqp_torch.harness.scenarios import build_chicane_scenario, joint_constraints_for_algames
from dgsqp_torch.solvers.algames import CONV_ABS, CONV_REL, RUNNING, ALGAMES, ALGAMESResult
from dgsqp_torch.solvers.solver_types import ALGAMESParams
from dgsqp_torch.types import VehicleState

from test_torch_v2_games import DT, N, jax_game, torch_game
from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

GAMES = 4
PARAMS = dict(outer_iters=30, newton_iters=50, line_search_iters=50, ineq_tol=1e-6,
              eq_tol=1e-6, opt_tol=1e-6, rho=1.0, gamma=10.0, beta=0.01, tau=0.5,
              q_reg=1e-3, u_reg=1e-3)


def integrator_solvers(**kw):
    p = dict(PARAMS, N=N, dt=DT, **kw)
    joint, costs, shared, bounds = jax_game()
    js = JaxALGAMES(joint, costs, shared, bounds, JaxParams(**p), print_method=None)
    joint, costs, shared, bounds = torch_game()
    ts = ALGAMES(joint, costs, shared, bounds, ALGAMESParams(**p), print_method=None,
                 dtype=torch.float64, device='cpu')
    return js, ts


def chicane_solvers(Nc=4, **kw):
    jsc = jax_chicane(N=Nc, theta_deg=45.0)
    sc = build_chicane_scenario(N=Nc, theta_deg=45.0)
    interop.load_track_tables(sc.track, np.asarray(jsc.track._kp),
                              np.asarray(jsc.track._cum_angle))
    p = dict(PARAMS, N=Nc, dt=sc.dt, **kw)
    js = JaxALGAMES(jsc.joint_model, jsc.costs, jax_joint(jsc), jsc.bounds, JaxParams(**p),
                    print_method=None)
    ts = ALGAMES(sc.joint_model, sc.costs, joint_constraints_for_algames(sc), sc.bounds,
                 ALGAMESParams(**p), print_method=None, dtype=torch.float64, device='cpu')
    return js, ts


def point(ts, seed=0):
    """A random (y, x0, u_prev, lam, rho, q_reg, u_reg) batch."""
    rng = np.random.default_rng(seed)
    n_y = ts.N * (ts.n_q + ts.n_u) + ts.M * ts.N * ts.n_q
    y = 0.3 * rng.normal(size=(GAMES, n_y))
    x0 = 0.3 * rng.normal(size=(GAMES, ts.n_q))
    up = 0.1 * rng.normal(size=(GAMES, ts.n_u))
    lam = np.maximum(rng.normal(size=(GAMES, ts.n_c)), 0.0)
    rho = np.where(rng.random((GAMES, ts.n_c)) < 0.3, 0.0, 10.0)
    q_reg = np.full(GAMES, 1e-3) * (1 + np.arange(GAMES)) ** 4
    return y, x0, up, lam, rho, q_reg, 2 * q_reg


def _close(b, a, tol, msg=''):
    a = np.asarray(a)
    np.testing.assert_allclose(np.asarray(b), a, rtol=0,
                               atol=tol * max(1.0, float(np.abs(a).max())), err_msg=msg)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize('game', ['integrator', 'chicane'])
@pytest.mark.parametrize('dyn_hess', [False, True], ids=['gauss_newton', 'exact'])
def test_pieces_match_jax(game, dyn_hess):
    js, ts = (integrator_solvers if game == 'integrator' else chicane_solvers)(
        dynamics_hessians=dyn_hess)
    assert ts.n_c == js.n_c
    y, x0, up, lam, rho, q_reg, u_reg = pt = point(ts)
    jp = [jnp.asarray(a) for a in pt]
    tp = [_t(a) for a in pt]

    def both(name, jfn, tfn):
        _close(tfn(*tp).numpy(), jax.jit(jax.vmap(jfn))(*jp), 1e-10, name)

    def unpack_j(f):
        return lambda y, x, u_p, *rest: f(*js._unpack(y, x)[:2], u_p)

    both('constraints', unpack_j(js._constraints),
         lambda y, x, u_p, *r: ts._constraints(*ts._unpack(y, x)[:2], u_p))
    both('dyn_residual', lambda y, x, *r: js._dyn_residual(*js._unpack(y, x)[:2]),
         lambda y, x, *r: ts._dyn_residual(*ts._unpack(y, x)[:2]))
    both('G', lambda y, x, u_p, l, r, *_: js._G(y, x, u_p, l, r),
         lambda y, x, u_p, l, r, *_: ts._G(y, x, u_p, l, r))
    both('G_prox', lambda y, x, u_p, l, r, qr, ur: js._G_prox(y, x, u_p, l, r, qr, ur, 0.9 * y),
         lambda y, x, u_p, l, r, qr, ur: ts._G_prox(y, x, u_p, l, r, qr, ur, 0.9 * y))
    # the port's Newton system gives the matrix and the residual from the same pushes
    both('newton_matrix', js._newton_matrix, lambda *a: ts._newton_system(*a)[0])
    both('newton_residual', lambda y, x, u_p, l, r, *_: js._G(y, x, u_p, l, r),
         lambda *a: ts._newton_system(*a)[1])


def test_joint_constraints_list_the_same_rows():
    jsc = jax_chicane(N=4, theta_deg=45.0)
    sc = build_chicane_scenario(N=4, theta_deg=45.0)
    jl, tl = jax_joint(jsc), joint_constraints_for_algames(sc)
    assert len(tl) == len(jl) == 5
    x = np.random.default_rng(1).normal(size=12)
    u, um = np.full(4, 0.3), np.full(4, 0.1)
    for k in range(4):
        np.testing.assert_allclose(
            tl[k](_t(x), _t(u), _t(um)).numpy(),
            np.asarray(jl[k](jnp.asarray(x), jnp.asarray(u), jnp.asarray(um))), rtol=0,
            atol=1e-12)
    np.testing.assert_allclose(tl[4](_t(x)).numpy(), np.asarray(jl[4](jnp.asarray(x))),
                               rtol=0, atol=1e-12)
    # stages with the same parts share one closure: stage 0 has no collision row
    assert tl[1] is tl[2] and tl[0] is not tl[1]


def integrator_batch(seed=0):
    rng = np.random.default_rng(seed)
    x0 = 0.2 * rng.normal(size=(GAMES, 2))
    u_ws = 0.3 * rng.normal(size=(GAMES, N, 2))
    q_ws = np.zeros((GAMES, N + 1, 2))
    q_ws[:, 0] = x0
    for k in range(N):
        q_ws[:, k + 1] = q_ws[:, k] + DT * u_ws[:, k]
    return q_ws, u_ws, x0, np.zeros((GAMES, 2))


def _same_result(res_t, res_j, tol):
    assert isinstance(res_t, ALGAMESResult)
    for f in ('status', 'iters', 'newton_solves'):
        np.testing.assert_array_equal(getattr(res_t, f).numpy(), np.asarray(getattr(res_j, f)),
                                      err_msg=f)
    for f in ('q', 'u', 'lam', 'm', 'p_feas', 'comp', 'stat'):
        _close(getattr(res_t, f).numpy(), getattr(res_j, f), tol, f)


def test_traced_outer_iterations_match_jax():
    js, ts = integrator_solvers()
    args = integrator_batch()
    res_j, tr_j = js.solve_batch_traced(*(jnp.asarray(a) for a in args), num_iters=8,
                                        record_iterates=True)
    res_t, tr_t = ts.solve_batch_traced(*(_t(a) for a in args), num_iters=8,
                                        record_iterates=True)
    assert set(tr_t) == set(tr_j)
    for k in tr_j:
        a = np.asarray(tr_j[k])
        if a.dtype.kind in 'biu':
            np.testing.assert_array_equal(tr_t[k].numpy(), a, err_msg=k)
        else:
            _close(tr_t[k].numpy(), a, 1e-7, k)
    _same_result(res_t, res_j, 1e-7)
    assert (res_t.status == CONV_ABS).all()


def test_chunked_solve_matches_jax():
    js, ts = integrator_solvers(outer_iters=12)
    args = integrator_batch(seed=1)
    res_j = js.solve_batch_chunked(*(jnp.asarray(a) for a in args))
    res_t = ts.solve_batch_chunked(*(_t(a) for a in args))
    _same_result(res_t, res_j, 1e-8)
    assert not (res_t.status == RUNNING).any()
    assert ts.last_chunk_history and ts.last_chunk_history[0]['batch'] == GAMES


def test_host_interface_certifies_kkt():
    _, ts = integrator_solvers(outer_iters=50)
    ts.set_warm_start(np.zeros((N + 1, 2)), np.zeros((N, 2)))
    info = ts.solve([VehicleState(), VehicleState()])
    assert info['msg'] in ('conv_abs_tol', 'conv_rel_tol'), info
    assert info['cond']['p_feas'] < 1e-6 and info['cond']['stat'] < 1e-6
    assert info['newton_solves'] > 0 and ts.q_pred.shape == (N + 1, 2)
    ts.step([VehicleState(), VehicleState()])
    assert ts.q_ws.shape == (N + 1, 2) and ts.u_ws.shape == (N, 2)
