"""Port parity: iterated best response (``IBR``) on the CPU in float64.

On the integrator game of ``tests/test_torch_v2_games.py`` (a shared coupling row
x0 + x1 <= 1 at every stage, input boxes), and on a variant whose shared row is stated
twice (so the least-squares multiplier problem is rank-deficient beyond its zeroed
inactive columns), four games from a numpy seed:

* ``_br_step`` of each agent: the updated joint input, the agent's duals and its KKT
  residual within 1e-8 of the JAX package's;
* ``_opponent_duals`` at the best-response point of a sweep (the coupling rows active):
  within 1e-8 (the minimum-norm solution with ``rcond=None``'s cut-off), also in the
  rank-deficient game, where both packages split the duplicated row's multiplier;
* ``_response_sensitivities``: S_o within 1e-7 of the JAX package's;
* one Gauss-Seidel sweep (``_solve_core``, ``ibr_iters=1``) with and without ``use_ps``:
  ``u``/``delta`` within 1e-7, ``converged`` equal;
* the host interface converges to the game's Nash equilibrium as ``tests/test_ibr.py``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgsqp_tpu.dynamics import DynamicsConfig as JaxDynamicsConfig
from dgsqp_tpu.dynamics import IntegratorModel as JaxIntegratorModel
from dgsqp_tpu.dynamics import MultiAgentDynamicsModel as JaxMultiAgent
from dgsqp_tpu.solvers.ibr import IBR as JaxIBR
from dgsqp_tpu.solvers.solver_types import IBRParams as JaxParams
from dgsqp_tpu.types import VehicleState as JaxVehicleState
from dgsqp_torch.dynamics import DynamicsConfig, IntegratorModel, MultiAgentDynamicsModel
from dgsqp_torch.solvers.ibr import IBR
from dgsqp_torch.solvers.solver_types import IBRParams
from dgsqp_torch.types import VehicleState

from test_torch_v2_games import DT, N, _bounds
from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

GAMES = 4


def games(twice: bool):
    """The integrator game in both packages; ``twice`` states the coupling row twice."""
    def build(model, joint_cls, cfg, cat, take, state_cls):
        joint = joint_cls(0.0, [model(0.0, cfg(dt=DT)), model(0.0, cfg(dt=DT))])
        stage = lambda x, u, um: 0.5 * take(u, 0) ** 2

        def term(a):
            return lambda x: 50.0 * (take(x, a) - 1.0) ** 2 + 0.3 * take(x, 0) * take(x, 1)

        def row(x):
            r = take(x, 0) + take(x, 1) - 1.0
            return cat([r, r] if twice else [r])
        shared = lambda x, u, um: row(x)
        shared_term = lambda x: row(x)
        return (joint, [(stage, term(0)), (stage, term(1))],
                [None] + [shared] * (N - 1) + [shared_term], _bounds(state_cls))
    jax_game = build(JaxIntegratorModel, JaxMultiAgent, JaxDynamicsConfig,
                     lambda rs: jnp.stack(rs), lambda v, i: v[i], JaxVehicleState)
    torch_game = build(IntegratorModel, MultiAgentDynamicsModel, DynamicsConfig,
                       lambda rs: torch.stack(rs, dim=-1), lambda v, i: v[..., i],
                       VehicleState)
    return jax_game, torch_game


def solvers(twice=False, **kw):
    base = dict(N=N, dt=DT, ibr_iters=1, p_tol=1e-6, d_tol=1e-6)
    base.update(kw)
    (jj, jc, js, jb), (tj, tc, tsh, tb) = games(twice)
    jsolver = JaxIBR(jj, jc, [None, None], js, jb, JaxParams(**base), print_method=None)
    tsolver = IBR(tj, tc, [None, None], tsh, tb, IBRParams(**base), print_method=None,
                  dtype=torch.float64, device='cpu')
    return jsolver, tsolver


def batch(solver, seed=0):
    rng = np.random.default_rng(seed)
    u0 = 0.5 * rng.normal(size=(GAMES, solver.n_dec))
    x0 = 0.2 * rng.normal(size=(GAMES, 2))
    return u0, x0, np.zeros((GAMES, solver.n_u))


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(b, a, tol, msg=''):
    a = np.asarray(a)
    np.testing.assert_allclose(np.asarray(b), a, rtol=0,
                               atol=tol * max(1.0, float(np.abs(a).max())), err_msg=msg)


def _shared_positions(ts, agent):
    """Positions of the shared (coupling) rows among agent's best-response rows."""
    prob = ts.problem
    rows = prob.constraint_indices_for_agent(agent)
    return [i for i, r in enumerate(rows)
            if any(prob._stage_off[k] <= r < prob._stage_off[k] + prob.n_cs[k]
                   for k in range(N + 1))]


@pytest.fixture(scope='module', params=[False, True], ids=['single', 'twice'])
def swept(request):
    """Solvers, a batch and the JAX sweep's end point (where the coupling rows bind)."""
    js, ts = solvers(twice=request.param)
    u0, x0, up = batch(js)
    u_br = jax.jit(jax.vmap(lambda u, x, p: js._solve_core(u, x, p, None).u))(
        jnp.asarray(u0), jnp.asarray(x0), jnp.asarray(up))
    return request.param, js, ts, (u0, x0, up), np.asarray(u_br)


@pytest.mark.parametrize('agent', [0, 1])
def test_br_step_matches_jax(swept, agent):
    twice, js, ts, (u0, x0, up), _ = swept
    m_a = len(js.br_idxs[agent])
    l_a = np.abs(np.random.default_rng(3).normal(size=(GAMES, m_a)))
    out_j = jax.jit(jax.vmap(lambda u, l, x, p: js._br_step(agent, u, l, x, p, None)))(
        *(jnp.asarray(a) for a in (u0, l_a, x0, up)))
    out_t = ts._br_step(agent, _t(u0), _t(l_a), _t(x0), _t(up), None)
    for name, a, b in zip(('u', 'l', 'kkt'), out_j, out_t):
        a, b = np.asarray(a), b.numpy()
        if name == 'l' and twice:
            # the QP's duals of a duplicated row are determined only in sum
            pos = _shared_positions(ts, agent)
            _close(b[:, pos].reshape(GAMES, -1, 2).sum(-1),
                   a[:, pos].reshape(GAMES, -1, 2).sum(-1), 1e-8, name)
            a, b = np.delete(a, pos, axis=1), np.delete(b, pos, axis=1)
        _close(b, a, 1e-8, name)
    # the step moved the agent's own block only
    s0, s1 = ts.ua_slices[agent]
    moved = np.abs(out_t[0].numpy() - u0).max(axis=0) > 0
    assert moved[s0:s1].any() and not np.delete(moved, np.arange(s0, s1)).any()


@pytest.mark.parametrize('opp', [0, 1])
def test_opponent_duals_match_jax(swept, opp):
    twice, js, ts, (u0, x0, up), u_br = swept
    lam_j = jax.jit(jax.vmap(lambda u, x, p: js._opponent_duals(opp, u, x, p, None)))(
        *(jnp.asarray(a) for a in (u_br, x0, up)))
    lam_t = ts._opponent_duals(opp, _t(u_br), _t(x0), _t(up), None)
    _close(lam_t.numpy(), lam_j, 1e-8)
    lam = lam_t.numpy()
    assert (lam >= 0).all() and lam.max() > 1e-3, 'no active row was exercised'
    if twice:
        # the duplicated coupling row is rank-deficient: the minimum-norm solution
        # gives both copies the same multiplier
        pairs = lam[:, _shared_positions(ts, opp)].reshape(GAMES, -1, 2)
        np.testing.assert_allclose(pairs[..., 0], pairs[..., 1], rtol=0, atol=1e-10)
        assert pairs.max() > 1e-3


def test_response_sensitivities_match_jax(swept):
    _, js, ts, (u0, x0, up), u_br = swept
    for a in range(2):
        S_j = jax.jit(jax.vmap(lambda u, x, p: js._response_sensitivities(a, u, x, p, None)))(
            *(jnp.asarray(v) for v in (u_br, x0, up)))
        S_t = ts._response_sensitivities(a, _t(u_br), _t(x0), _t(up), None)
        assert set(S_t) == set(S_j) == {1 - a}
        _close(S_t[1 - a].numpy(), S_j[1 - a], 1e-7, f'agent {a}')
        assert np.abs(S_t[1 - a].numpy()).max() > 1e-6


@pytest.mark.parametrize('use_ps', [False, True], ids=['plain', 'ps'])
def test_sweep_matches_jax(use_ps):
    js, ts = solvers(use_ps=use_ps)
    u0, x0, up = batch(js, seed=1)
    res_j = jax.jit(jax.vmap(lambda u, x, p: js._solve_core(u, x, p, None)))(
        *(jnp.asarray(a) for a in (u0, x0, up)))
    res_t = ts._solve_core(_t(u0), _t(x0), _t(up))
    _close(res_t.u.numpy(), res_j.u, 1e-7, 'u')
    _close(res_t.delta.numpy(), res_j.delta, 1e-7, 'delta')
    np.testing.assert_array_equal(res_t.converged.numpy(), np.asarray(res_j.converged))
    np.testing.assert_array_equal(res_t.sweeps.numpy(), np.asarray(res_j.sweeps))
    assert set(ts.last_br_kkt) == {0, 1} and all(
        torch.isfinite(k).all() for k in ts.last_br_kkt.values())


def test_host_interface_reaches_the_equilibrium():
    js, ts = solvers(ibr_iters=20, p_tol=1e-7, d_tol=1e-7)
    for s in (js, ts):
        s.set_warm_start(np.zeros((N, 2)))
    info_j = js.solve([JaxVehicleState(), JaxVehicleState()])
    info_t = ts.solve([VehicleState(), VehicleState()])
    assert info_t['status'] and info_j['status']
    np.testing.assert_allclose(info_t['u_sol'], info_j['u_sol'], rtol=0, atol=1e-7)
    assert ts.u_pred.shape == (N, 2)
