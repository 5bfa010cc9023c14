"""Port parity: the stage-wise (DP) game derivatives, ``GameProblem.evaluate_dp``, and
``hessian_mode='dp'`` in DGSQP v1 and v2, on the CPU in float64.

* On the chicane duel at N=6 and the merge at N=4 (the games of the JAX package's own
  DP tests, ``tests/test_game_problem.py``), three games drawn from a fixed seed:
  ``evaluate_dp`` matches the JAX package's ``evaluate_dp`` and the port's ``evaluate``
  within the tolerances of the JAX package's DP test (x and g 1e-12, q and G 1e-10,
  Q 1e-9, absolute); without the Hessian it returns the same (q, G, g, x).
* On the approximate (MPCC) duel at N=5, with the per-game parameters P of its
  ``'once'`` mode and through the splines in ``'exact'`` mode, ``evaluate_dp`` gives
  the port's ``evaluate`` within the same tolerances.
* DGSQP v1 (flat machine) and v2 with ``hessian_mode='dp'`` on a batch of merge games
  at N=4 give the JAX package's per-game statuses, iterations and QP counts, and ``u``
  within 1e-6 (absolute).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgsqp_tpu.harness.samplers import sample_merge_initial_conditions as jax_sample
from dgsqp_tpu.harness.scenarios import build_chicane_scenario as jax_chicane
from dgsqp_tpu.harness.scenarios import build_merge_scenario as jax_merge
from dgsqp_tpu.solvers import solver_types as jtypes
from dgsqp_tpu.solvers.dgsqp import DGSQP as JaxDGSQP
from dgsqp_tpu.solvers.dgsqp_v2 import DGSQPV2 as JaxDGSQPV2
from dgsqp_tpu.solvers.game_problem import GameProblem as JaxGameProblem
from dgsqp_torch import interop
from dgsqp_torch.harness.scenarios import build_chicane_scenario, build_merge_scenario
from dgsqp_torch.solvers import solver_types as ttypes
from dgsqp_torch.solvers.dgsqp import RUNNING, DGSQP, SQPResult
from dgsqp_torch.solvers.dgsqp_v2 import DGSQPV2
from dgsqp_torch.solvers.game_problem import GameProblem

from test_torch_approx_duel import X0 as X0_PA, _solvers as approx_solvers
from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

B = 3
# the JAX package's DP test's tolerances (tests/test_game_problem.py)
TOL = dict(x=1e-12, g=1e-12, q=1e-10, G=1e-10, Q=1e-9)

# nominal initial states: the JAX chicane test's, and the merge's three cars in lane
X0 = {'chicane': [0.5, 0.0, 2.0, 0.0, 0.5, 0.0, 1.5, 0.3, 2.2, 0.0, 1.5, 0.3],
      'merge': [0.0, 0.15, 0.3, 0.0, 0.5, 0.15, 0.3, 0.0, 0.25, -0.55, 0.3, np.pi / 12]}


def scenario_pair(kind):
    if kind == 'chicane':
        jsc, sc = jax_chicane(N=6, theta_deg=45.0), build_chicane_scenario(N=6, theta_deg=45.0)
        interop.load_track_tables(sc.track, np.asarray(jsc.track._kp),
                                  np.asarray(jsc.track._cum_angle))
        return jsc, sc
    return jax_merge(N=4), build_merge_scenario(N=4)


def _problems(jsc, sc):
    jp = JaxGameProblem(jsc.joint_model, jsc.costs, jsc.agent_constraints,
                        jsc.shared_constraints, jsc.bounds, jsc.N)
    tp = GameProblem(sc.joint_model, sc.costs, sc.agent_constraints, sc.shared_constraints,
                     sc.bounds, sc.N, dtype=torch.float64, device='cpu')
    return jp, tp


@pytest.fixture(scope='module', params=['chicane', 'merge'])
def evaluated(request):
    """Both packages' ``evaluate_dp`` on the same three games; the JAX side once."""
    jp, tp = _problems(*scenario_pair(request.param))
    rng = np.random.default_rng(7)
    u = rng.normal(0.0, 0.2, (B, tp.n_dec))
    lam = rng.uniform(0.0, 0.5, (B, tp.n_c_total))
    x0 = np.asarray(X0[request.param]) + rng.normal(0.0, 0.02, (B, tp.n_q))
    up = rng.normal(0.0, 0.1, (B, tp.n_u))
    out_j = jax.jit(jax.vmap(jp.evaluate_dp))(*(jnp.asarray(a) for a in (u, lam, x0, up)))
    args = tuple(torch.tensor(a) for a in (u, lam, x0, up))
    return tp, args, [np.asarray(a) for a in out_j]


def _close(out_t, out_ref, names):
    for name, a_t, a_r in zip(names, out_t, out_ref):
        a_r = a_r.numpy() if torch.is_tensor(a_r) else a_r
        np.testing.assert_allclose(a_t.numpy(), a_r, rtol=0, atol=TOL[name], err_msg=name)


def test_evaluate_dp_matches_jax(evaluated):
    tp, args, out_j = evaluated
    _close(tp.evaluate_dp(*args), out_j, 'QqGgx')


def test_evaluate_dp_matches_evaluate(evaluated):
    tp, (u, lam, x0, up), _ = evaluated
    out_dp = tp.evaluate_dp(u, lam, x0, up)
    _close(out_dp, tp.evaluate(u, lam, x0, up), 'QqGgx')
    # without the Hessian: the same first derivatives, constraints and rollout
    lite = tp.evaluate_dp(u, None, x0, up, hessian=False)
    _close(lite, tp.evaluate(u, None, x0, up, hessian=False), 'qGgx')
    _close(lite, out_dp[1:], 'qGgx')


@pytest.mark.parametrize('mode', ['once', 'exact'])
def test_evaluate_dp_with_game_parameters(mode):
    """The approximate (MPCC) duel at N=5: in ``'once'`` mode its stage functions read
    the per-game parameters P (the linearisation, built by the solver's own update);
    in ``'exact'`` mode they differentiate through the track splines.  ``evaluate_dp``
    gives ``evaluate``'s Q, q, G, g."""
    _, ts = approx_solvers(mode)
    rng = np.random.default_rng(4)
    u = torch.tensor(rng.normal(0, 0.3, (B, ts.n_dec)))
    lam = torch.tensor(np.abs(rng.normal(0, 0.1, (B, ts.n_c))))
    x0 = torch.tensor(X0_PA + rng.normal(0, 0.05, (B, 10)))
    up = torch.tensor(rng.normal(0, 0.1, (B, 6)))
    P = ts._approx_update(u, x0) if mode == 'once' else None
    _close(ts.problem.evaluate_dp(u, lam, x0, up, P), ts.problem.evaluate(u, lam, x0, up, P),
           'QqGgx')


SOLVES = {'v1': dict(reg=1e-3, nonmono_ls=True, line_search_iters=50, sqp_iters=50,
                     p_tol=1e-3, d_tol=1e-3, beta=0.01, tau=0.5),
          'v2': dict(reg=1e-3, reg_decay=1.0, nms_frequency=5, nms_memory_size=5,
                     sqp_iters=50, p_tol=1e-3, d_tol=1e-3, stall_its=10,
                     line_search_iters=20)}


@pytest.mark.parametrize('solver', ['v1', 'v2'])
def test_dp_solves_match_jax(solver):
    """Three merge games at N=4 (the JAX sampler's, seed 1, zero warm start) solved with
    ``hessian_mode='dp'`` by ``solve_batch_chunked`` in both packages."""
    jsc, sc = scenario_pair('merge')
    name, cls, jcls = (('DGSQPParams', DGSQP, JaxDGSQP) if solver == 'v1'
                       else ('DGSQPV2Params', DGSQPV2, JaxDGSQPV2))
    kw = dict(N=sc.N, dt=sc.dt, hessian_mode='dp', **SOLVES[solver])
    js = jcls(jsc.joint_model, jsc.costs, jsc.agent_constraints, jsc.shared_constraints,
              jsc.bounds, getattr(jtypes, name)(**kw), print_method=None)
    ts = cls(sc.joint_model, sc.costs, sc.agent_constraints, sc.shared_constraints,
             sc.bounds, getattr(ttypes, name)(**kw), print_method=None, dtype=torch.float64,
             device='cpu')
    x0, _, _, _ = jax_sample(jsc, B, seed=1)
    u0, up = np.zeros((B, ts.n_dec)), np.zeros((B, ts.n_u))
    l0 = np.asarray(jax.vmap(js.problem.dual_warm_start)(
        *(jnp.asarray(a) for a in (u0, x0, up))))
    batch = (u0, l0, x0, up)
    res_j = js.solve_batch_chunked(*(jnp.asarray(a) for a in batch))
    res_t = ts.solve_batch_chunked(*interop.bench_batch(*batch, device='cpu'))
    res_j = interop.to_torch_tuple(res_j, SQPResult, device='cpu')
    assert not (res_t.status == RUNNING).any()
    for f in ('status', 'iters', 'qp_solves'):
        assert torch.equal(getattr(res_t, f).long(), getattr(res_j, f).long()), f
    np.testing.assert_allclose(res_t.u.numpy(), res_j.u.numpy(), rtol=0, atol=1e-6)
