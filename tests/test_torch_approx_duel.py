"""Port parity for the approximate (MPCC) duel on the CPU in float64: the same inputs
through ``dgsqp_tpu`` and the port (``build_approximate_duel``, ``DGSQPV2FrenetApprox``,
the progress-augmented sampler and warm start, the ``approx`` bench branch and the study
script's ``--formulation approximate``).

Both packages read bit-identical geometry: the chicane's key-point tables and the
models' track splines are installed from the JAX package (``interop``).

* sampler + ``pa_warm_start`` on seed 0: the same accepted games, x0 and u_ws to 1e-12;
* ``evaluate`` (Q, q, G, g) in ``'once'`` mode with the same parameter pytree
  (``interop.mpcc_params``) and in ``'exact'`` mode: 1e-10 of each quantity's largest
  entry (at least 1);
* the combined constraint closures declare their rows through ``probe_rows``;
* ``scripts/torch_monte_carlo_main.py --formulation approximate --device cpu --dtype
  float64 --n 4 --N 5`` exits 0.

The solves in the three ``approximation_eval`` modes are in
``test_torch_approx_solver.py`` and ``test_torch_approx_solver_frozen.py``, one chunk of
the ``approx`` bench solver in ``test_torch_approx_bench.py``.
"""
import importlib.util
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgsqp_tpu.harness.samplers import sample_duel_initial_conditions as jax_sample
from dgsqp_tpu.harness.scenarios import build_approximate_duel as jax_duel
from dgsqp_tpu.solvers.dgsqp_v2_frenet import DGSQPV2FrenetApprox as JaxApprox
from dgsqp_tpu.solvers.solver_types import DGSQPV2Params as JaxParams
from dgsqp_torch import interop
from dgsqp_torch.harness.samplers import sample_duel_initial_conditions
from dgsqp_torch.harness.scenarios import build_approximate_duel, build_exact_duel
from dgsqp_torch.solvers.dgsqp import SQPResult
from dgsqp_torch.solvers.dgsqp_v2_frenet import DGSQPV2FrenetApprox
from dgsqp_torch.solvers.solver_types import DGSQPV2Params

from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

N = 5
ROOT = pathlib.Path(__file__).resolve().parents[1]
X0 = np.array([0.3, 0.2, 1.5, 0.0, 0.3, 0.9, -0.2, 1.5, 0.0, 0.9])
# the parameters of tests/test_frenet_approx.py
FROZEN = dict(reg=1e1, reg_decay=0.95, nms=True, nms_frequency=5, nms_memory_size=3,
              sqp_iters=100, p_tol=1e-3, d_tol=1e-3)
EXACT = dict(reg=1.0, reg_decay=1.0, nms=True, nms_frequency=1, nms_memory_size=10,
             nms_initial_step_size_factor=0.0, sqp_iters=100, p_tol=1e-3, d_tol=1e-3,
             conv_method='ns')
MODES = {'exact': dict(EXACT, approximation_eval='exact'),
         'once': dict(FROZEN, approximation_eval='once'),
         'always': dict(FROZEN, approximation_eval='always')}


def share_geometry(jsc, sc):
    """Install the JAX scenario's track tables and model splines on the port's."""
    interop.load_track_tables(sc.track, np.asarray(jsc.track._kp),
                              np.asarray(jsc.track._cum_angle))
    for jm, tm in zip(jsc.joint_model.dynamics_models, sc.joint_model.dynamics_models):
        interop.load_track_splines(tm.splines, jm.splines)


def _solvers(mode):
    jsc, sc = jax_duel(N=N), build_approximate_duel(N=N)
    share_geometry(jsc, sc)
    kw = MODES[mode]
    js = JaxApprox(jsc.joint_model, jsc.costs, jsc.agent_constraints,
                   jsc.shared_constraints, jsc.bounds, JaxParams(N=N, dt=jsc.dt, **kw),
                   print_method=None)
    ts = DGSQPV2FrenetApprox(sc.joint_model, sc.costs, sc.agent_constraints,
                             sc.shared_constraints, sc.bounds, DGSQPV2Params(N=N, dt=sc.dt, **kw),
                             print_method=None, dtype=torch.float64, device='cpu')
    return js, ts


def _close(b, a, tol, msg=''):
    a = np.asarray(a)
    np.testing.assert_allclose(np.asarray(b), a, rtol=0,
                               atol=tol * max(1.0, float(np.abs(a).max())), err_msg=msg)


def _same_result(res_t, res_j, atol=1e-6):
    res_j = interop.to_torch_tuple(res_j, SQPResult, device='cpu')
    for f in ('status', 'iters', 'qp_solves'):
        assert torch.equal(getattr(res_t, f).long(), getattr(res_j, f).long()), f
    np.testing.assert_allclose(res_t.u.numpy(), res_j.u.numpy(), rtol=0, atol=atol)


def test_pa_sampler_and_warm_start_match_jax():
    jsc, sc = jax_duel(N=N), build_approximate_duel(N=N)
    share_geometry(jsc, sc)
    out_j = jax_sample(jsc, 6, seed=0)
    out_t = sample_duel_initial_conditions(sc, 6, seed=0, dtype=torch.float64, device='cpu')
    assert out_t[0].shape == (6, 10) and out_t[1].shape == (6, N, 6)
    for name, a, b in zip(('x0', 'u_ws', 'v_ref', 'lat_ref'), out_j, out_t):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-12, err_msg=name)
    # the virtual arc-speed channel carries the PID rollout's progress rate
    assert (out_t[1][:, :, 2] > 0).all() and (out_t[1][:, :, 5] > 0).all()


@pytest.mark.parametrize('mode', ['once', 'exact'])
def test_evaluate_matches_jax(mode):
    js, ts = _solvers(mode)
    assert (ts.n_c, ts.n_dec) == (js.n_c, js.n_dec) == (149, 30)
    rng = np.random.default_rng(4)
    B = 3
    u0 = rng.normal(0, 0.3, (B, ts.n_dec))
    l0 = np.abs(rng.normal(0, 0.1, (B, ts.n_c)))
    x0 = X0 + rng.normal(0, 0.05, (B, 10))
    up = rng.normal(0, 0.1, (B, 6))
    args_j = [jnp.asarray(a) for a in (u0, l0, x0, up)]
    args_t = interop.bench_batch(u0, l0, x0, up, device='cpu')
    if mode == 'once':
        P_j = jax.jit(jax.vmap(js._approx_update))(args_j[0], args_j[2])
        P_t = interop.mpcc_params(jax.tree_util.tree_map(np.asarray, P_j), device='cpu')
        # the port's own linearisation agrees with the JAX one
        P_own = ts._approx_update(args_t[0], args_t[2])
        for key in P_t:
            for a, b in zip(P_own[key], P_t[key]):
                _close(a, b, 1e-10, key)
    else:
        assert ts._approx_update is None and js._approx_update is None
        P_j = P_t = None
    out_j = jax.jit(jax.vmap(lambda u, l, x, p, P: js.problem.evaluate(u, l, x, p, P)))(
        *args_j, P_j)
    out_t = ts.problem.evaluate(*args_t, P_t)
    for name, a, b in zip('Q q G g x'.split(), out_j, out_t):
        _close(b, a, 1e-10, name)


def test_combined_constraints_declare_their_rows():
    sc = build_approximate_duel(N=N)
    ts = DGSQPV2FrenetApprox(sc.joint_model, sc.costs, sc.agent_constraints,
                             sc.shared_constraints, sc.bounds,
                             DGSQPV2Params(N=N, dt=sc.dt, **MODES['once']),
                             print_method=None, dtype=torch.float64, device='cpu')
    prob = ts.problem
    fn = prob.agent_constraints[0][0]
    # six input-rate rows and two boundary rows, counted without a parameter pytree
    assert fn.probe_rows(torch.zeros(10), torch.zeros(3), torch.zeros(3)) == 8
    assert prob._m_agent[0][:N] == [8] * N and prob._m_agent[0][N] == 2
    # one combined closure for all stages, so they stay one group
    assert len(prob._agent_groups[0]) == 1
    # without rate rows the boundary closure stands alone and declares n_out
    sc2 = build_approximate_duel(N=N, rate_constraints=False)
    ts2 = DGSQPV2FrenetApprox(sc2.joint_model, sc2.costs, sc2.agent_constraints,
                              sc2.shared_constraints, sc2.bounds,
                              DGSQPV2Params(N=N, dt=sc2.dt, **MODES['once']),
                              print_method=None, dtype=torch.float64, device='cpu')
    assert ts2.problem._m_agent[1] == [2] * (N + 1) and ts2.n_c == prob.n_c_total - 6 * 2 * N
    # the exact formulation of the same game has the same decision count minus u_ds
    ex = build_exact_duel(N=N)
    assert ex.joint_model.n_u == 4 and ex.name == 'exact_duel'


def _script():
    spec = importlib.util.spec_from_file_location(
        'torch_monte_carlo_main', ROOT / 'scripts' / 'torch_monte_carlo_main.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_study_script_approximate_formulation(tmp_path, capsys):
    _script().main(['--formulation', 'approximate', '--device', 'cpu', '--dtype', 'float64',
                    '--n', '4', '--N', str(N), '--out', str(tmp_path)])
    out = capsys.readouterr().out
    assert '"solver": "DGSQPV2FrenetApprox"' in out and '"total": 4' in out
    # float64 is off the solver's default (float32): the output's name says so
    assert list(tmp_path.glob('approx_duel_dgsqp_approximate_float64_n4_s0.pkl'))
