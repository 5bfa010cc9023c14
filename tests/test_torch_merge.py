"""Port parity: the merge scenario and the kinematic unicycle and bicycle family, on the
CPU in float64.

* Each kinematic unicycle (global, Frenet, combined) and bicycle (global, Frenet,
  velocity-input Frenet) model: ``fd`` and its Jacobians and Hessians (``fAd``, ``fBd``,
  ``fEd``, ``fFd``, ``fGd``) at random points match the JAX package's to 1e-12; the
  Frenet models on the same curved track tables.  ``get_dynamics_model`` builds every
  ported model by the JAX factory's name and raises for the dynamic bicycles.
* ``sample_merge_initial_conditions`` (N=6, 4 games, seed 1) draws the JAX package's
  x0 (1e-12) and an all-zero warm start.
* The merge game's ``evaluate`` (Q, q, G, g, x) on those games matches the JAX package's
  to 1e-10.
* The merge study at N=6 (4 games, seed 0, float64): DGSQP v1 with the study defaults,
  through ``scripts/torch_monte_carlo_main.py --scenario merge``, and the MCP oracle
  (``PATHMCP``, ``method='hybrid'``, tol 1e-3, 4 restarts; 40 iterations a phase)
  through ``run_mc_study`` give the JAX studies' x0, statuses, iterations and QP counts,
  and the solutions of solved games within 1e-6: the counterpart of
  ``tests/test_scenarios_multi.py::test_merge_scenario_solves``.
"""
import json
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.func import vmap

from dgsqp_tpu import dynamics as jdyn
from dgsqp_tpu.harness import mc_study as jax_mc
from dgsqp_tpu.harness.samplers import sample_merge_initial_conditions as jax_sample_merge
from dgsqp_tpu.harness.scenarios import build_merge_scenario as jax_merge
from dgsqp_tpu.solvers.game_problem import GameProblem as JaxGameProblem
from dgsqp_tpu.solvers.mcp import PATHMCP as JaxPATHMCP
from dgsqp_tpu.solvers.solver_types import PATHMCPParams as JaxParams
from dgsqp_tpu.tracks import CurveTrack as JCurveTrack
from dgsqp_torch import dynamics as tdyn
from dgsqp_torch import interop
from dgsqp_torch.harness import mc_study
from dgsqp_torch.harness.samplers import sample_merge_initial_conditions
from dgsqp_torch.harness.scenarios import build_merge_scenario
from dgsqp_torch.solvers.dgsqp import CONV_ABS
from dgsqp_torch.solvers.game_problem import GameProblem
from dgsqp_torch.solvers.mcp import SOLVED, PATHMCP
from dgsqp_torch.solvers.solver_types import PATHMCPParams
from dgsqp_torch.tracks import CurveTrack

from test_torch_baselines_study import _script
from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

N, GAMES = 6, 4
ORACLE = dict(N=N, dt=0.1, tol=1e-3, max_iters=40, max_restarts=4)

# (class name, configuration class, configuration, frame): the merge's unicycle
# configuration, and the racing scenarios' bicycles with drag and slip
UNICYCLE = dict(dt=0.1, discretization_method='rk3', M=1, damping_coefficient=0.2)
BICYCLE = dict(dt=0.1, discretization_method='euler', drag_coefficient=0.1,
               slip_coefficient=0.1, damping_coefficient=0.1)
MODELS = {
    'kinematic_unicycle': ('KinematicUnicycle', 'UnicycleConfig', UNICYCLE, 'global'),
    'kinematic_unicycle_cl': ('KinematicClUnicycle', 'UnicycleConfig', UNICYCLE, 'frenet'),
    'kinematic_unicycle_combined': ('KinematicUnicycleCombined', 'UnicycleConfig',
                                    UNICYCLE, 'combined'),
    'kinematic_bicycle': ('KinematicBicycle', 'KinematicBicycleConfig', BICYCLE, 'global'),
    'kinematic_bicycle_cl': ('KinematicCLBicycle', 'KinematicBicycleConfig', BICYCLE,
                             'frenet'),
    'kinematic_bicycle_cl_vel': ('KinematicCLVelBicycle', 'KinematicBicycleConfig', BICYCLE,
                                 'frenet_vel'),
}
TRACK = (1.0, 4.0, np.pi / 3, 5.0, 2.0, 0.8)


def _points(frame, rng, n=5):
    """States and inputs of each frame's layout: on the track, moving, steering."""
    v = rng.uniform(0.5, 2.0, n)
    ang = rng.uniform(-0.3, 0.3, n)
    s = rng.uniform(0.2, 9.0, n)
    ey = rng.uniform(-0.5, 0.5, n)
    xy = rng.uniform(-2.0, 2.0, (n, 2))
    q = {'global': np.column_stack([xy, v, ang]),
         'frenet': np.column_stack([v, ang, s, ey]),
         'combined': np.column_stack([xy, v, ang, s, ey]),
         'frenet_vel': np.column_stack([ang, s, ey])}[frame]
    u = np.column_stack([rng.uniform(-1.0, 1.0, n), rng.uniform(-0.4, 0.4, n)])
    if frame == 'frenet_vel':
        u[:, 0] = v
    return q, u


@pytest.mark.parametrize('name', list(MODELS))
def test_model_and_derivatives_match_jax(name):
    cls, cfg, kw, frame = MODELS[name]
    jtrack, ttrack = JCurveTrack(*TRACK), CurveTrack(*TRACK)
    interop.load_track_tables(ttrack, np.asarray(jtrack._kp), np.asarray(jtrack._cum_angle))
    jm = getattr(jdyn, cls)(0.0, getattr(jdyn, cfg)(**kw), track=jtrack)
    tm = getattr(tdyn, cls)(0.0, getattr(tdyn, cfg)(**kw), track=ttrack)
    assert (tm.n_q, tm.n_u) == (jm.n_q, jm.n_u)
    q, u = _points(frame, np.random.default_rng(3))
    fns = ('fd', 'fAd', 'fBd', 'fEd', 'fFd', 'fGd')
    # one JAX program for the six
    refs = jax.jit(jax.vmap(lambda q_, u_: [getattr(jm, fn)(q_, u_) for fn in fns]))(
        jnp.asarray(q), jnp.asarray(u))
    qt, ut = torch.tensor(q), torch.tensor(u)
    for fn, ref in zip(fns, refs):
        out = (tm.fd(qt, ut) if fn == 'fd' else vmap(getattr(tm, fn))(qt, ut)).numpy()
        np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=1e-12,
                                   err_msg=f'{name}.{fn}')


def test_get_dynamics_model_names():
    # every name of the JAX package's factory whose model is ported builds that model
    for name, (cls, cfg, kw, _) in MODELS.items():
        if name != 'kinematic_bicycle_cl_vel':     # not a name of the factory
            m = tdyn.get_dynamics_model(name, 0.0, getattr(tdyn, cfg)(**kw))
            assert type(m).__name__ == cls
    m = tdyn.get_dynamics_model('kinematic_bicycle_combined', 0.0,
                                tdyn.KinematicBicycleConfig())
    assert isinstance(m, tdyn.KinematicBicycleCombined)
    for name in ('dynamic_bicycle', 'dynamic_bicycle_cl', 'dynamic_bicycle_combined'):
        with pytest.raises(NotImplementedError, match='dynamic-bicycle'):
            tdyn.get_dynamics_model(name, 0.0, tdyn.KinematicBicycleConfig())
    with pytest.raises(ValueError):
        tdyn.get_dynamics_model('no_such_model', 0.0, tdyn.DynamicsConfig())
    m = tdyn.get_dynamics_model('integrator', 0.0, tdyn.DynamicsConfig())
    assert isinstance(m, tdyn.IntegratorModel)


@pytest.fixture(scope='module')
def merge():
    """The merge at N=6 in both packages and the JAX sampler's games (seed 1)."""
    jsc, sc = jax_merge(N=N), build_merge_scenario(N=N)
    return jsc, sc, jax_sample_merge(jsc, GAMES, seed=1)


def test_scenario_layout_matches(merge):
    jsc, sc, _ = merge
    assert sc.name == jsc.name == 'merge_N6'
    for key, val in jsc.merge_geometry.items():
        np.testing.assert_array_equal(np.asarray(sc.merge_geometry[key]), np.asarray(val))
    assert (sc.obs_d, sc.half_width) == (jsc.obs_d, jsc.half_width)
    assert sc.shared_constraints[0] is None


def test_sampler_draws_the_jax_games(merge):
    jsc, sc, (x0_j, u_j, _, _) = merge
    x0, u_ws, v_ref, lat_ref = sample_merge_initial_conditions(
        sc, GAMES, seed=1, dtype=torch.float64, device='cpu')
    assert x0.shape == (GAMES, 12) and v_ref is None and lat_ref is None
    np.testing.assert_allclose(x0, x0_j, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(u_ws, np.asarray(u_j))
    assert u_ws.shape == (GAMES, N, 6) and not u_ws.any()


def test_merge_evaluate_matches_jax(merge):
    jsc, sc, (x0, _, _, _) = merge
    jp = JaxGameProblem(jsc.joint_model, jsc.costs, jsc.agent_constraints,
                        jsc.shared_constraints, jsc.bounds, N)
    tp = GameProblem(sc.joint_model, sc.costs, sc.agent_constraints, sc.shared_constraints,
                     sc.bounds, N, dtype=torch.float64, device='cpu')
    assert (tp.n_dec, tp.n_c_total) == (jp.n_dec, jp.n_c_total)
    assert tp.input_box_structure() == jp.input_box_structure()
    rng = np.random.default_rng(5)
    u = rng.normal(0.0, 0.3, (GAMES, tp.n_dec))
    lam = np.maximum(rng.uniform(-1.0, 1.0, (GAMES, tp.n_c_total)), 0.0)
    up = rng.normal(0.0, 0.1, (GAMES, tp.n_u))
    out_j = jax.jit(jax.vmap(jp.evaluate))(*(jnp.asarray(a) for a in (u, lam, x0, up)))
    out_t = tp.evaluate(*(torch.tensor(a) for a in (u, lam, x0, up)))
    for name, a_j, a_t in zip('QqGgx', out_j, out_t):
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=0, atol=1e-10,
                                   err_msg=name)


def _same_study(res_t, res_j, solved):
    np.testing.assert_allclose(res_t.x0, np.asarray(res_j.x0), rtol=0, atol=1e-12)
    for f in ('statuses', 'iters', 'qp_solves'):
        np.testing.assert_array_equal(getattr(res_t, f), np.asarray(getattr(res_j, f)), f)
    ok = res_t.statuses == solved
    assert ok.any()
    np.testing.assert_allclose(res_t.u_sol[ok], np.asarray(res_j.u_sol)[ok], rtol=0,
                               atol=1e-6)


def test_merge_study_dgsqp_matches_jax(tmp_path, capsys):
    jsc = jax_merge(N=N)
    res_j = jax_mc.run_mc_study(jsc, num_samples=GAMES, seed=0, n_devices=1)
    _script('torch_monte_carlo_main').main(
        ['--scenario', 'merge', '--solver', 'dgsqp', '--n', str(GAMES), '--N', str(N),
         '--device', 'cpu', '--dtype', 'float64', '--out', str(tmp_path)])
    printed = json.loads(capsys.readouterr().out)
    assert printed['scenario'] == 'merge_N6' and printed['total'] == GAMES
    with open(tmp_path / f'merge_N{N}_dgsqp_exact_float64_n{GAMES}_s0.pkl', 'rb') as f:
        res_t = pickle.load(f)
    _same_study(res_t, res_j, CONV_ABS)
    # the straight-lane cars keep their lane: y in [r, lw - r]
    sc = build_merge_scenario(N=N)
    ok = res_t.statuses == CONV_ABS
    u = torch.tensor(res_t.u_sol[ok])
    problem = GameProblem(sc.joint_model, sc.costs, sc.agent_constraints,
                          sc.shared_constraints, sc.bounds, N, dtype=torch.float64,
                          device='cpu')
    x = problem.rollout(u, torch.tensor(res_t.x0[ok])).numpy()
    for a in (0, 1):
        assert (x[:, 1:, 4 * a + 1] <= 0.3 - 0.1 + 1e-4).all()
        assert (x[:, 1:, 4 * a + 1] >= 0.1 - 1e-4).all()


def test_merge_study_mcp_matches_jax():
    jsc, sc = jax_merge(N=N), build_merge_scenario(N=N)
    js = JaxPATHMCP(jsc.joint_model, jsc.costs, jsc.agent_constraints,
                    jsc.shared_constraints, jsc.bounds, JaxParams(method='hybrid', **ORACLE),
                    print_method=None)
    ts = PATHMCP(sc.joint_model, sc.costs, sc.agent_constraints, sc.shared_constraints,
                 sc.bounds, PATHMCPParams(method='hybrid', **ORACLE), print_method=None,
                 dtype=torch.float64, device='cpu')
    res_j = jax_mc.run_mc_study(jsc, num_samples=GAMES, seed=0, solver=js, n_devices=1)
    res_t = mc_study.run_mc_study(sc, num_samples=GAMES, seed=0, solver=ts)
    _same_study(res_t, res_j, SOLVED)
