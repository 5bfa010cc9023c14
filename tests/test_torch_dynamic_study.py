"""Port parity: the dynamic duels and their study's sampler, on the CPU in float64.

* ``build_dynamic_duel`` (cost settings 0 and 1) and ``build_dynamic_approximate_duel``
  (with and without the input-rate rows): the same names, radii, bounds and input
  limits, and every stage and terminal cost and constraint row equal to the JAX
  package's at seeded points within 1e-12.
* ``sample_dynamic_duel_initial_conditions`` and ``sample_dynamic_pa_initial_conditions``
  (N = 6, 4 games, seed 0) draw the JAX package's x0, u_ws, v_ref and ey_ref within
  1e-12 (the warm starts' rollouts within 1e-10); ``combined_to_pa_dynamic`` matches.
* ``evaluate`` (Q, q, G, g, x) of the exact duel at N = 3 on sampled games matches the
  JAX package's within 1e-10 of each quantity's largest entry (at least 1), and DGSQP
  v2's QP step from it (eigh convexification, regularisation, ``solve_qp``; the study
  script's parameters) within 1e-8: the same ``ok`` flags, the step and its duals.
  (A whole v2 study compiles for ~140 s on the JAX side, ~250 s beside the other test
  files, so the study itself runs here in the port alone.)
* ``scripts/torch_monte_carlo_main.py --scenario dynamic --solver dgsqp_v2`` runs the
  study through ``run_mc_study`` on the CPU (N = 3, 2 games, 2 m-steps); with the
  defaults it names its outputs as the JAX script does, the names of the TPU records
  ``results/r5/dynamic_duel_N15_c0_dgsqp_v2_exact_n64_s0.json`` and
  ``dynamic_approx_duel_N15_c0_dgsqp_v2_approximate_n64_s0.json``.
"""
import pickle
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgsqp_tpu.harness import dynamic_study as jds
from dgsqp_tpu.harness import scenarios as jsc
from dgsqp_tpu.solvers.dgsqp_v2 import DGSQPV2 as JaxDGSQPV2
from dgsqp_tpu.solvers.solver_types import DGSQPV2Params as JaxParams
from dgsqp_torch.harness import dynamic_study as tds
from dgsqp_torch.harness import scenarios as tsc
from dgsqp_torch.solvers.dgsqp_v2 import DGSQPV2
from dgsqp_torch.solvers.solver_types import DGSQPV2Params

from test_torch_baselines_study import _script
from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
# the study script's DGSQP v2 parameters (its defaults; float64)
V2 = dict(dt=0.1, sqp_iters=50, p_tol=1e-3, d_tol=1e-3, merit_function='stat_l1',
          merit_decrease_condition='armijo', nms=True)

N, GAMES = 6, 4


def _close(out, ref, what, tol=1e-12):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(out, np.float64), ref, rtol=0,
                               atol=tol * max(1.0, float(np.max(np.abs(ref)))), err_msg=what)


def _pair(approx, cost_setting=0, rate_constraints=True):
    if approx:
        kw = dict(N=N, cost_setting=cost_setting, rate_constraints=rate_constraints)
        return jsc.build_dynamic_approximate_duel(**kw), tsc.build_dynamic_approximate_duel(**kw)
    return (jsc.build_dynamic_duel(N=N, cost_setting=cost_setting),
            tsc.build_dynamic_duel(N=N, cost_setting=cost_setting))


@pytest.mark.parametrize('approx,cost_setting,rate', [(False, 0, True), (False, 1, True),
                                                      (True, 0, True), (True, 1, False)])
def test_scenario_matches_jax(approx, cost_setting, rate):
    js, ts = _pair(approx, cost_setting, rate)
    assert ts.name == js.name and ts.N == js.N and ts.dt == js.dt
    assert ts.obs_d == js.obs_d and ts.half_width == js.half_width
    for f in ('input_ub', 'input_lb', 'input_rate_ub', 'input_rate_lb'):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
    for side in ('ub', 'lb'):
        for jb, tb in zip(js.bounds[side], ts.bounds[side]):
            assert tb.u.u_a == jb.u.u_a and tb.u.u_steer == jb.u.u_steer
            assert tb.u.u_ds == jb.u.u_ds and tb.p.x_tran == jb.p.x_tran
    jm, tm = js.joint_model, ts.joint_model
    assert [type(m).__name__ for m in tm.dynamics_models] == \
        [type(m).__name__ for m in jm.dynamics_models]
    assert (tm.n_q, tm.n_u) == (jm.n_q, jm.n_u)
    rng = np.random.default_rng(3)
    x = rng.normal(0.0, 1.0, (5, tm.n_q))
    u, um = rng.normal(0.0, 0.5, (2, 5, tm.n_u))
    offs = tm.u_offsets

    def both(jf, tf, *args):
        ref = jax.vmap(jf)(*(jnp.asarray(a) for a in args))
        return tf(*(torch.tensor(a) for a in args)).numpy(), np.asarray(ref)

    for a in range(2):
        stage, term = ts.costs[a]
        jstage, jterm = js.costs[a]
        _close(*both(jstage, stage, x, u[:, offs[a]:offs[a + 1]], um[:, offs[a]:offs[a + 1]]),
               f'cost {a} stage')
        _close(*both(jterm, term, x), f'cost {a} terminal')
        for k in (0, N - 1, N):
            jf, tf = js.agent_constraints[a][k], ts.agent_constraints[a][k]
            assert (jf is None) == (tf is None)
            if tf is not None:
                _close(*both(jf, tf, x, u[:, offs[a]:offs[a + 1]],
                             um[:, offs[a]:offs[a + 1]]), f'agent {a} row {k}')
    assert ts.shared_constraints[0] is None and js.shared_constraints[0] is None
    _close(*both(js.shared_constraints[1], ts.shared_constraints[1], x, u, um), 'shared')
    _close(*both(js.shared_constraints[N], ts.shared_constraints[N], x), 'shared terminal')


@pytest.fixture(scope='module')
def draws():
    """Both packages' exact-duel draws (N = 6, 4 games, seed 0)."""
    js, ts = _pair(False)
    return (js, ts, jds.sample_dynamic_duel_initial_conditions(js, GAMES, seed=0),
            tds.sample_dynamic_duel_initial_conditions(ts, GAMES, seed=0,
                                                       dtype=torch.float64, device='cpu'))


def test_dynamic_sampler_matches_jax(draws):
    js, ts, dj, dt = draws
    for name, a, b in zip(('x0', 'u_ws', 'v_ref', 'ey_ref'), dt, dj):
        assert a.shape == np.asarray(b).shape, name
        _close(a, b, name)
    # the warm start alone, on the drawn games
    x0, _, v_ref, ey_ref = dj
    out_j = jax.vmap(lambda q, v, e: jds.dynamic_warm_start(js, q, v, e))(
        jnp.asarray(x0), jnp.asarray(v_ref), jnp.asarray(ey_ref))
    out_t = tds.dynamic_warm_start(ts, *(torch.tensor(a) for a in (x0, v_ref, ey_ref)))
    _close(out_t[0].numpy(), out_j[0], 'u_ws', 1e-10)
    _close(out_t[1].numpy(), out_j[1], 'q_ws', 1e-10)
    np.testing.assert_array_equal(out_t[2].numpy(), np.asarray(out_j[2]))


def test_pa_sampler_matches_jax():
    js, ts = _pair(True)
    dj = jds.sample_dynamic_pa_initial_conditions(js, GAMES, seed=0)
    dt = tds.sample_dynamic_pa_initial_conditions(ts, GAMES, seed=0, dtype=torch.float64,
                                                  device='cpu')
    for name, a, b in zip(('x0', 'u_ws', 'v_ref', 'ey_ref'), dt, dj):
        assert a.shape == np.asarray(b).shape, name
        _close(a, b, name, 1e-10)


def test_combined_to_pa_matches_jax():
    rng = np.random.default_rng(9)
    js, ts = _pair(True)
    x0 = rng.uniform(0.0, 2.0, (3, 16))
    q_ws = rng.uniform(0.0, 17.0, (3, N + 1, 16))
    u_ws = rng.normal(0.0, 0.5, (3, N, 4))
    out_j = jds.combined_to_pa_dynamic(x0, q_ws, u_ws, js.track, js.dt)
    out_t = tds.combined_to_pa_dynamic(x0, q_ws, u_ws, ts.track, ts.dt)
    for a, b in zip(out_t, out_j):
        _close(a, b, 'combined_to_pa')


def test_exact_duel_evaluate_and_qp_step_match_jax(draws):
    x0 = draws[2][0]
    n = 3
    js, ts = jsc.build_dynamic_duel(N=n), tsc.build_dynamic_duel(N=n)
    jsol = JaxDGSQPV2(js.joint_model, js.costs, js.agent_constraints, js.shared_constraints,
                      js.bounds, JaxParams(N=n, **V2), print_method=None)
    tsol = DGSQPV2(ts.joint_model, ts.costs, ts.agent_constraints, ts.shared_constraints,
                   ts.bounds, DGSQPV2Params(N=n, **V2), print_method=None,
                   dtype=torch.float64, device='cpu')
    jp, tp = jsol.problem, tsol.problem
    assert (tp.n_dec, tp.n_c_total) == (jp.n_dec, jp.n_c_total)
    rng = np.random.default_rng(5)
    u = rng.normal(0.0, 0.3, (GAMES, tp.n_dec))
    lam = np.maximum(rng.uniform(-1.0, 1.0, (GAMES, tp.n_c_total)), 0.0)
    up = rng.normal(0.0, 0.1, (GAMES, tp.n_u))
    out_j = jax.jit(jax.vmap(jp.evaluate))(*(jnp.asarray(a) for a in (u, lam, x0, up)))
    out_t = tp.evaluate(*(torch.tensor(a) for a in (u, lam, x0, up)))
    for name, a_j, a_t in zip('QqGgx', out_j, out_t):
        _close(a_t.numpy(), a_j, name, 1e-10)
    # v2's QP step on the (symmetrised) game Hessian, as its round takes it
    reg = tsol.params.reg
    Qs = [0.5 * (Q + Q.swapaxes(-1, -2)) for Q in (np.asarray(out_j[0]), out_t[0].numpy())]
    step_j = jax.jit(jax.vmap(lambda Q, q, G, g: jsol._qp(Q, q, G, g, reg)))(
        jnp.asarray(Qs[0]), *out_j[1:4])
    step_t = tsol._qp(torch.tensor(Qs[1]), *out_t[1:4],
                      torch.full((GAMES,), reg, dtype=torch.float64))
    np.testing.assert_array_equal(step_t[2].numpy(), np.asarray(step_j[2]))
    assert step_t[2].all()
    _close(step_t[0].numpy(), step_j[0], 'du', 1e-8)
    _close(step_t[1].numpy(), step_j[1], 'lam', 1e-8)


def test_dynamic_study_script_runs(tmp_path, capsys):
    _script('torch_monte_carlo_main').main(
        ['--scenario', 'dynamic', '--solver', 'dgsqp_v2', '--N', '3', '--n', '2',
         '--sqp_iters', '2', '--device', 'cpu', '--dtype', 'float64', '--out',
         str(tmp_path)])
    assert '"solver": "DGSQPV2"' in capsys.readouterr().out
    with open(tmp_path / 'dynamic_duel_N3_c0_dgsqp_v2_exact_it2_float64_n2_s0.pkl',
              'rb') as f:
        res = pickle.load(f)
    assert res.u_sol.shape == (2, 12) and np.isfinite(res.u_sol).all()
    assert (res.statuses != 0).all() and res.provenance['platform'] == 'cpu'
    # the study's draw: the sampler's games
    x0 = tds.sample_dynamic_duel_initial_conditions(tsc.build_dynamic_duel(N=3), 2, seed=0,
                                                    dtype=torch.float64, device='cpu')[0]
    np.testing.assert_array_equal(res.x0, x0)


@pytest.mark.parametrize('formulation', ['exact', 'approximate'])
def test_default_names_are_the_records(formulation):
    script = _script('torch_monte_carlo_main')
    ap = script.parser()
    args = ap.parse_args(['--scenario', 'dynamic', '--formulation', formulation,
                          '--solver', 'dgsqp_v2', '--n', '64', '--N', '15',
                          '--out', 'results/r5'])
    sc = script.build_scenario(args)
    assert type(sc.joint_model.dynamics_models[0]).__name__ == (
        'DynamicBicycleCombined' if formulation == 'exact'
        else 'DynamicBicycleProgressAugmented')
    path = script.output_path(args, ap, sc)
    assert path.parent == Path('results/r5')
    assert (ROOT / path.with_suffix('.json')).exists()
