"""Port parity: CA-LTV-MPC, PID, the plant simulator and the models' host pieces, on the
CPU in float64, against the JAX package on the same inputs.

* ``tests/test_ca_ltv_mpc.py``'s unicycle tracking MPC (N = 10) with both QP backends
  and in three variants (the plain tracker; soft state bounds; a nonlinear obstacle
  constraint): ``u_pred``, ``q_pred`` and ``du_pred`` after one ``solve`` and after
  each of 5 closed-loop ``step``s (the plant stepped by the models' host ``step``)
  within ``PRED_ATOL``, and the same success flags.
* The race's tracker (``make_tracker``: a ``DynamicBicycleCombined`` with the race's
  costs and collision row) at N = 5 on ``tests/test_race.py``'s ``CurveTrack``: one
  solve and 3 closed-loop steps with the plants in ``DynamicsSimulator`` at the race's
  finer step.  (Cut to M = 2 sub-steps, this model's stiff tire forces make the
  tracker's QP ill-conditioned, and both packages' predictions then move by ~1e-9
  under a 1e-13 change of the linearization: the test keeps the race's M = 10.)
* ``PID`` and ``PIDLaneFollower`` over 20 steps; ``DynamicsSimulator`` with input
  delay and process noise from the same numpy ``rng``; ``fd_noisy``;
  ``qu2interpolator``; the solvers' registration under ``AbstractSolver``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import dgsqp_tpu.types as jtypes
import dgsqp_torch.types as ttypes
from dgsqp_tpu.dynamics import KinematicUnicycle as JUni, UnicycleConfig as JUniCfg
from dgsqp_tpu.dynamics.simulator import DynamicsSimulator as JSim
from dgsqp_tpu.harness import race as jrace
from dgsqp_tpu.solvers.ca_ltv_mpc import CA_LTV_MPC as JMPC
from dgsqp_tpu.solvers.pid import PID as JPID, PIDLaneFollower as JLane
from dgsqp_tpu.solvers.solver_types import CALTVMPCParams as JParams, PIDParams as JPIDParams
from dgsqp_tpu.tracks import CurveTrack as JCurve
from dgsqp_torch.dynamics import KinematicUnicycle as TUni, UnicycleConfig as TUniCfg
from dgsqp_torch.dynamics.simulator import DynamicsSimulator as TSim
from dgsqp_torch.harness import race as trace_
from dgsqp_torch.interop import load_track_tables
from dgsqp_torch.solvers.abstract_solver import AbstractSolver
from dgsqp_torch.solvers.ca_ltv_mpc import CA_LTV_MPC as TMPC
from dgsqp_torch.solvers.pid import PID as TPID, PIDLaneFollower as TLane
from dgsqp_torch.solvers.solver_types import CALTVMPCParams as TParams, PIDParams as TPIDParams
from dgsqp_torch.tracks.track_lib import CurveTrack as TCurve

from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

N, DT = 10, 0.1
# float64 on both sides, the same IPM iterations: rounding only, through 5 closed-loop
# steps of damped SQP
PRED_ATOL = 1e-9


def _close(a, b, what, atol=PRED_ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol, err_msg=what)


def _same_predictions(j, t, what):
    for f in ('u_pred', 'q_pred', 'du_pred'):
        _close(t.__dict__[f], j.__dict__[f], f'{what} {f}')


# ------------------------------------------------------------- the unicycle MPC
def _unicycle_mpc(pkg, variant, backend):
    """``tests/test_ca_ltv_mpc.py``'s trackers, in the JAX package or the port."""
    jax_side = pkg == 'jax'
    T = jtypes if jax_side else ttypes
    arr = jnp.asarray if jax_side else torch.as_tensor
    dot = jnp.dot if jax_side else torch.dot
    one_d = jnp.atleast_1d if jax_side else torch.atleast_1d
    model = (JUni(0.0, JUniCfg(dt=DT)) if jax_side else TUni(0.0, TUniCfg(dt=DT)))
    W = arr(np.diag([10.0, 10.0, 1.0, 1.0]))
    tgt = arr(np.array([1.0, 0.8 if variant == 'soft' else 0.5, 0.0, 0.0]))
    costs = {'state': [lambda q: 0.5 * (q - tgt) @ W @ (q - tgt)] * (N + 1),
             'input': [lambda u: 0.05 * (u[0] ** 2 + u[1] ** 2)] * (N + 1),
             'rate': [lambda du: 0.05 * (du[0] ** 2 + du[1] ** 2)] * N}
    p_obs = arr(np.array([0.5, 0.25]))

    def obs_avoid(q, u):
        d = q[0:2] - p_obs
        return one_d(0.2 ** 2 - dot(d, d))
    obs_avoid.n_out = 1
    nl = variant == 'nonlinear'
    constraints = {'state_input': [None] + [obs_avoid if nl else None] * N,
                   'rate': [None] * N}
    y_lim = 0.5 if variant == 'soft' else np.inf
    du = 10.0 * DT if variant == 'plain' else 1.0
    bound = lambda sgn: T.VehicleState(
        x=T.Position(x=sgn * np.inf, y=sgn * y_lim), e=T.OrientationEuler(psi=sgn * np.inf),
        v=T.BodyLinearVelocity(v_long=sgn * 5.0), u=T.VehicleActuation(u_a=sgn * 3.0,
                                                                       u_steer=sgn * 3.0))
    du_b = lambda sgn: T.VehicleState(u=T.VehicleActuation(u_a=sgn * du, u_steer=sgn * du))
    soft = dict(soft_state_bound_idxs=[1], soft_state_bound_quad=[50.0],
                soft_state_bound_lin=[5.0]) if variant == 'soft' else {}
    Params = JParams if jax_side else TParams
    params = Params(N=N, dt=DT, qp_iters=2 if variant == 'soft' else 3, damping=0.5,
                    qp_backend=backend, **soft)
    bounds = {'qu_ub': bound(1), 'qu_lb': bound(-1), 'du_ub': du_b(1), 'du_lb': du_b(-1)}
    if jax_side:
        return model, JMPC(model, costs, constraints, bounds, params, print_method=None)
    return model, TMPC(model, costs, constraints, bounds, params, print_method=None,
                       dtype=torch.float64, device='cpu')


@pytest.mark.parametrize('variant', ['plain', 'soft', 'nonlinear'])
@pytest.mark.parametrize('backend', ['riccati', 'dense'])
def test_unicycle_mpc_matches_jax(variant, backend):
    mj, cj = _unicycle_mpc('jax', variant, backend)
    mt, ct = _unicycle_mpc('torch', variant, backend)
    assert ct.qp_backend == cj.qp_backend == backend
    sj, st = jtypes.VehicleState(t=0.0), ttypes.VehicleState(t=0.0)
    sj.v.v_long = st.v.v_long = 0.5
    assert cj.solve(sj) == ct.solve(st) is True
    _same_predictions(cj, ct, 'solve')
    for k in range(5):
        assert cj.step(sj) == ct.step(st)
        _same_predictions(cj, ct, f'step {k}')
        mj.step(sj)
        mt.step(st, device='cpu')
        _close(mt.state2q(st), mj.state2q(sj), f'state after step {k}')
    # the prediction's dense-time interpolator
    tt = np.linspace(0.0, 1.2, 7)
    for a, b in zip(ct.get_prediction_interpolator()(tt), cj.get_prediction_interpolator()(tt)):
        _close(a, b, 'interpolator')
    _close(ct.get_prediction().x, cj.get_prediction().x, 'prediction x')


# ----------------------------------------------------------- the race's tracker
@pytest.fixture(scope='module')
def curve_tracks():
    kw = dict(enter_straight_length=4, curve_length=6, curve_swept_angle=np.pi / 2,
              exit_straight_length=6, width=2.0, slack=0.8)
    jt, tt = JCurve(**kw), TCurve(**kw)
    load_track_tables(tt, jt.key_pts, jt.cum_angle)
    return jt, tt


def test_race_tracker_on_dynamic_bicycle_matches_jax(curve_tracks):
    jt, tt = curve_tracks
    n = 5
    mj, cj = jrace.make_tracker(jt, N=n)
    mt, ct = trace_.make_tracker(tt, N=n, device='cpu')
    sims = JSim(0.0, mj), TSim(0.0, mt, device='cpu')
    states = []
    for T, track in ((jtypes, jt), (ttypes, tt)):
        st = T.VehicleState(t=0.0)
        st.p.s, st.p.x_tran, st.v.v_long = 1.0, 0.15, 1.2
        track.local_to_global_typed(st)
        states.append(st)
    _close(mt.state2q(states[1]), mj.state2q(states[0]), 'start')
    for k in range(3):
        # the centerline at 1.2 m/s ahead of the car, and an opponent 0.6 m ahead
        s = states[0].p.s + 1.2 * DT * np.arange(n + 1)
        xyp = np.asarray(jt.local_to_global(np.stack([s, 0 * s, 0 * s], -1)))
        q_ref = np.zeros((n + 1, 8))
        q_ref[:, 0:2], q_ref[:, 2], q_ref[:, 6] = xyp[:, :2], 1.2, s
        p_obs = np.asarray(jt.local_to_global(np.stack([s + 0.6, 0 * s - 0.1, 0 * s], -1)))
        outs = [mpc.step(st, parameters={'q_ref': arr(q_ref), 'p_obs': arr(p_obs[:, :2])})
                for mpc, st, arr in ((cj, states[0], jnp.asarray),
                                     (ct, states[1], torch.as_tensor))]
        assert outs[0]['success'] == outs[1]['success']
        _same_predictions(cj, ct, f'step {k}')
        for _ in range(5):
            for sim, st in zip(sims, states):
                sim.step(st, T=0.02)
        _close(mt.state2q(states[1]), mj.state2q(states[0]), f'plant after step {k}')
        _close(states[1].e.psi, states[0].e.psi, 'psi')


# ------------------------------------------------------------------------ PID
def test_pid_and_lane_follower_match_jax():
    rng = np.random.default_rng(0)
    kw = dict(dt=0.1, Kp=1.5, Ki=0.3, Kd=0.05, u_max=1.0, u_min=-1.0, du_max=0.3,
              du_min=-0.3, x_ref=0.4)
    pj, pt = JPID(JPIDParams(**kw)), TPID(TPIDParams(**kw))
    lj, lt = JLane(0.1), TLane(0.1)
    sj, st = jtypes.VehicleState(t=0.0), ttypes.VehicleState(t=0.0)
    for k in range(20):
        x = float(rng.normal())
        assert pj.solve(x) == pt.solve(x)
        v, ey, ep = rng.normal(size=3)
        for s in (sj, st):
            s.v.v_long, s.p.x_tran, s.p.e_psi = float(v), float(ey), float(ep)
        lj.step(sj)
        lt.step(st)
        assert (sj.u.u_a, sj.u.u_steer) == (st.u.u_a, st.u.u_steer), k


# --------------------------------------------- the simulator and the host step
def _noisy_unicycles():
    kw = dict(dt=0.1, noise=True, noise_cov=np.array([1e-3, 2e-3, 1e-4, 5e-4]))
    return JUni(0.0, JUniCfg(**kw)), TUni(0.0, TUniCfg(**kw))


def test_simulator_with_delay_and_noise_matches_jax():
    mj, mt = _noisy_unicycles()
    _close(mt.noise_sqrt, mj.noise_sqrt, 'noise_sqrt', 1e-15)
    sims = (JSim(0.0, mj, delay=[0.2, 0.1]), TSim(0.0, mt, delay=[0.2, 0.1], device='cpu'))
    rngs = np.random.default_rng(3), np.random.default_rng(3)
    states = jtypes.VehicleState(t=0.0), ttypes.VehicleState(t=0.0)
    for st in states:
        st.v.v_long = 0.8
    for k in range(10):
        for sim, st, rng in zip(sims, states, rngs):
            st.u.u_a, st.u.u_steer = 0.3 * np.sin(k), 0.2 * np.cos(k)
            sim.step(st, rng=rng)
        _close(mt.state2q(states[1]), mj.state2q(states[0]), f'step {k}', 1e-12)
        assert states[0].t == pytest.approx(states[1].t, abs=1e-12)


def test_fd_noisy_matches_jax():
    mj, mt = _noisy_unicycles()
    rng = np.random.default_rng(1)
    q, u, m = rng.normal(size=4), rng.normal(size=2), rng.normal(size=4)
    ref = np.asarray(mj.fd_noisy(jnp.asarray(q), jnp.asarray(u), jnp.asarray(m)))
    out = mt.fd_noisy(*map(torch.as_tensor, (q, u, m))).numpy()
    _close(out, ref, 'fd_noisy', 1e-12)


def test_solvers_are_registered_under_the_contract():
    from dgsqp_torch.solvers.dgsqp import DGSQP
    from dgsqp_torch.solvers.mcp import PATHMCP
    for cls in (TMPC, DGSQP, PATHMCP):
        assert issubclass(cls, AbstractSolver)
    assert AbstractSolver.install(None) is None
