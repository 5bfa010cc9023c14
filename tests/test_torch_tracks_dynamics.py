"""Port parity: tracks, the kinematic-bicycle-combined model and the joint dynamics.

Same inputs (numpy, fixed seed) through ``dgsqp_tpu`` and ``dgsqp_torch`` in float64 on
the CPU; values and derivatives agree to 1e-12, including at the segment breakpoints
where ``curvature`` jumps and ``tangent_angle`` has a kink (both packages take the
segment to the right there).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.func import grad, jacfwd

from dgsqp_tpu.harness.scenarios import build_chicane_scenario as jax_chicane
from dgsqp_torch.harness.scenarios import build_chicane_scenario as torch_chicane
from dgsqp_torch.tracks import CurveTrack, StraightTrack
from dgsqp_tpu.tracks import CurveTrack as JCurveTrack, StraightTrack as JStraightTrack

from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-12


@pytest.fixture(scope='module')
def scenarios():
    return jax_chicane(N=6), torch_chicane(N=6)


def _arclengths(track, rng):
    """Random arc lengths (some beyond the track ends) plus every breakpoint."""
    s = rng.uniform(-2.0, track.track_length + 2.0, 40)
    return np.concatenate([s, track.key_pts[:, 3], [track.track_length - 1e-9]])


def test_key_points_match(scenarios):
    jsc, tsc = scenarios
    np.testing.assert_array_equal(tsc.track.key_pts, np.asarray(jsc.track._kp))
    np.testing.assert_array_equal(tsc.track.cum_angle, np.asarray(jsc.track._cum_angle))


@pytest.mark.parametrize('fn', ['curvature', 'tangent_angle'])
def test_track_lookup_values_and_slopes(scenarios, fn):
    jsc, tsc = scenarios
    s = _arclengths(tsc.track, np.random.default_rng(0))
    v_j = np.asarray(getattr(jsc.track, fn)(jnp.asarray(s)))
    v_t = getattr(tsc.track, fn)(torch.tensor(s)).numpy()
    np.testing.assert_allclose(v_t, v_j, rtol=0, atol=TOL)
    d_j = np.asarray(jax.vmap(jax.grad(getattr(jsc.track, fn)))(jnp.asarray(s)))
    d_t = torch.func.vmap(grad(getattr(tsc.track, fn)))(torch.tensor(s)).numpy()
    np.testing.assert_allclose(d_t, d_j, rtol=0, atol=TOL)


@pytest.mark.parametrize('kind', ['chicane', 'curve', 'straight'])
def test_local_global_round_trip(scenarios, kind):
    rng = np.random.default_rng(1)
    if kind == 'chicane':
        jt, tt = scenarios[0].track, scenarios[1].track
    elif kind == 'curve':
        args = (1.0, 4.0, np.pi / 3, 5.0, 2.0, 0.8)
        jt, tt = JCurveTrack(*args), CurveTrack(*args)
    else:
        jt, tt = JStraightTrack(10.0, 2.0, 0.5), StraightTrack(10.0, 2.0, 0.5)
    n = 60
    cl = np.stack([rng.uniform(0, tt.track_length, n), rng.uniform(-0.9, 0.9, n),
                   rng.uniform(-0.5, 0.5, n)], -1)
    xy_j = np.asarray(jt.local_to_global(jnp.asarray(cl)))
    xy_t = tt.local_to_global(torch.tensor(cl)).numpy()
    np.testing.assert_allclose(xy_t, xy_j, rtol=0, atol=TOL)
    back_t = tt.global_to_local(torch.tensor(xy_t)).numpy()
    back_j = np.asarray(jt.global_to_local(jnp.asarray(xy_j)))
    np.testing.assert_allclose(back_t, back_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(back_t, cl, rtol=0, atol=1e-9)


def _states(rng, n):
    """Joint states [x, y, v, e_psi, s, x_tran] x2 spread over the chicane, with arc
    lengths exactly on breakpoints for a few of them; joint inputs [a, steer] x2."""
    q = np.zeros((n, 12))
    for off in (0, 6):
        q[:, off:off + 2] = rng.uniform(-2, 10, (n, 2))
        q[:, off + 2] = rng.uniform(1, 3, n)
        q[:, off + 3] = rng.uniform(-0.3, 0.3, n)
        q[:, off + 4] = rng.uniform(0, 15, n)
        q[:, off + 5] = rng.uniform(-0.8, 0.8, n)
    q[:4, 4] = [1.0, 5.0, 6.0, 10.0]
    u = rng.uniform(-0.4, 0.4, (n, 4))
    return q, u


def test_joint_dynamics_and_jacobians(scenarios):
    jsc, tsc = scenarios
    q, u = _states(np.random.default_rng(2), 12)
    jm, tm = jsc.joint_model, tsc.joint_model
    fd_j = np.asarray(jax.vmap(jm.fd)(jnp.asarray(q), jnp.asarray(u)))
    fd_t = tm.fd(torch.tensor(q), torch.tensor(u)).numpy()
    np.testing.assert_allclose(fd_t, fd_j, rtol=0, atol=TOL)
    for argnum in (0, 1):
        J_j = np.asarray(jax.vmap(jax.jacfwd(jm.fd, argnums=argnum))(jnp.asarray(q),
                                                                      jnp.asarray(u)))
        J_t = torch.func.vmap(jacfwd(tm.fd, argnums=argnum))(torch.tensor(q),
                                                             torch.tensor(u)).numpy()
        np.testing.assert_allclose(J_t, J_j, rtol=0, atol=TOL)
    # the single-agent model's own Jacobians (fAd/fBd) agree too
    m_j, m_t = jm.dynamics_models[0], tm.dynamics_models[0]
    A_j = np.asarray(m_j.fAd(jnp.asarray(q[0, :6]), jnp.asarray(u[0, :2])))
    A_t = m_t.fAd(torch.tensor(q[0, :6]), torch.tensor(u[0, :2])).numpy()
    np.testing.assert_allclose(A_t, A_j, rtol=0, atol=TOL)


def test_rollout_matches(scenarios):
    from dgsqp_tpu.solvers.game_problem import GameProblem as JGP
    from dgsqp_torch.solvers.game_problem import GameProblem as TGP
    jsc, tsc = scenarios
    jp = JGP(jsc.joint_model, jsc.costs, jsc.agent_constraints, jsc.shared_constraints,
             jsc.bounds, jsc.N)
    tp = TGP(tsc.joint_model, tsc.costs, tsc.agent_constraints, tsc.shared_constraints,
             tsc.bounds, tsc.N, device='cpu')
    rng = np.random.default_rng(3)
    q, _ = _states(rng, 5)
    u = rng.uniform(-0.4, 0.4, (5, tp.n_dec))
    x_j = np.asarray(jax.vmap(jp.rollout)(jnp.asarray(u), jnp.asarray(q)))
    x_t = tp.rollout(torch.tensor(u), torch.tensor(q)).numpy()
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=TOL)
    np.testing.assert_array_equal(tp.u_to_stage(torch.tensor(u)).numpy(),
                                  np.asarray(jax.vmap(jp.u_to_stage)(jnp.asarray(u))))
    np.testing.assert_array_equal(
        tp.stage_to_u(tp.u_to_stage(torch.tensor(u))).numpy(), u)


def _fields(msg, prefix=''):
    """A message's fields, flattened to {'x.x': value, ...}."""
    import dataclasses
    out = {}
    for f in dataclasses.fields(msg):
        v = getattr(msg, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_fields(v, f'{prefix}{f.name}.'))
        else:
            out[prefix + f.name] = v
    return out


def _random_state(types, rng):
    st = types.VehicleState()
    st.x.x, st.x.y, st.e.psi = rng.normal(size=3)
    st.v.v_long, st.v.v_tran, st.w.w_psi = rng.normal(size=3)
    st.p.s, st.p.x_tran, st.p.e_psi = rng.normal(size=3)
    st.u.u_a, st.u.u_steer = rng.normal(size=2)
    return st


def test_host_marshalling_matches_jax(scenarios):
    """The host conversions between vehicle messages and arrays (``u2input``,
    ``q2state``; the joint model's ``state2qu``, ``state2u``, ``input2u``, ``q2state``)
    agree with the JAX package's on one state of each of the chicane's models, and
    ``remove_phase_out`` drops the appended straight as the JAX track does."""
    import dgsqp_tpu.types as jtypes
    import dgsqp_torch.types as ttypes
    from dgsqp_tpu.tracks import ChicaneTrack as JChicaneTrack
    from dgsqp_torch.tracks import ChicaneTrack
    jsc, tsc = scenarios
    jm, tm = jsc.joint_model, tsc.joint_model
    rng = np.random.default_rng(3)
    q, u = rng.normal(size=jm.n_q), rng.normal(size=jm.n_u)
    seeds = [rng.integers(1 << 30) for _ in range(jm.n_a)]
    states_j = [_random_state(jtypes, np.random.default_rng(s)) for s in seeds]
    states_t = [_random_state(ttypes, np.random.default_rng(s)) for s in seeds]
    inputs_j = [st.u for st in states_j]
    inputs_t = [st.u for st in states_t]
    for a, (mj, mt) in enumerate(zip(jm.dynamics_models, tm.dynamics_models)):
        ua = u[jm.u_offsets[a]:jm.u_offsets[a + 1]]
        qa = q[jm.q_offsets[a]:jm.q_offsets[a + 1]]
        inp_j, inp_t = jtypes.VehicleActuation(), ttypes.VehicleActuation()
        mj.u2input(inp_j, ua)
        mt.u2input(inp_t, ua)
        assert _fields(inp_t) == _fields(inp_j)
        st_j, st_t = states_j[a].copy(), states_t[a].copy()
        mj.q2state(st_j, qa)
        mt.q2state(st_t, qa)
        assert _fields(st_t) == _fields(st_j)
    q_j, u_j = jm.state2qu(states_j)
    q_t, u_t = tm.state2qu(states_t)
    np.testing.assert_array_equal(q_t, q_j)
    np.testing.assert_array_equal(u_t, u_j)
    np.testing.assert_array_equal(tm.state2u(states_t), jm.state2u(states_j))
    np.testing.assert_array_equal(tm.input2u(inputs_t), jm.input2u(inputs_j))
    st_j, st_t = [s.copy() for s in states_j], [s.copy() for s in states_t]
    jm.q2state(st_j, q)
    tm.q2state(st_t, q)
    assert [_fields(s) for s in st_t] == [_fields(s) for s in st_j]

    args = (1, 4, np.pi / 4, 1, 4, np.pi / 4, 2, 1.6, 0.0)
    tj, tt = JChicaneTrack(*args, phase_out=True), ChicaneTrack(*args, phase_out=True)
    assert tt.track_length == float(tj.track_length)
    for track in (tj, tt):
        track.remove_phase_out()
    assert tt.phase_out is tj.phase_out is False
    np.testing.assert_array_equal(tt.cl_segs, np.asarray(tj.cl_segs))
    np.testing.assert_array_equal(tt.key_pts, np.asarray(tj._kp))
    assert tt.track_length == float(tj.track_length)
