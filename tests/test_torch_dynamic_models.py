"""Port parity: the dynamic bicycles, on the CPU in float64.

* ``DynamicBicycle``, ``DynamicCLBicycle``, ``DynamicBicycleCombined`` and
  ``DynamicBicycleProgressAugmented``: ``fd`` and its Jacobians and Hessians (``fAd``,
  ``fBd``, ``fEd``, ``fFd``, ``fGd``) at seeded states match the JAX package's within
  1e-10 of each quantity's largest entry (at least 1), over both tire models, both
  ``drive_wheels``, ``simple_slip`` on and off, the resistance terms, every
  discretisation, the BARC study car and the F1 car (Pacejka D ~ 309 N).  The step goes
  through ``dgsqp_torch.ops.dynamics.fd_step``, whose plain version runs here.
* At vx = 0 the port's derivatives are finite; the JAX package's are NaN (its pow rule
  makes the zero rolling-resistance term's derivative 0 * 0^-1), and at vx = 1e-100 they
  are finite and equal the port's at 0 within the same tolerance.
* The plain version of the fused step (the model's ``fd_plain`` on second-order
  numbers) matches ``torch.func`` on ``fd_plain`` within 1e-12 for every case.
* Off the CPU the fused step raises for a model or track the kernel does not have (a
  Frenet frame on a spline track, a subclass) instead of running the plain version,
  and ``fd`` raises for a step other than the model's own ``dt``.
* ``DynamicBicycleConfig`` derives the Pacejka peak forces as the JAX package does;
  ``get_dynamics_model`` builds all ten of the JAX factory's models by name; a model
  built from ``track_name`` loads the saved track.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.func import jacfwd, vmap

from dgsqp_tpu import dynamics as jdyn
from dgsqp_tpu.dynamics import progress_augmented as jpa
from dgsqp_tpu.dynamics.models import get_dynamics_model as jax_get_model
from dgsqp_torch import dynamics as tdyn
from dgsqp_torch.dynamics import progress_augmented as tpa
from dgsqp_torch.ops.dynamics import dyn_step_plain

from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

BARC = dict(dt=0.1, discretization_method='rk4', M=10, mass=2.2187, yaw_inertia=0.02723,
            wheel_friction=0.9, pacejka_b_front=5.0, pacejka_b_rear=5.0,
            pacejka_c_front=2.28, pacejka_c_rear=2.28)
F1_CAR = dict(dt=0.1, discretization_method='rk4', wheel_dist_front=0.18,
              wheel_dist_rear=0.18, mass=70.0, yaw_inertia=2.0627, wheel_friction=0.9,
              pacejka_b_front=10.0, pacejka_b_rear=10.0, pacejka_c_front=2.5,
              pacejka_c_rear=2.5)
# (class, configuration, frame): every tire model, drive, slip law, resistance term and
# discretisation is taken by at least one case
MODELS = {
    'combined_barc': ('DynamicBicycleCombined', dict(BARC, track_name='L_track_barc'),
                      'combined'),
    'cl_linear_rear_slip': ('DynamicCLBicycle',
                            dict(dt=0.1, discretization_method='rk3', M=3, tire_model='linear',
                                 drive_wheels='rear', simple_slip=True,
                                 damping_coefficient=0.1, drag_coefficient=0.2,
                                 track_name='L_track_barc'), 'frenet'),
    'global_rolling_euler': ('DynamicBicycle',
                             dict(dt=0.05, rolling_resistance=0.3,
                                  rolling_resistance_exponent=0.5), 'global'),
    'global_rk2': ('DynamicBicycle', dict(dt=0.1, discretization_method='rk2', M=4,
                                          rolling_resistance=0.2), 'global'),
    'progress_f1_car': ('DynamicBicycleProgressAugmented',
                        dict(F1_CAR, track_name='L_track_barc'), 'progress'),
}
FNS = ('fd', 'fAd', 'fBd', 'fEd', 'fFd', 'fGd')


def _points(frame, rng, n=4):
    """States and inputs of each frame's layout: moving, sliding, on the track."""
    vx = rng.uniform(0.5, 2.0, n)
    vy = rng.uniform(-0.3, 0.3, n)
    psidot = rng.uniform(-1.0, 1.0, n)
    xy = rng.uniform(-2.0, 2.0, (n, 2))
    ang = rng.uniform(-0.3, 0.3, n)
    s = rng.uniform(-1.0, 18.0, n)            # across the start line of L_track_barc
    ey = rng.uniform(-0.4, 0.4, n)
    q = {'global': np.column_stack([vx, vy, psidot, xy, ang]),
         'frenet': np.column_stack([vx, vy, psidot, ang, s, ey]),
         'combined': np.column_stack([xy, vx, vy, psidot, ang, s, ey]),
         'progress': np.column_stack([vx, vy, psidot, xy, ang, s])}[frame]
    u = np.column_stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-0.4, 0.4, n)])
    if frame == 'progress':
        u = np.column_stack([u, rng.uniform(0.0, 3.0, n)])
    return q, u


def _models(name):
    cls, kw, _ = MODELS[name]
    jmod = jpa if cls.endswith('Augmented') else jdyn
    tmod = tpa if cls.endswith('Augmented') else tdyn
    jm = getattr(jmod, cls)(0.0, jdyn.DynamicBicycleConfig(**kw))
    tm = getattr(tmod, cls)(0.0, tdyn.DynamicBicycleConfig(**kw))
    return jm, tm


def _close(out, ref, what, rtol=1e-10):
    scale = max(1.0, float(np.max(np.abs(ref))))
    np.testing.assert_allclose(out, ref, rtol=0, atol=rtol * scale, err_msg=what)


_JAX = {}


def _jax_all(name, q, u):
    """The six at (q, u) by the JAX model of case ``name``: one JAX program per case,
    compiled once per file for its point count."""
    if name not in _JAX:
        jm = _models(name)[0]
        _JAX[name] = jax.jit(jax.vmap(lambda q_, u_: [getattr(jm, fn)(q_, u_) for fn in FNS]))
    return _JAX[name](jnp.asarray(q), jnp.asarray(u))


def _torch_all(tm, q, u):
    qt, ut = torch.tensor(q), torch.tensor(u)
    return [(tm.fd(qt, ut) if fn == 'fd' else vmap(getattr(tm, fn))(qt, ut)).numpy()
            for fn in FNS]


@pytest.mark.parametrize('name', list(MODELS))
def test_model_and_derivatives_match_jax(name):
    jm, tm = _models(name)
    assert (tm.n_q, tm.n_u) == (jm.n_q, jm.n_u)
    q, u = _points(MODELS[name][2], np.random.default_rng(7))
    for fn, out, ref in zip(FNS, _torch_all(tm, q, u), _jax_all(name, q, u)):
        _close(out, np.asarray(ref), f'{name}.{fn}')


@pytest.mark.parametrize('name', list(MODELS))
def test_plain_step_matches_torch_func(name):
    tm = _models(name)[1]
    q, u = (torch.tensor(a) for a in _points(MODELS[name][2], np.random.default_rng(3)))
    f, J, H = dyn_step_plain(tm, q, u, 2)
    nq = tm.n_q
    step = lambda z: tm.fd_plain(z[:nq], z[nq:])
    z = torch.cat([q, u], dim=-1)
    for what, out, ref in (('f', f, tm.fd_plain(q, u)), ('J', J, vmap(jacfwd(step))(z)),
                           ('H', H, vmap(jacfwd(jacfwd(step)))(z))):
        _close(out.numpy(), ref.numpy(), f'{name} {what}', rtol=1e-12)
    assert torch.equal(dyn_step_plain(tm, q, u, 1)[1], J)


def test_step_without_kernel_raises_off_cpu():
    """A tensor that is not on the CPU never takes the plain version: a model or track
    the kernel does not have raises before any device check (here on ``meta``)."""
    spline = tdyn.DynamicCLBicycle(0.0, tdyn.DynamicBicycleConfig(
        **F1_CAR, track_name='f1_austin_tenth_scale'))

    class Sub(tdyn.DynamicBicycle):
        pass
    sub = Sub(0.0, tdyn.DynamicBicycleConfig(dt=0.1))
    for m in (spline, sub):
        q, u = torch.zeros(2, m.n_q, device='meta'), torch.zeros(2, m.n_u, device='meta')
        with pytest.raises(ValueError, match='no kernel'):
            m.fd(q, u)
    barc = _models('combined_barc')[1]
    q, u = torch.zeros(2, barc.n_q, device='meta'), torch.zeros(2, barc.n_u, device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        barc.fd(q, u)
    q, u = torch.zeros(2, barc.n_q), torch.zeros(2, barc.n_u)
    assert torch.equal(barc.fd(q, u, barc.dt), barc.fd(q, u))
    with pytest.raises(ValueError, match='own dt'):
        barc.fd(q, u, 0.05)


def test_zero_speed_derivatives():
    tm = _models('combined_barc')[1]
    q, u = _points('combined', np.random.default_rng(11))
    q[:, 2] = 0.0                                     # vx = 0, vy and psidot not
    out = _torch_all(tm, q, u)
    for fn, a in zip(FNS, out):
        assert np.isfinite(a).all(), fn
    jax_at_zero = _jax_all('combined_barc', q, u)
    assert np.isnan(np.asarray(jax_at_zero[1])).any()  # fAd: the reference's NaN
    q_tiny = q.copy()
    q_tiny[:, 2] = 1e-100
    for fn, a, ref in zip(FNS, out, _jax_all('combined_barc', q_tiny, u)):
        _close(a, np.asarray(ref), f'vx=0 {fn}')


@pytest.mark.parametrize('kw', [{}, F1_CAR, dict(wheel_dist_front=0.1, wheel_friction=0.5),
                                dict(pacejka_d_front=3.0)])
def test_config_derives_peak_forces(kw):
    jc, tc = jdyn.DynamicBicycleConfig(**kw), tdyn.DynamicBicycleConfig(**kw)
    assert tc.pacejka_d_front == jc.pacejka_d_front
    assert tc.pacejka_d_rear == jc.pacejka_d_rear
    assert tc.__dict__.keys() == jc.__dict__.keys()


def test_get_dynamics_model_all_names():
    names = ['dynamic_bicycle', 'dynamic_bicycle_cl', 'dynamic_bicycle_combined',
             'kinematic_bicycle', 'kinematic_bicycle_cl', 'kinematic_bicycle_combined',
             'kinematic_unicycle', 'kinematic_unicycle_cl', 'kinematic_unicycle_combined',
             'integrator']
    for name in names:
        cfg = ('DynamicBicycleConfig' if name.startswith('dynamic') else
               'KinematicBicycleConfig' if name.startswith('kinematic_bicycle') else
               'UnicycleConfig' if name.startswith('kinematic_unicycle') else
               'DynamicsConfig')
        jm = jax_get_model(name, 0.0, getattr(jdyn, cfg)(track_name='L_track_barc'))
        tm = tdyn.get_dynamics_model(name, 0.0, getattr(tdyn, cfg)(track_name='L_track_barc'))
        assert type(tm).__name__ == type(jm).__name__
        assert (tm.n_q, tm.n_u) == (jm.n_q, jm.n_u)
    with pytest.raises(ValueError):
        tdyn.get_dynamics_model('no_such_model', 0.0, tdyn.DynamicsConfig())


def test_model_loads_track_by_name():
    cfg = dict(BARC, track_name='L_track_barc')
    jm = jdyn.DynamicBicycleCombined(0.0, jdyn.DynamicBicycleConfig(**cfg))
    tm = tdyn.DynamicBicycleCombined(0.0, tdyn.DynamicBicycleConfig(**cfg))
    assert type(tm.track).__name__ == type(jm.track).__name__ == 'RadiusArclengthTrack'
    assert tm.track.track_length == jm.track.track_length
    assert tm.track.half_width == jm.track.half_width
    s = np.linspace(-1.0, 19.0, 41)
    for fn in ('curvature', 'tangent_angle'):
        _close(getattr(tm.track, fn)(torch.tensor(s)).numpy(),
               np.asarray(getattr(jm.track, fn)(jnp.asarray(s))), fn, rtol=1e-14)
