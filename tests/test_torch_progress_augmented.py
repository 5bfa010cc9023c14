"""Port parity for the progress-augmented models (``dgsqp_torch/dynamics/
progress_augmented.py``) on the CPU in float64, within 1e-12 of the largest entry of each
compared quantity (at least 1; the O(1e3) lag weight scales the contouring/lag ones).

On the approximate duel's chicane (splines sampled from the track in both packages,
compared as built and then installed from the JAX package through
``interop.load_track_splines``) and on a spline track, for random states and inputs made
from a seed with numpy:

* ``fc`` and ``fd``; the contouring and lag errors; the Gauss-Newton quadratic
  ``(Q_e, q_e)``; the linearised boundary ``(G, g)``; the exact cost and boundary rows,
  their gradients and the Hessians of forward-over-reverse AD (the solver's sweep);
  the arc-speed cost;
* a tie of the two boundary offsets (a waypoint of zero width, where both boundary
  points coincide): ``maximum``/``minimum`` split the derivative in halves in both
  frameworks, which shows in the Hessian of the boundary rows.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.func import jacfwd, jacrev, vmap

from dgsqp_tpu.dynamics.model_types import KinematicBicycleConfig as JCfg
from dgsqp_tpu.dynamics.progress_augmented import KinematicBicycleProgressAugmented as JPA
from dgsqp_tpu.harness.scenarios import build_approximate_duel as jax_duel
from dgsqp_tpu.tracks.bspline import BSplineTrack as JSpline
from dgsqp_torch import interop
from dgsqp_torch.dynamics.model_types import KinematicBicycleConfig
from dgsqp_torch.dynamics.progress_augmented import KinematicBicycleProgressAugmented
from dgsqp_torch.harness.scenarios import build_approximate_duel
from dgsqp_torch.tracks.bspline import BSplineTrack

from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-12
QC, QL = 0.1, 1000.0


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _states(model_len, rng, n=24):
    q = np.stack([rng.uniform(-1, 12, n), rng.uniform(-3, 3, n), rng.uniform(0.5, 3, n),
                  rng.uniform(-1, 1, n), rng.uniform(-1, model_len + 1, n)], axis=-1)
    u = np.stack([rng.uniform(-2, 2, n), rng.uniform(-0.4, 0.4, n),
                  rng.uniform(0, 4, n)], axis=-1)
    return q, u


def _chicane_pair(load_splines):
    jm = jax_duel(N=5).joint_model.dynamics_models[0]
    tm = build_approximate_duel(N=5).joint_model.dynamics_models[0]
    if load_splines:
        interop.load_track_splines(tm.splines, jm.splines)
    return jm, tm


def _spline_pair(widths=0.6):
    th = np.linspace(0, 1.5 * np.pi, 60)
    xy = np.stack([4 * np.cos(th) + th, 3 * np.sin(th)], axis=-1)
    cfg = dict(dt=0.1, discretization_method='euler')
    return (JPA(0.0, JCfg(**cfg), track=JSpline(xy, widths, widths)),
            KinematicBicycleProgressAugmented(0.0, KinematicBicycleConfig(**cfg),
                                              track=BSplineTrack(xy, widths, widths)))


@pytest.fixture(scope='module', params=['chicane', 'chicane_loaded', 'spline'])
def pair(request):
    if request.param == 'spline':
        return _spline_pair()
    return _chicane_pair(request.param == 'chicane_loaded')


def _close(b, a, msg=''):
    a = np.asarray(a)
    np.testing.assert_allclose(np.asarray(b), a, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(a).max())), err_msg=msg)


def test_dynamics_and_approximations(pair):
    jm, tm = pair
    rng = np.random.default_rng(0)
    q, u = _states(tm.splines.track_length, rng)
    z = rng.uniform(-1, 1, q.shape[0])
    qj, uj, zj = jnp.asarray(q), jnp.asarray(u), jnp.asarray(z)
    qt, ut, zt = _t(q), _t(u), _t(z)
    _close(tm.fc(qt, ut), jax.vmap(jm.fc)(qj, uj), msg='fc')
    _close(tm.fd(qt, ut), jax.vmap(jm.fd)(qj, uj), msg='fd')

    ec_j, el_j = jax.vmap(jm.contouring_lag_errors)(qj, zj)
    ec_t, el_t = tm.contouring_lag_errors(qt, zt)
    _close(ec_t, ec_j, msg='e_c')
    _close(el_t, el_j, msg='e_l')

    Qe_j, qe_j = jax.vmap(jm.contouring_lag_quad_approx(QC, QL))(qj, zj)
    Qe_t, qe_t = tm.contouring_lag_quad_approx(QC, QL)(qt, zt)
    _close(Qe_t, Qe_j, 'Q_e')
    _close(qe_t, qe_j, 'q_e')

    G_j, g_j = jax.vmap(jm.track_boundary_lin_approx())(qj)
    G_t, g_t = tm.track_boundary_lin_approx()(qt)
    assert G_t.shape == (q.shape[0], 2, 5)
    _close(G_t, G_j, msg='G')
    _close(g_t, g_j, 'g')

    fa_j, fa_t = jm.arcspeed_cost(0.3, 2.0), tm.arcspeed_cost(0.3, 2.0)
    _close(fa_t(ut), jax.vmap(fa_j)(uj), msg='arcspeed')


def test_exact_variants_values_gradients_hessians(pair):
    jm, tm = pair
    rng = np.random.default_rng(1)
    q, _ = _states(tm.splines.track_length, rng, n=12)
    qj, qt = jnp.asarray(q), _t(q)
    fcl_j, fcl_t = jm.contouring_lag_cost_exact(QC, QL), tm.contouring_lag_cost_exact(QC, QL)
    ftb_j, ftb_t = jm.track_boundary_constraint_exact(), tm.track_boundary_constraint_exact()

    _close(fcl_t(qt, 0.0), jax.vmap(lambda x: fcl_j(x, 0.0))(qj), 'cost')
    _close(ftb_t(qt), jax.vmap(ftb_j)(qj), 'boundary rows')
    # the boundary rows are G(q) q + g(q) of the linearisation at q itself
    G_t, g_t = tm.track_boundary_lin_approx()(qt)
    _close(ftb_t(qt), (G_t @ qt[..., None])[..., 0] + g_t, 'G q + g')

    gj = jax.vmap(jax.grad(lambda x: fcl_j(x, 0.0)))(qj)
    gt = vmap(torch.func.grad(lambda x: fcl_t(x, 0.0)))(qt)
    _close(gt, gj, 'cost gradient')
    Hj = jax.vmap(jax.jacfwd(jax.grad(lambda x: fcl_j(x, 0.0))))(qj)
    Ht = vmap(jacfwd(torch.func.grad(lambda x: fcl_t(x, 0.0))))(qt)
    _close(Ht, Hj, 'cost Hessian')
    Jj = jax.vmap(jax.jacrev(ftb_j))(qj)
    Jt = vmap(jacrev(ftb_t))(qt)
    _close(Jt, Jj, 'boundary Jacobian')
    HBj = jax.vmap(jax.jacfwd(jax.jacrev(ftb_j)))(qj)
    HBt = vmap(jacfwd(jacrev(ftb_t)))(qt)
    _close(HBt, HBj, 'boundary Hessian')


def test_boundary_tie_splits_the_derivative_in_halves():
    """At a waypoint of zero width both boundary points equal the centre point, so the
    two offsets of ``g`` tie; their second derivatives in s differ, so the Hessian of the
    boundary rows shows how ``maximum``/``minimum`` split the derivative at the tie.  The
    waypoint is the first (s = 0), where the arc-length wrap leaves s exact."""
    widths = np.full(60, 0.6)
    widths[0] = 0.0
    jm, tm = _spline_pair(widths)
    s_tie = 0.0
    q = np.array([[3.0, 1.0, 2.0, 0.3, s_tie]])
    qj, qt = jnp.asarray(q), _t(q)
    n, d, g = tm._boundary(qt)
    assert float(n) == 0.0 and float(d) == 0.0 and float(g[0, 0]) == float(g[0, 1]) == 0.0
    ftb_j, ftb_t = jm.track_boundary_constraint_exact(), tm.track_boundary_constraint_exact()
    HBj = np.asarray(jax.vmap(jax.jacfwd(jax.jacrev(ftb_j)))(qj))
    HBt = vmap(jacfwd(jacrev(ftb_t)))(qt).numpy()
    _close(HBt, HBj, 'Hessian at the tie')

    # the split is observable: the two offsets' second derivatives in s differ there
    def offsets(s):
        _, xi, yi, xo, yo = tm.splines.frame(s)
        n, d = -(xo - xi), yo - yi
        return torch.stack([n * xi - d * yi, n * xo - d * yo])
    h = jacfwd(jacfwd(offsets))(_t(s_tie))
    assert abs(float(h[0] - h[1])) > 1e-3
