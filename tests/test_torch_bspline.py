"""Port parity for the spline track (``dgsqp_torch/tracks/bspline.py``) on the CPU in
float64: the same inputs, made from a seed with numpy, through ``dgsqp_tpu`` and the
port, within 1e-12 (absolute, on values of order 1-10).

* ``_natural_cubic_coeffs`` (host numpy in both packages): equal;
* ``_Spline1D`` value and first and second derivative at the knots (where the interval
  to the right is taken), at both ends, beyond them and at random points, and the
  derivative of the value in s;
* ``BSplineTrack`` on the circle of ``tests/test_bspline_track.py``: arc-length
  waypoints, curvature, tangent angle, ``local_to_global``, ``global_to_local`` and
  their round trip, left/right widths, the boundary splines, ``get_track_xy`` and a
  resampled ``get_track_segment``; an open track clips s at its ends.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgsqp_tpu.tracks import bspline as jbs
from dgsqp_torch.tracks import bspline as tbs

from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-12


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


@pytest.fixture(scope='module')
def knots_values():
    rng = np.random.default_rng(0)
    knots = np.concatenate([[0.0], np.cumsum(rng.uniform(0.2, 1.0, 30))])
    return knots, np.sin(knots) + 0.1 * rng.normal(size=knots.size)


@pytest.fixture(scope='module')
def circles():
    R = 5.0
    th = np.linspace(0, 2 * np.pi, 200)
    xy = np.stack([R * np.cos(th), R * np.sin(th)], axis=-1)
    return (jbs.BSplineTrack(xy, left_width=0.5, right_width=0.5),
            tbs.BSplineTrack(xy, left_width=0.5, right_width=0.5))


def test_natural_cubic_coeffs_equal(knots_values):
    knots, values = knots_values
    np.testing.assert_array_equal(tbs._natural_cubic_coeffs(knots, values),
                                  jbs._natural_cubic_coeffs(knots, values))


def test_spline_values_and_derivatives(knots_values):
    knots, values = knots_values
    sj, st = jbs._Spline1D(knots, values), tbs._Spline1D(knots, values)
    rng = np.random.default_rng(1)
    s = np.concatenate([knots, [knots[0] - 0.3, knots[-1] + 0.3],
                        rng.uniform(knots[0], knots[-1], 64)])
    for name in ('__call__', 'deriv', 'deriv2'):
        a = np.asarray(getattr(sj, name)(jnp.asarray(s)))
        b = getattr(st, name)(_t(s)).numpy()
        np.testing.assert_allclose(b, a, rtol=0, atol=TOL, err_msg=name)
    # derivative in s through the interval search (only dt = s - knot carries it)
    gj = np.asarray(jax.vmap(jax.grad(lambda x: sj(x)))(jnp.asarray(s)))
    gt = torch.func.vmap(torch.func.grad(lambda x: st(x)))(_t(s)).numpy()
    np.testing.assert_allclose(gt, gj, rtol=0, atol=TOL)


def test_circle_track_queries(circles):
    jt, tt = circles
    assert tt.circuit == jt.circuit and tt.track_length == pytest.approx(jt.track_length,
                                                                          abs=TOL)
    np.testing.assert_allclose(tt.s_waypoints, jt.s_waypoints, rtol=0, atol=TOL)
    rng = np.random.default_rng(2)
    # inside, at both ends and one lap beyond (the circuit wraps s)
    s = np.concatenate([rng.uniform(0, tt.track_length, 40),
                        [0.0, tt.track_length, -1.0, tt.track_length + 2.0]])
    for name in ('curvature', 'tangent_angle', 'left_width', 'right_width'):
        a = np.asarray(getattr(jt, name)(jnp.asarray(s)))
        b = getattr(tt, name)(_t(s)).numpy()
        np.testing.assert_allclose(b, a, rtol=0, atol=TOL, err_msg=name)
    for name in ('xi', 'yi', 'xo', 'yo'):
        np.testing.assert_allclose(getattr(tt, name).coeffs, getattr(jt, name).coeffs,
                                   rtol=0, atol=TOL, err_msg=name)

    cl = np.stack([rng.uniform(0.5, tt.track_length - 0.5, 50), rng.uniform(-0.4, 0.4, 50),
                   rng.uniform(-0.3, 0.3, 50)], axis=-1)
    xyp_j = np.asarray(jt.local_to_global(jnp.asarray(cl)))
    xyp_t = tt.local_to_global(_t(cl)).numpy()
    np.testing.assert_allclose(xyp_t, xyp_j, rtol=0, atol=TOL)
    back_j = np.asarray(jt.global_to_local(jnp.asarray(xyp_j)))
    back_t = tt.global_to_local(_t(xyp_j)).numpy()
    np.testing.assert_allclose(back_t, back_j, rtol=0, atol=TOL)
    # the round trip recovers the Frenet coordinates
    np.testing.assert_allclose(back_t, cl, rtol=0, atol=2e-3)


def test_circle_track_host_adapters(circles):
    jt, tt = circles
    for a, b in zip(jt.get_track_xy(), tt.get_track_xy()):
        np.testing.assert_allclose(b, a, rtol=0, atol=TOL)
    seg_j = jt.get_track_segment((2.0, 9.0), resample=10)
    seg_t = tt.get_track_segment((2.0, 9.0), resample=10)
    assert not seg_t.circuit and seg_t.circuit == seg_j.circuit
    np.testing.assert_allclose(seg_t.s_waypoints, seg_j.s_waypoints, rtol=0, atol=TOL)
    np.testing.assert_allclose(seg_t.xy_waypoints, seg_j.xy_waypoints, rtol=0, atol=TOL)
    # an open track clips s at its ends (beyond them the end values hold)
    s = np.array([-1.0, 0.0, 3.0, seg_t.track_length, seg_t.track_length + 1.0])
    np.testing.assert_allclose(seg_t.tangent_angle(_t(s)).numpy(),
                               np.asarray(seg_j.tangent_angle(jnp.asarray(s))),
                               rtol=0, atol=TOL)
    assert tbs.CasadiBSplineTrack is tbs.BSplineTrack
