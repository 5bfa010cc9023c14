"""Spline track from xy waypoints, ported from ``dgsqp_tpu/tracks/bspline.py``.

* construction (host, numpy, float64): natural cubic splines x(s), y(s) with arc-length
  reparametrisation by dense quadrature of the chord-parametrised spline's speed, plus
  boundary splines offset along the normal;
* every query is a differentiable, batch-agnostic function of tensors: curvature from
  spline derivatives, tangent from the first derivatives, local<->global in closed form
  from the tangent/normal frame;
* global->local is a fixed-iteration Newton on the first-order optimality of the squared
  distance, seeded from the nearest dense sample.

A spline's interval is found with ``searchsorted(right=True)`` as in the JAX package, so
at a knot the value and the derivatives are those of the interval to the right; the
gradient flows through ``dt = s - knots[idx]`` only.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from dgsqp_torch.tracks.base import TrackAdapters, _at, jnp_mod


def _natural_cubic_coeffs(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Natural cubic spline coefficients: rows [a, b, c, d] per interval,
    y(t) = a + b*dt + c*dt^2 + d*dt^3 with dt = t - x[i]."""
    n = len(x) - 1
    h = np.diff(x)
    # second derivatives (natural: M0 = Mn = 0)
    A = np.zeros((n + 1, n + 1))
    rhs = np.zeros(n + 1)
    A[0, 0] = 1.0
    A[n, n] = 1.0
    for i in range(1, n):
        A[i, i - 1] = h[i - 1]
        A[i, i] = 2 * (h[i - 1] + h[i])
        A[i, i + 1] = h[i]
        rhs[i] = 3 * ((y[i + 1] - y[i]) / h[i] - (y[i] - y[i - 1]) / h[i - 1])
    c = np.linalg.solve(A, rhs)
    a = y[:-1]
    b = (y[1:] - y[:-1]) / h - h * (2 * c[:-1] + c[1:]) / 3
    d = (c[1:] - c[:-1]) / (3 * h)
    return np.stack([a, b, c[:-1], d], axis=1)


def _cached(tables: dict, like, arrays):
    """``arrays`` as tensors in ``like``'s dtype and device, made once per (dtype,
    device) outside every ``torch.func`` transform (a tensor made inside one is wrapped
    at its level and could not be reused after it exits)."""
    key = (like.dtype, like.device)
    if key not in tables:
        with torch._C._DisableFuncTorch():
            tables[key] = tuple(torch.as_tensor(a, dtype=like.dtype, device=like.device)
                                for a in arrays)
    return tables[key]


def _host(fn, s) -> np.ndarray:
    """A spline query at host values, in float64 on the CPU, as numpy."""
    return fn(torch.as_tensor(np.asarray(s, np.float64))).numpy()


class _SplineSet:
    """Cubic splines that share one knot vector, evaluated together with one interval
    search: ``coeffs`` is (n_intervals, S, 4)."""

    def __init__(self, knots: np.ndarray, coeffs: np.ndarray):
        self.knots = np.asarray(knots, np.float64)
        self.coeffs = np.asarray(coeffs, np.float64)
        self._tables = {}

    def locate(self, s):
        """(a, b, c, d) each (..., S) and dt (..., 1) at tensor ``s``."""
        k, c = _cached(self._tables, s, (self.knots, self.coeffs))
        n_int = c.shape[0]
        idx = torch.clamp(torch.searchsorted(k, s, right=True) - 1, 0, n_int - 1)
        dt = (s - _at(k, idx))[..., None]
        cf = c[idx.reshape(-1)].reshape(*idx.shape, *c.shape[1:])
        return cf.unbind(-1), dt

    def value(self, s):
        (a, b, c, d), dt = self.locate(s)
        return a + dt * (b + dt * (c + dt * d))

    def deriv(self, s):
        (_, b, c, d), dt = self.locate(s)
        return b + dt * (2 * c + 3 * d * dt)

    def deriv2(self, s):
        (_, _, c, d), dt = self.locate(s)
        return 2 * c + 6 * d * dt


class _Spline1D:
    """Host-built natural cubic spline evaluated on tensors (value, first and second
    derivative).  ``coeffs`` (n_intervals, 4) may be given instead of ``values``."""

    def __init__(self, knots: np.ndarray, values: Optional[np.ndarray] = None,
                 coeffs: Optional[np.ndarray] = None):
        self.knots = np.asarray(knots, dtype=np.float64)
        if coeffs is None:
            coeffs = _natural_cubic_coeffs(self.knots, np.asarray(values, np.float64))
        self.coeffs = np.asarray(coeffs, np.float64)
        self._set = _SplineSet(self.knots, self.coeffs[:, None, :])

    def __call__(self, s):
        return self._set.value(s)[..., 0]

    def deriv(self, s):
        return self._set.deriv(s)[..., 0]

    def deriv2(self, s):
        return self._set.deriv2(s)[..., 0]


class BSplineTrack(TrackAdapters):
    """Track defined by xy waypoints with per-waypoint left/right widths."""

    def __init__(self, xy_waypoints: np.ndarray, left_width, right_width,
                 slack: float = 2.0, s_waypoints: Optional[np.ndarray] = None,
                 n_quad: int = 2000):
        xy = np.asarray(xy_waypoints, dtype=np.float64)
        left_width = np.broadcast_to(np.asarray(left_width, np.float64), (xy.shape[0],))
        right_width = np.broadcast_to(np.asarray(right_width, np.float64), (xy.shape[0],))
        self.slack = slack

        if s_waypoints is None or len(np.atleast_1d(s_waypoints)) != xy.shape[0]:
            # pass 1: chord-length parametrisation, then arc length by dense quadrature
            chord = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(xy, axis=0),
                                                                    axis=1))])
            sx = _Spline1D(chord, xy[:, 0])
            sy = _Spline1D(chord, xy[:, 1])
            tt = np.linspace(0, chord[-1], n_quad)
            speed = np.hypot(_host(sx.deriv, tt), _host(sy.deriv, tt))
            arclen = np.concatenate([[0.0], np.cumsum(0.5 * (speed[1:] + speed[:-1])
                                                      * np.diff(tt))])
            s_waypoints = np.interp(chord, tt, arclen)
        self.s_waypoints = np.asarray(s_waypoints, np.float64)
        self.track_length = float(self.s_waypoints[-1])

        self.x = _Spline1D(self.s_waypoints, xy[:, 0])
        self.y = _Spline1D(self.s_waypoints, xy[:, 1])
        self.left = _Spline1D(self.s_waypoints, left_width)
        self.right = _Spline1D(self.s_waypoints, right_width)
        self.xy_waypoints = xy
        self.circuit = bool(np.linalg.norm(xy[0] - xy[-1]) < 1e-6)
        self.track_width = float(np.min(left_width) + np.min(right_width))
        self.half_width = self.track_width / 2
        self.phase_out = False

        # dense samples for seeding the projection
        self._s_grid_np = np.linspace(0, self.track_length, 4 * xy.shape[0])
        self._xy_grid_np = np.stack([_host(self.x, self._s_grid_np),
                                     _host(self.y, self._s_grid_np)], axis=-1)
        self._tables = {}

        # boundary splines
        nx, ny = self._normal_np()
        self.xi = _Spline1D(self.s_waypoints, xy[:, 0] + left_width * nx)
        self.yi = _Spline1D(self.s_waypoints, xy[:, 1] + left_width * ny)
        self.xo = _Spline1D(self.s_waypoints, xy[:, 0] - right_width * nx)
        self.yo = _Spline1D(self.s_waypoints, xy[:, 1] - right_width * ny)

    def _normal_np(self):
        dx = _host(self.x.deriv, self.s_waypoints)
        dy = _host(self.y.deriv, self.s_waypoints)
        nrm = np.hypot(dx, dy)
        return -dy / nrm, dx / nrm

    # ---------------------------------------------------------------- queries
    def _s_mod(self, s):
        if self.circuit:
            L = self.track_length
            return jnp_mod(jnp_mod(s, L) + L, L)
        # maximum/minimum (not clamp): at a bound the gradient splits in halves, as
        # jnp.clip's does
        return torch.minimum(torch.maximum(s, torch.zeros_like(s)),
                             torch.full_like(s, self.track_length))

    def curvature(self, s):
        s = self._s_mod(s)
        dx, dy = self.x.deriv(s), self.y.deriv(s)
        ddx, ddy = self.x.deriv2(s), self.y.deriv2(s)
        return (dx * ddy - dy * ddx) / torch.pow(dx * dx + dy * dy, 1.5)

    def tangent_angle(self, s):
        s = self._s_mod(s)
        return torch.atan2(self.y.deriv(s), self.x.deriv(s))

    def left_width(self, s):
        return self.left(self._s_mod(s))

    def right_width(self, s):
        return self.right(self._s_mod(s))

    def local_to_global(self, cl_coord):
        """(s, e_y, e_psi) -> (x, y, psi) over any leading shape."""
        s, ey, epsi = cl_coord[..., 0], cl_coord[..., 1], cl_coord[..., 2]
        s = self._s_mod(s)
        xc, yc = self.x(s), self.y(s)
        psi_t = self.tangent_angle(s)
        x = xc + ey * torch.cos(psi_t + math.pi / 2)
        y = yc + ey * torch.sin(psi_t + math.pi / 2)
        psi = psi_t + epsi
        return torch.stack([x, y, psi], dim=-1)

    def global_to_local(self, xy_coord, newton_iters: int = 10):
        """(x, y, psi) -> (s, e_y, e_psi): Newton on f(s) = (p - c(s)) . c'(s) = 0 from
        the nearest dense sample; e_psi wrapped to (-pi, pi] with ``atan2``."""
        x, y, psi = xy_coord[..., 0], xy_coord[..., 1], xy_coord[..., 2]
        pos = torch.stack([x, y], dim=-1)
        s_grid, xy_grid = _cached(self._tables, xy_coord, (self._s_grid_np, self._xy_grid_np))
        d2 = torch.sum((pos[..., None, :] - xy_grid) ** 2, dim=-1)
        s = _at(s_grid, torch.argmin(d2, dim=-1))
        for _ in range(newton_iters):
            cx, cy = self.x(s), self.y(s)
            dx, dy = self.x.deriv(s), self.y.deriv(s)
            ddx, ddy = self.x.deriv2(s), self.y.deriv2(s)
            rx, ry = x - cx, y - cy
            f = rx * dx + ry * dy
            fp = -(dx * dx + dy * dy) + rx * ddx + ry * ddy
            s = self._s_mod(s - f / torch.where(torch.abs(fp) > 1e-12, fp, -1.0))
        psi_t = self.tangent_angle(s)
        nx, ny = torch.cos(psi_t + math.pi / 2), torch.sin(psi_t + math.pi / 2)
        ey = (x - self.x(s)) * nx + (y - self.y(s)) * ny
        d = psi - psi_t
        epsi = torch.atan2(torch.sin(d), torch.cos(d))
        return torch.stack([s, ey, epsi], dim=-1)

    # ----------------------------------------------------- host-side helpers
    def get_track_segment(self, s_range, resample: Optional[int] = None):
        """A sub-track over [s0, s1]; ``resample`` is a points-per-unit-length
        resolution (``n = resample * (s1 - s0)``)."""
        s0, s1 = s_range
        s0 = max(s0, float(self.s_waypoints[0]))
        s1 = min(s1, float(self.s_waypoints[-1]))
        if resample:
            n = max(8, int(resample * (s1 - s0)))
        else:
            n = max(8, int((s1 - s0) / (self.track_length / len(self.s_waypoints))))
        s = np.linspace(s0, s1, n)
        xy = np.stack([_host(self.x, s), _host(self.y, s)], axis=-1)
        return BSplineTrack(xy, _host(self.left, s), _host(self.right, s), self.slack,
                            s_waypoints=s - s0)

    def get_track_xy(self, pts_per_dist: float = None):
        n = max(2, int(self.track_length * (pts_per_dist or 2000 / self.track_length)))
        s = np.linspace(0, self.track_length - 1e-9, n)
        pts = [np.stack([_host(fx, s), _host(fy, s), np.zeros(n)], axis=-1)
               for fx, fy in ((self.x, self.y), (self.xi, self.yi), (self.xo, self.yo))]
        return tuple(pts)


# the reference's class name
CasadiBSplineTrack = BSplineTrack
