"""Progress-augmented (MPCC) vehicle models and their approximations, ported from
``dgsqp_tpu/dynamics/progress_augmented.py``.

A global-frame vehicle carries a decoupled arc-length progress state driven by a
virtual arc-speed input ``u_ds``.  The approximate game replaces the exact Frenet
quantities by a quadratic contouring/lag cost and two linearised track-boundary
half-planes, evaluated at an iterate's trajectory, or (the ``_exact`` variants)
differentiates through the track splines themselves.

Every function takes states of shape (..., n_q) with any leading batch shape.  The six
track splines (centre line, inner and outer boundary, x and y each) share one knot
vector, so one interval search serves all of them (``TrackSplines.frame``).  (The JAX
package wraps s a second time inside its tangent; re-wrapping an s already in [0, L)
can move it by an ulp of L, far inside every tolerance of the parity tests.)
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import jvp, vmap

from dgsqp_torch.dynamics.model_types import DynamicBicycleConfig, KinematicBicycleConfig
from dgsqp_torch.dynamics.models import _DynamicBicycleBase, _KinematicBicycleBase
from dgsqp_torch.tracks.base import jnp_mod
from dgsqp_torch.tracks.bspline import BSplineTrack, _Spline1D, _SplineSet

SPLINE_NAMES = ('x', 'y', 'xi', 'yi', 'xo', 'yo')


def _jac_fwd(f, q):
    """Jacobian of an elementwise-batched ``f``: q (..., n) -> f (..., m) gives
    (..., m, n), one forward push per basis vector seeded in every batch element."""
    basis = torch.eye(q.shape[-1], dtype=q.dtype, device=q.device)
    cols = vmap(lambda e: jvp(f, (q,), (e.expand_as(q),))[1])(basis)
    return cols.movedim(0, -1)


class TrackSplines:
    """Centre-line and boundary splines x(s), y(s), xi, yi, xo, yo with derivatives.

    From a ``BSplineTrack`` its own splines are shared; from any other track the centre
    line and the boundaries at ``half_width - track_tightening`` are sampled at ``n``
    evenly spaced arc lengths (in float64 on the host) and interpolated.
    """

    def __init__(self, track, track_tightening: float = 0.0, n: int = 100):
        if isinstance(track, BSplineTrack):
            splines = {name: getattr(track, name) for name in SPLINE_NAMES}
        else:
            S = np.linspace(0, track.track_length, n)
            w = track.half_width - track_tightening
            zeros = np.zeros(n)

            def sample(ey):
                cl = torch.as_tensor(np.stack([S, ey, zeros], -1), dtype=torch.float64)
                return track.local_to_global(cl).numpy()
            center, inner, outer = sample(zeros), sample(np.full(n, w)), sample(np.full(n, -w))
            splines = {'x': _Spline1D(S, center[:, 0]), 'y': _Spline1D(S, center[:, 1]),
                       'xi': _Spline1D(S, inner[:, 0]), 'yi': _Spline1D(S, inner[:, 1]),
                       'xo': _Spline1D(S, outer[:, 0]), 'yo': _Spline1D(S, outer[:, 1])}
        self.track_length = track.track_length
        self.set_splines(splines)

    def set_splines(self, splines: dict):
        """Install the six splines (a dict by name) and their shared evaluation table."""
        for name in SPLINE_NAMES:
            setattr(self, name, splines[name])
        knots = self.x.knots
        if not all(np.array_equal(splines[k].knots, knots) for k in SPLINE_NAMES):
            raise ValueError('track splines must share one knot vector')
        self._set = _SplineSet(knots, np.stack([splines[k].coeffs for k in SPLINE_NAMES],
                                               axis=1))

    def s_mod(self, s):
        L = self.track_length
        return jnp_mod(jnp_mod(s, L) + L, L)

    def tangent(self, s):
        s = self.s_mod(s)
        return torch.atan2(self.y.deriv(s), self.x.deriv(s))

    def frame(self, s):
        """(tangent angle, xi, yi, xo, yo) at an arc length ``s`` already in [0, L),
        from one interval search (each value by the same formula as its own spline)."""
        (a, b, c, d), dt = self._set.locate(s)
        val = a + dt * (b + dt * (c + dt * d))
        der = b + dt * (2 * c + 3 * d * dt)
        return (torch.atan2(der[..., 1], der[..., 0]),
                val[..., 2], val[..., 3], val[..., 4], val[..., 5])


class _ProgressAugmentedMixin:
    """Approximation machinery shared by progress-augmented models: global (x, y) at
    ``pos_idx``, progress s last in the state, u_ds last in the input."""

    pos_idx = (0, 1)

    def _init_splines(self, track_tightening: float):
        self.splines = TrackSplines(self.track, track_tightening)

    def contouring_lag_errors(self, q, z):
        """(e_contour, e_lag) of the position against the reference point that ``z`` in
        [-1, 1] interpolates between the outer and inner boundary."""
        sp = self.splines
        t, xi, yi, xo, yo = sp.frame(sp.s_mod(q[..., -1]))
        x_int = xo + (z + 1) / 2 * (xi - xo)
        y_int = yo + (z + 1) / 2 * (yi - yo)
        dx = q[..., self.pos_idx[0]] - x_int
        dy = q[..., self.pos_idx[1]] - y_int
        ec = torch.sin(t) * dx - torch.cos(t) * dy
        el = -torch.cos(t) * dx - torch.sin(t) * dy
        return ec, el

    def contouring_lag_quad_approx(self, contouring_cost: float, lag_cost: float):
        """Returns f(q_bar, z) -> (Q_e (..., n_q, n_q), q_e (..., n_q)): the Gauss-Newton
        approximation ``1/2 q'Q_e q + q_e'q`` of the contouring/lag cost at q_bar."""
        w = (contouring_cost, lag_cost)

        def f(q_bar, z):
            def e_fn(qq):
                return torch.stack(self.contouring_lag_errors(qq, z), dim=-1)
            e = e_fn(q_bar)
            D = _jac_fwd(e_fn, q_bar)
            P_cl = torch.diag(torch.tensor(w, dtype=q_bar.dtype, device=q_bar.device))
            DtP = D.transpose(-1, -2) @ P_cl
            Q_e = DtP @ D
            q_e = (DtP @ e[..., None])[..., 0] - (Q_e @ q_bar[..., None])[..., 0]
            return Q_e, q_e
        return f

    def _boundary(self, q):
        """(n, d, g): the half-plane normal pieces and offsets between the boundary
        points at s(q)."""
        sp = self.splines
        _, xi, yi, xo, yo = sp.frame(sp.s_mod(q[..., -1]))
        n = -(xo - xi)
        d = yo - yi
        g = torch.stack([-torch.maximum(n * xi - d * yi, n * xo - d * yo),
                         torch.minimum(n * xi - d * yi, n * xo - d * yo)], dim=-1)
        return n, d, g

    def track_boundary_lin_approx(self):
        """Returns f(q_bar) -> (G (..., 2, n_q), g (..., 2)) with the half-planes
        ``G q + g <= 0`` between the boundary points at s(q_bar); G is built by
        stacking its columns."""
        px, py = self.pos_idx

        def f(q_bar):
            n, d, g = self._boundary(q_bar)
            zero = torch.zeros_like(n)
            rows = []
            for sx, sy in ((n, -d), (-n, d)):
                cols = [zero] * self.n_q
                cols[px], cols[py] = sx, sy
                rows.append(torch.stack(cols, dim=-1))
            return torch.stack(rows, dim=-2), g
        return f

    def contouring_lag_cost_exact(self, contouring_cost: float, lag_cost: float):
        """The exact penalty ``1/2 q_c e_c(q)^2 + 1/2 q_l e_l(q)^2``, differentiable
        through the track geometry."""
        def f(q, z):
            ec, el = self.contouring_lag_errors(q, z)
            return 0.5 * contouring_cost * ec ** 2 + 0.5 * lag_cost * el ** 2
        return f

    def track_boundary_constraint_exact(self):
        """The boundary half-planes ``G(q) q + g(q)`` at the state's own arc position,
        differentiable through s: (..., 2)."""
        px, py = self.pos_idx

        def f(q):
            n, d, g = self._boundary(q)
            lin = n * q[..., px] + (-d) * q[..., py]
            return torch.stack([lin, -lin], dim=-1) + g
        return f

    def arcspeed_cost(self, magnitude_weight: float, performance_weight: float):
        """u_ds magnitude/progress cost."""
        def f(u):
            return 0.5 * magnitude_weight * u[..., -1] ** 2 - performance_weight * u[..., -1]
        return f


class KinematicBicycleProgressAugmented(_KinematicBicycleBase, _ProgressAugmentedMixin):
    """q = [x, y, v, psi, s], u = [a, steer, u_ds]."""

    n_q, n_u = 5, 3

    def __init__(self, t0, config: KinematicBicycleConfig = None, track=None,
                 track_tightening: float = 0.0):
        super().__init__(t0, config or KinematicBicycleConfig(), track)
        self._init_splines(track_tightening)

    def fc(self, q, u):
        x, y, v, psi, s = q.unbind(-1)
        u_a, u_s, u_ds = u.unbind(-1)
        beta = self.beta(u_s)
        psidot = v / self.L_r * torch.sin(beta)
        dv = u_a + self.f_ext(v, psidot) / self.m
        return torch.stack([v * torch.cos(beta + psi), v * torch.sin(beta + psi),
                            dv, psidot, u_ds], dim=-1)

    def state2qu(self, state):
        return (np.array([state.x.x, state.x.y, state.v.v_long, state.e.psi, state.p.s]),
                np.array([state.u.u_a, state.u.u_steer, state.u.u_ds]))

    def qu2state(self, state, q=None, u=None):
        if q is not None:
            state.x.x, state.x.y = float(q[0]), float(q[1])
            state.v.v_long, state.e.psi, state.p.s = float(q[2]), float(q[3]), float(q[4])
        if u is not None:
            state.u.u_a, state.u.u_steer, state.u.u_ds = float(u[0]), float(u[1]), float(u[2])

    def _pred_q_fields(self):
        return [('x', 0), ('y', 1), ('v_long', 2), ('psi', 3), ('s', 4)]


class DynamicBicycleProgressAugmented(_DynamicBicycleBase, _ProgressAugmentedMixin):
    """q = [vx, vy, psidot, x, y, psi, s], u = [a, steer, u_ds]."""

    n_q, n_u = 7, 3
    pos_idx = (3, 4)

    def __init__(self, t0, config: DynamicBicycleConfig = None, track=None,
                 track_tightening: float = 0.0):
        super().__init__(t0, config or DynamicBicycleConfig(), track)
        self._init_splines(track_tightening)

    def fc(self, q, u):
        vx, vy, psidot, x, y, psi, s = q.unbind(-1)
        u_a, u_s, u_ds = u.unbind(-1)
        ax, ay, alphaz = self.body_accels(vx, vy, psidot, u_a, u_s)
        cp, sp = torch.cos(psi), torch.sin(psi)
        return torch.stack([ax + psidot * vy,
                            ay - psidot * vx,
                            alphaz,
                            vx * cp - vy * sp,
                            vy * cp + vx * sp,
                            psidot,
                            u_ds], dim=-1)

    def state2qu(self, state):
        return (np.array([state.v.v_long, state.v.v_tran, state.w.w_psi,
                          state.x.x, state.x.y, state.e.psi, state.p.s]),
                np.array([state.u.u_a, state.u.u_steer, state.u.u_ds]))

    def qu2state(self, state, q=None, u=None):
        if q is not None:
            state.v.v_long, state.v.v_tran, state.w.w_psi = float(q[0]), float(q[1]), float(q[2])
            state.x.x, state.x.y, state.e.psi, state.p.s = \
                float(q[3]), float(q[4]), float(q[5]), float(q[6])
        if u is not None:
            state.u.u_a, state.u.u_steer, state.u.u_ds = float(u[0]), float(u[1]), float(u[2])

    def _pred_q_fields(self):
        return [('v_long', 0), ('v_tran', 1), ('psidot', 2), ('x', 3), ('y', 4),
                ('psi', 5), ('s', 6)]
