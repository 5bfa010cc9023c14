"""Race-track geometry on tensors, ported from ``dgsqp_tpu/tracks/base.py``.

A track is piecewise straight/constant-curvature segments.  The geometry is
precomputed at construction into a numpy key-point table
``key_pts[i] = [x, y, psi, cumulative length, segment length, signed curvature]``
(row i is the key point at the END of segment i; row 0 is the start pose), and every
query is a differentiable, batch-agnostic function of that table: it takes tensors of
any shape on any device and returns results in the query's dtype and device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from dgsqp_torch.utils.math import wrap_angle


def jnp_mod(x, L: float):
    """Floating remainder for a positive divisor, computed as ``jnp.mod`` does
    (truncated ``fmod``, then ``+ L`` where negative), so values and derivatives match."""
    r = torch.fmod(x, L)
    return torch.where(r < 0, r + L, r)


def _at(v, i):
    """``v[i]`` for an integer tensor ``i`` of any shape, 0-d included (a 0-d index
    would otherwise be read on the host, which ``vmap`` forbids)."""
    return v[i.reshape(-1)].reshape(i.shape)


def interp(x, xp, fp):
    """Piecewise-linear interpolation, the same formula as ``jnp.interp``.

    The segment is picked with ``searchsorted(side='right')``, so at a breakpoint the
    value and the derivative in ``x`` are those of the segment to the right, exactly as
    in JAX; outside ``[xp[0], xp[-1]]`` the end values are held constant.
    """
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n - 1)
    fp_i, fp_im = _at(fp, i), _at(fp, i - 1)
    xp_im = _at(xp, i - 1)
    df = fp_i - fp_im
    dx = _at(xp, i) - xp_im
    delta = x - xp_im
    epsilon = float(np.spacing(torch.finfo(xp.dtype).eps))
    dx0 = torch.abs(dx) <= epsilon
    f = torch.where(dx0, fp_im, fp_im + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _compute_angle(p0, p1, p2):
    """Signed angle between vectors (p1-p0) and (p2-p0); points are (..., 2)."""
    v1 = p1 - p0
    v2 = p2 - p0
    dot = (v1 * v2).sum(-1)
    det = v1[..., 0] * v2[..., 1] - v1[..., 1] * v2[..., 0]
    return torch.atan2(det, dot)


class TrackAdapters:
    """The host-side adapters both track kinds share: a ``VehicleState``'s frame
    converted in place (float64 on the CPU, as the JAX package computes them in x64),
    and the centerline and boundaries drawn on a matplotlib axis."""

    def local_to_global_typed(self, state) -> int:
        xyp = self.local_to_global(torch.tensor([state.p.s, state.p.x_tran, state.p.e_psi],
                                                dtype=torch.float64)).numpy()
        state.x.x, state.x.y, state.e.psi = float(xyp[0]), float(xyp[1]), float(xyp[2])
        return 0

    def global_to_local_typed(self, state) -> int:
        sey = self.global_to_local(torch.tensor([state.x.x, state.x.y, state.e.psi],
                                                dtype=torch.float64)).numpy()
        state.p.s, state.p.x_tran, state.p.e_psi = float(sey[0]), float(sey[1]), float(sey[2])
        return 0

    def plot_map(self, ax, pts_per_dist: float = None):
        center, inner, outer = self.get_track_xy(pts_per_dist)
        ax.plot(center[:, 0], center[:, 1], 'k--', linewidth=0.8)
        ax.plot(inner[:, 0], inner[:, 1], 'k-', linewidth=1.0)
        ax.plot(outer[:, 0], outer[:, 1], 'k-', linewidth=1.0)
        ax.set_aspect('equal')
        return ax


class RadiusArclengthTrack(TrackAdapters):
    """Piecewise straight/arc track defined by ``cl_segs = [[length, radius], ...]``.

    ``radius == 0`` denotes a straight segment; otherwise the signed radius of the arc.
    """

    def __init__(self, track_width=None, slack=None, cl_segs=None):
        self.track_width = track_width
        self.slack = slack
        self.cl_segs = np.asarray(cl_segs, dtype=np.float64) if cl_segs is not None else None
        self.n_segs = None
        self.key_pts = None
        self.track_length = None
        self.half_width = None
        self.circuit = False
        self.phase_out = False
        self._tables = {}

    # ------------------------------------------------------------------ setup
    def initialize(self, track_width=None, slack=None, cl_segs=None, init_pos=(0.0, 0.0, 0.0)):
        if track_width is not None:
            self.track_width = track_width
        if slack is not None:
            self.slack = slack
        if cl_segs is not None:
            self.cl_segs = np.asarray(cl_segs, dtype=np.float64)

        self.half_width = self.track_width / 2
        self.n_segs = self.cl_segs.shape[0]
        self.key_pts = self._compute_key_pts(self.cl_segs, init_pos)
        self.track_length = float(self.key_pts[-1, 3])

        if np.isclose(self.key_pts[0, 0], self.key_pts[-1, 0]) and \
           np.isclose(self.key_pts[0, 1], self.key_pts[-1, 1]):
            self.circuit = True

        # cumulative (unwrapped) tangent angle at each key point
        seg_l = self.key_pts[:, 4]
        seg_c = self.key_pts[:, 5]
        self.cum_angle = np.concatenate([[0.0], np.cumsum(seg_l * seg_c)])[1:]
        self._tables = {}
        return self

    def set_tables(self, key_pts, cum_angle):
        """Install a key-point table and cumulative-angle table computed elsewhere
        (``dgsqp_torch.interop``), so both packages query bit-identical geometry."""
        self.key_pts = np.array(key_pts, dtype=np.float64)
        self.cum_angle = np.array(cum_angle, dtype=np.float64)
        self.track_length = float(self.key_pts[-1, 3])
        self._tables = {}

    def remove_phase_out(self):
        """Drop the straight that ``phase_out=True`` appended to the track."""
        if self.phase_out:
            self.cl_segs = self.cl_segs[:-1]
            self.phase_out = False
            self.initialize()

    @staticmethod
    def _compute_key_pts(cl_segs: np.ndarray, init_pos) -> np.ndarray:
        def np_wrap(t):
            return t + 2 * np.pi if t < -np.pi else (t - 2 * np.pi if t > np.pi else t)

        n_segs = cl_segs.shape[0]
        kp = np.zeros((n_segs + 1, 6))
        kp[0, 0:3] = init_pos
        for i in range(1, n_segs + 1):
            x0, y0, psi0, cum0 = kp[i - 1, 0], kp[i - 1, 1], kp[i - 1, 2], kp[i - 1, 3]
            l, r = cl_segs[i - 1]
            if r == 0:
                psi = psi0
                x = x0 + l * np.cos(psi0)
                y = y0 + l * np.sin(psi0)
                curv = 0.0
            else:
                xc = x0 - r * np.sin(psi0)
                yc = y0 + r * np.cos(psi0)
                theta = l / r
                x = xc + r * np.sin(psi0 + theta)
                y = yc - r * np.cos(psi0 + theta)
                curv = 1.0 / r
                psi = np_wrap(psi0 + theta)
            kp[i] = [x, y, psi, cum0 + l, l, curv]
        return kp

    # ---------------------------------------------------------------- queries
    def _tables_for(self, x):
        """(key points, cumulative angle) in the query tensor's dtype and device."""
        key = (x.dtype, x.device)
        if key not in self._tables:
            # the first query may come from inside a torch.func transform, where a new
            # tensor would be wrapped at that transform's level and could not be reused
            # once it exits: create the cached tables outside every transform
            with torch._C._DisableFuncTorch():
                self._tables[key] = (
                    torch.as_tensor(self.key_pts, dtype=x.dtype, device=x.device),
                    torch.as_tensor(self.cum_angle, dtype=x.dtype, device=x.device))
        return self._tables[key]

    def _s_mod(self, s):
        L = self.track_length
        return jnp_mod(jnp_mod(s, L) + L, L)

    def curvature(self, s):
        """Signed curvature at arc length s (piecewise constant per segment); the value
        of segment i applies on ``[bp[i-1], bp[i])`` (``searchsorted`` side right)."""
        s_bar = self._s_mod(s)
        kp, _ = self._tables_for(s)
        bp = kp[1:-1, 3].contiguous()
        idx = torch.searchsorted(bp, s_bar, right=True)
        return _at(kp[:, 5], 1 + idx)

    def tangent_angle(self, s):
        """Track tangent angle at arc length s (piecewise linear in s; unwrapped)."""
        s_bar = self._s_mod(s)
        kp, cum = self._tables_for(s)
        return interp(s_bar, kp[:, 3].contiguous(), cum)

    def left_width(self, s):
        return torch.full_like(s, self.half_width)

    def right_width(self, s):
        return torch.full_like(s, self.half_width)

    def local_to_global(self, cl_coord):
        """(s, e_y, e_psi) -> (x, y, psi), analytic, over any leading shape."""
        s, e_y, e_psi = cl_coord[..., 0], cl_coord[..., 1], cl_coord[..., 2]
        s = self._s_mod(s)

        kp, _ = self._tables_for(s)
        cum_l = kp[:, 3].contiguous()
        idx = torch.clamp(torch.searchsorted(cum_l, s, right=True) - 1, 0, self.n_segs - 1)

        x_s, y_s, psi_s = _at(kp[:, 0], idx), _at(kp[:, 1], idx), _at(kp[:, 2], idx)
        x_f, y_f, psi_f = _at(kp[:, 0], idx + 1), _at(kp[:, 1], idx + 1), _at(kp[:, 2], idx + 1)
        curve_f = _at(kp[:, 5], idx + 1)
        l = _at(kp[:, 4], idx + 1)
        d = s - _at(kp[:, 3], idx)

        straight = curve_f == 0
        half_pi = math.pi / 2

        xs = x_s + (x_f - x_s) * d / l + e_y * torch.cos(psi_f + half_pi)
        ys = y_s + (y_f - y_s) * d / l + e_y * torch.sin(psi_f + half_pi)
        psis = wrap_angle(psi_f + e_psi)

        r = 1.0 / torch.where(straight, 1.0, curve_f)
        sgn = torch.where(r >= 0, 1.0, -1.0).to(r.dtype)
        x_c = x_s + torch.abs(r) * torch.cos(psi_s + sgn * half_pi)
        y_c = y_s + torch.abs(r) * torch.sin(psi_s + sgn * half_pi)
        span = d / torch.abs(r)
        psi_d = wrap_angle(psi_s + sgn * span)
        ang_norm = wrap_angle(psi_s + sgn * half_pi)
        sgn_an = torch.where(ang_norm >= 0, 1.0, -1.0).to(r.dtype)
        ang = -sgn_an * (math.pi - torch.abs(ang_norm))
        xc = x_c + (torch.abs(r) - sgn * e_y) * torch.cos(ang + sgn * span)
        yc = y_c + (torch.abs(r) - sgn * e_y) * torch.sin(ang + sgn * span)
        psic = wrap_angle(psi_d + e_psi)

        x = torch.where(straight, xs, xc)
        y = torch.where(straight, ys, yc)
        psi = torch.where(straight, psis, psic)
        return torch.stack([x, y, psi], dim=-1)

    def global_to_local(self, xy_coord):
        """(x, y, psi) -> (s, e_y, e_psi): every segment's candidate projection is
        computed in parallel and the first valid one is selected."""
        x, y = xy_coord[..., 0], xy_coord[..., 1]
        psi = xy_coord[..., 2][..., None]
        pos = torch.stack([x, y], dim=-1)[..., None, :]

        kp, _ = self._tables_for(xy_coord)
        pos_s = kp[:-1, 0:2]
        pos_f = kp[1:, 0:2]
        psi_s = kp[:-1, 2]
        curve_f = kp[1:, 5]
        seg_l = kp[1:, 4]
        cum_s = kp[:-1, 3]
        wmax = self.half_width + self.slack
        half_pi = math.pi / 2

        straight = curve_f == 0

        ang1 = _compute_angle(pos_s, pos, pos_f)
        ang2 = _compute_angle(pos_f, pos, pos_s)
        v = pos - pos_s
        vn = torch.linalg.norm(v, dim=-1)
        ang = _compute_angle(pos_s, pos_f, pos)
        ey_st = vn * torch.sin(ang)
        d_st = vn * torch.cos(ang)
        s_st = cum_s + d_st
        epsi_st = wrap_angle(psi - psi_s)
        ok_st = (torch.abs(ang1) <= half_pi) & (torch.abs(ang2) <= half_pi) & \
                (torch.abs(ey_st) <= wmax)

        r = 1.0 / torch.where(straight, 1.0, curve_f)
        sgn = torch.where(r >= 0, 1.0, -1.0).to(r.dtype)
        x_c = pos_s[:, 0] + torch.abs(r) * torch.cos(psi_s + sgn * half_pi)
        y_c = pos_s[:, 1] + torch.abs(r) * torch.sin(psi_s + sgn * half_pi)
        center = torch.stack([x_c, y_c], dim=-1)
        span_ang = seg_l / r
        cur_ang = _compute_angle(center, pos_s, pos)
        vc = pos - center
        vcn = torch.linalg.norm(vc, dim=-1)
        ey_cv = -sgn * (vcn - torch.abs(r))
        s_cv = cum_s + torch.abs(cur_ang) * torch.abs(r)
        epsi_cv = wrap_angle(psi - (psi_s + cur_ang))
        ok_cv = (torch.sign(span_ang) == torch.sign(cur_ang)) & \
                (torch.abs(span_ang) >= torch.abs(cur_ang)) & \
                (torch.abs(ey_cv) <= wmax)

        valid = torch.where(straight, ok_st, ok_cv)
        s_cand = torch.where(straight, s_st, s_cv)
        ey_cand = torch.where(straight, ey_st, ey_cv)
        epsi_cand = torch.where(straight, epsi_st, epsi_cv)

        # first valid segment wins (argmax returns the first maximal index)
        first = torch.argmax(valid.to(torch.int8), dim=-1, keepdim=True)
        s_out = torch.take_along_dim(s_cand, first, dim=-1)[..., 0]
        ey_out = torch.take_along_dim(ey_cand, first, dim=-1)[..., 0]
        epsi_out = torch.take_along_dim(epsi_cand, first, dim=-1)[..., 0]
        return torch.stack([s_out, ey_out, epsi_out], dim=-1)

    def get_track_xy(self, pts_per_dist: float = None):
        """Centerline and boundaries (n, 3) sampled for plotting (host numpy)."""
        if pts_per_dist is None:
            pts_per_dist = 2000 / self.track_length
        n = max(2, int(self.track_length * pts_per_dist))
        s = np.linspace(0, self.track_length - 1e-9, n)
        return tuple(self.local_to_global(torch.as_tensor(
            np.stack([s, np.full(n, ey), np.zeros(n)], -1))).numpy()
            for ey in (0.0, self.half_width, -self.half_width))
