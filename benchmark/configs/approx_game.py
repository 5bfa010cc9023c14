"""The approximate (MPCC) racing duel in plain PyTorch: the game's definition, written
apart from the program, and the study's sampler.

The game (the journal comparison study, arXiv:2404.00186): two progress-augmented
kinematic bicycles, q = [x, y, v, psi, s] each, inputs u = [a, steer, u_ds] with a
virtual arc speed u_ds driving the progress s.  The track is the chicane of
``chicane_game``, which the game sees through natural cubic splines of its centre line
and its two edges, sampled at 100 even arc lengths.  Each car pays for its inputs and
their rates, for its contouring and lag errors against the centre line at its own
progress (``1/2 q_c e_c^2 + 1/2 q_l e_l^2`` at every stage and the end), and gains from
its own terminal progress and its lead (``-c0 s_own + c1 (s_other - s_own)``).
Inequalities: the input-rate rows, the two track-edge half-planes at the car's own
progress, the input box (u_ds >= 0), and the shared collision disc from stage 1.

Rows: stage by stage the shared row (from stage 1), then per car its six rate rows, its
two edge rows, its three input upper and three lower bounds; the terminal stage holds
the shared row and each car's two edge rows.  Imports nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch

from chicane_game import ChicaneDuel, chicane_track


def _natural_cubic(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Rows [a, b, c, d] per interval of the natural cubic spline through (x, y):
    y(t) = a + b dt + c dt^2 + d dt^3, dt = t - x[i]."""
    n = len(x) - 1
    h = np.diff(x)
    A = np.zeros((n + 1, n + 1))
    r = np.zeros(n + 1)
    A[0, 0] = A[n, n] = 1.0
    for i in range(1, n):
        A[i, i - 1], A[i, i], A[i, i + 1] = h[i - 1], 2 * (h[i - 1] + h[i]), h[i]
        r[i] = 3 * ((y[i + 1] - y[i]) / h[i] - (y[i] - y[i - 1]) / h[i - 1])
    c = np.linalg.solve(A, r)
    b = (y[1:] - y[:-1]) / h - h * (2 * c[:-1] + c[1:]) / 3
    d = (c[1:] - c[:-1]) / (3 * h)
    return np.stack([y[:-1], b, c[:-1], d], axis=1)


class EdgeSplines:
    """Splines of the centre line and the edges (x, y of each) on one knot vector."""

    def __init__(self, track, n: int = 100):
        S = np.linspace(0, track.length, n)
        self.length = track.length
        t = torch.as_tensor(S, dtype=torch.float64)
        cols = []
        for ey in (0.0, track.half_width, -track.half_width):
            gx, gy = track.local_to_global(t, torch.full_like(t, ey))
            cols += [gx.numpy(), gy.numpy()]
        self.knots = S
        self.coeffs = np.stack([_natural_cubic(S, c) for c in cols], axis=1)  # (n-1, 6, 4)
        self._cache = {}

    def frame(self, s):
        """(tangent angle, x_in, y_in, x_out, y_out) at arc length ``s``."""
        key = (s.dtype, s.device)
        if key not in self._cache:
            with torch._C._DisableFuncTorch():
                self._cache[key] = (torch.as_tensor(self.knots, dtype=s.dtype, device=s.device),
                                    torch.as_tensor(self.coeffs, dtype=s.dtype, device=s.device))
        k, c = self._cache[key]
        L = self.length
        r = torch.fmod(s, L)
        s = torch.where(r < 0, r + L, r)
        r = torch.fmod(s + L, L)
        s = torch.where(r < 0, r + L, r)
        idx = torch.clamp(torch.searchsorted(k, s, right=True) - 1, 0, c.shape[0] - 1)
        dt = (s - k[idx.reshape(-1)].reshape(idx.shape))[..., None]
        a, b, cc, d = c[idx.reshape(-1)].reshape(*idx.shape, *c.shape[1:]).unbind(-1)
        val = a + dt * (b + dt * (cc + dt * d))
        der = b + dt * (2 * cc + 3 * d * dt)
        return (torch.atan2(der[..., 1], der[..., 0]), val[..., 2], val[..., 3],
                val[..., 4], val[..., 5])


class ApproxDuel:
    """The game at the sizes of ``cfg`` (the configuration's ``scenario`` and
    ``vehicle`` objects)."""

    M = 2
    nq_a, nu_a = 5, 3

    def __init__(self, cfg: dict):
        if not cfg['rate_constraints']:
            raise ValueError('the plain game always has its input-rate rows')
        self.cfg = cfg
        self.N = int(cfg['N'])
        self.dt = float(cfg['dt'])
        self.hw = float(cfg['half_width'])
        self.track = chicane_track(float(cfg['theta_deg']), self.hw)
        self.splines = EdgeSplines(self.track, int(cfg['spline_points']))
        self.n_q, self.n_u = self.M * self.nq_a, self.M * self.nu_a
        self.n_dec = self.N * self.n_u
        self.obs_d = 2 * float(cfg['agent_r'])
        self.u_max = (float(cfg['u_a_max']), float(cfg['u_steer_max']), float(cfg['u_ds_max']))
        self.u_min = (-self.u_max[0], -self.u_max[1], 0.0)
        self.rate = (float(cfg['u_a_rate']), float(cfg['u_steer_rate']), float(cfg['u_ds_rate']))
        # the sampler's PID rolls each car's twin in global and Frenet coordinates
        twin = dict(cfg, u_a_rate=self.rate[0], u_steer_rate=self.rate[1],
                    blocking_weight=0.0, obs_weight=0.0, comp_linear=False)
        self.twin = ChicaneDuel(twin)
        z = torch.zeros
        self.n_c = int(self.constraints(z(1, self.N + 1, self.n_q, dtype=torch.float64),
                                        z(1, self.n_dec, dtype=torch.float64),
                                        z(1, self.n_u, dtype=torch.float64)).shape[-1])

    u_stages = ChicaneDuel.u_stages
    stages_to_u = ChicaneDuel.stages_to_u
    own_block = ChicaneDuel.own_block

    def fc(self, q, u):
        c = self.cfg
        x, y, v, psi, s = q.unbind(-1)
        acc, steer, u_ds = u.unbind(-1)
        L_f, L_r = float(c['wheel_dist_front']), float(c['wheel_dist_rear'])
        beta = torch.atan2(torch.tan(steer) * L_r, torch.full_like(steer, L_f + L_r))
        psidot = v / L_r * torch.sin(beta)
        f_ext = -float(c['drag_coefficient']) * v * torch.abs(v) \
            - float(c['slip_coefficient']) * psidot ** 2
        return torch.stack([v * torch.cos(beta + psi), v * torch.sin(beta + psi),
                            acc + f_ext / float(c['mass']), psidot, u_ds], dim=-1)

    step = ChicaneDuel.step
    rollout = ChicaneDuel.rollout

    def _edges(self, qa):
        """Contouring and lag errors against the centre line, and the two edge rows, of
        one car's states at their own progress."""
        t, xi, yi, xo, yo = self.splines.frame(qa[..., 4])
        dx = qa[..., 0] - (xo + 0.5 * (xi - xo))
        dy = qa[..., 1] - (yo + 0.5 * (yi - yo))
        ec = torch.sin(t) * dx - torch.cos(t) * dy
        el = -torch.cos(t) * dx - torch.sin(t) * dy
        n, d = -(xo - xi), yo - yi
        lin = n * qa[..., 0] - d * qa[..., 1]
        g0 = -torch.maximum(n * xi - d * yi, n * xo - d * yo)
        g1 = torch.minimum(n * xi - d * yi, n * xo - d * yo)
        return ec, el, torch.stack([lin + g0, -lin + g1], dim=-1)

    def costs(self, x, u, up):
        c = self.cfg
        w, wr = c['input_weight'], c['input_rate_weight']
        c0, c1 = c['comp_weights']
        qc, ql = float(c['contouring_weight']), float(c['lag_weight'])
        out = []
        for a, ua in enumerate(self.u_stages(u)):
            um = torch.cat([up[:, None, a * self.nu_a:(a + 1) * self.nu_a], ua[:, :-1]], dim=1)
            J = sum(0.5 * w[i] * ua[..., i] ** 2 + 0.5 * wr[i] * (ua[..., i] - um[..., i]) ** 2
                    for i in range(3)).sum(-1)
            ec, el, _ = self._edges(x[:, :, a * self.nq_a:(a + 1) * self.nq_a])
            J = J + (0.5 * qc * ec ** 2 + 0.5 * ql * el ** 2).sum(-1)
            s_own = x[:, self.N, a * self.nq_a + 4]
            s_oth = x[:, self.N, (1 - a) * self.nq_a + 4]
            out.append(J - c0 * s_own + c1 * (s_oth - s_own))
        return torch.stack(out, dim=-1)

    def constraints(self, x, u, up):
        N, dt = self.N, self.dt
        ua = self.u_stages(u)
        um = [torch.cat([up[:, None, a * self.nu_a:(a + 1) * self.nu_a], ua[a][:, :-1]], dim=1)
              for a in range(self.M)]
        edge = [self._edges(x[:, :, a * self.nq_a:(a + 1) * self.nq_a])[2] for a in range(self.M)]
        rows = []

        def shared(k):
            d = x[:, k, 0:2] - x[:, k, self.nq_a:self.nq_a + 2]
            rows.append((self.obs_d ** 2 - (d * d).sum(-1))[:, None])

        for k in range(N):
            if k >= 1:
                shared(k)
            for a in range(self.M):
                d = ua[a][:, k] - um[a][:, k]
                uk = ua[a][:, k]
                rate = []
                for i in range(3):
                    rate += [d[:, i] - dt * self.rate[i], -dt * self.rate[i] - d[:, i]]
                rows.append(torch.stack(rate, dim=-1))
                rows.append(edge[a][:, k])
                rows.append(torch.stack([uk[:, i] - self.u_max[i] for i in range(3)]
                                        + [self.u_min[i] - uk[:, i] for i in range(3)], dim=-1))
        shared(N)
        for a in range(self.M):
            rows.append(edge[a][:, N])
        return torch.cat(rows, dim=-1)

    def sample(self, num: int, rng: np.random.Generator, device, max_rounds: int = 50):
        """The chicane study's draw and PID warm start on the cars' twins, each car's
        inputs extended by its arc speed (s_{k+1} - s_k) / dt, its state mapped to
        [x, y, v, psi = e_psi + tangent(s), s], and the previous input's arc-speed
        channel seeded from the first stage."""
        x0_t, u_t, _, q_t = self.twin.sample(num, rng, device, max_rounds, trajectories=True)
        xs, us = [], []
        for a in range(self.M):
            q0 = x0_t[:, 6 * a:6 * (a + 1)]
            s_seq = q_t[:, :, 6 * a + 4]
            ds = (s_seq[:, 1:] - s_seq[:, :-1]) / self.dt
            us.append(torch.cat([u_t[:, :, 2 * a:2 * (a + 1)], ds[..., None]], dim=-1))
            psi = q0[:, 3] + self.track.tangent_angle(q0[:, 4])
            xs.append(torch.stack([q0[:, 0], q0[:, 1], q0[:, 2], psi, q0[:, 4]], dim=-1))
        u_ws = torch.cat(us, dim=-1)
        up = torch.zeros(num, self.n_u, dtype=torch.float64, device=device)
        up[:, 2], up[:, 5] = u_ws[:, 0, 2], u_ws[:, 0, 5]
        return torch.cat(xs, dim=-1), u_ws, up


def build(cfg: dict) -> ApproxDuel:
    return ApproxDuel(cfg)
