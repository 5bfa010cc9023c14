"""The two-car chicane duel in plain PyTorch: the game's definition, written apart from
the program, and the study's initial-condition sampler with its PID warm start.

The game (ICRA-23 chicane study, arXiv:2203.16478): two kinematic bicycles in global and
Frenet coordinates, q = [x, y, v, e_psi, s, e_y] each, inputs u = [a, steer], explicit
Euler steps of dt on a chicane of straights and arcs.  Each car pays for its inputs and
their rates and gains from its own terminal progress and from leading the other
(``-c0 s_own + c1 atan(s_other - s_own)``).  Inequalities: input-rate rows, a shared
collision disc from stage 1, input boxes and the lateral track bound.

Rows of the constraint vector follow the order the game's KKT system uses: stage by
stage, the shared rows first, then per car its rate rows, input upper and lower bounds
and (from stage 1) its lateral upper and lower bounds; the terminal stage holds the
shared row and the cars' lateral bounds.  The decision vector stacks each car's inputs
stage-major, car by car.

Everything here takes a leading batch dimension and works in the tensors' own dtype
and device; it imports nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch


# ------------------------------------------------------------------------ the track
def _wrap(theta):
    return torch.where(theta < -math.pi, theta + 2 * math.pi,
                       torch.where(theta > math.pi, theta - 2 * math.pi, theta))


def _fmod_pos(x, L):
    r = torch.fmod(x, L)
    return torch.where(r < 0, r + L, r)


def _take(v, i):
    return v[i.reshape(-1)].reshape(i.shape)


class ArcTrack:
    """Straights and constant-curvature arcs from ``segs = [[length, radius], ...]``
    (radius 0: straight), starting at the origin heading along +x."""

    def __init__(self, segs, half_width: float):
        segs = np.asarray(segs, dtype=np.float64)
        self.half_width = half_width
        kp = np.zeros((len(segs) + 1, 6))      # x, y, psi, cumulative s, length, curvature
        for i, (length, r) in enumerate(segs, start=1):
            x0, y0, psi0, s0 = kp[i - 1, :4]
            if r == 0:
                x, y, psi, curv = x0 + length * np.cos(psi0), y0 + length * np.sin(psi0), psi0, 0.0
            else:
                xc, yc = x0 - r * np.sin(psi0), y0 + r * np.cos(psi0)
                th = length / r
                x, y = xc + r * np.sin(psi0 + th), yc - r * np.cos(psi0 + th)
                psi = psi0 + th
                psi = psi + 2 * np.pi if psi < -np.pi else (psi - 2 * np.pi if psi > np.pi else psi)
                curv = 1.0 / r
            kp[i] = [x, y, psi, s0 + length, length, curv]
        self.key_pts = kp
        self.n_segs = len(segs)
        self.length = float(kp[-1, 3])
        self.cum_angle = np.cumsum(kp[:, 4] * kp[:, 5])
        self._cache = {}

    def _tables(self, s):
        key = (s.dtype, s.device)
        if key not in self._cache:
            with torch._C._DisableFuncTorch():
                self._cache[key] = (torch.as_tensor(self.key_pts, dtype=s.dtype, device=s.device),
                                    torch.as_tensor(self.cum_angle, dtype=s.dtype, device=s.device))
        return self._cache[key]

    def _s_mod(self, s):
        return _fmod_pos(_fmod_pos(s, self.length) + self.length, self.length)

    def curvature(self, s):
        kp, _ = self._tables(s)
        idx = torch.searchsorted(kp[1:-1, 3].contiguous(), self._s_mod(s), right=True)
        return _take(kp[:, 5], 1 + idx)

    def tangent_angle(self, s):
        """Piecewise linear in s: the cumulative heading, interpolated between key
        points (the segment to the right at a key point), held at the ends."""
        kp, cum = self._tables(s)
        xp = kp[:, 3].contiguous()
        x = self._s_mod(s)
        n = xp.shape[0]
        i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n - 1)
        f0, f1 = _take(cum, i - 1), _take(cum, i)
        x0, x1 = _take(xp, i - 1), _take(xp, i)
        f = f0 + (x - x0) / (x1 - x0) * (f1 - f0)
        f = torch.where(x < xp[0], cum[0], f)
        return torch.where(x > xp[-1], cum[-1], f)

    def local_to_global(self, s, e_y):
        """(s, e_y) on the track -> (x, y)."""
        s = self._s_mod(s)
        kp, _ = self._tables(s)
        idx = torch.clamp(torch.searchsorted(kp[:, 3].contiguous(), s, right=True) - 1,
                          0, self.n_segs - 1)
        xs, ys, ps = _take(kp[:, 0], idx), _take(kp[:, 1], idx), _take(kp[:, 2], idx)
        xf, yf, pf = _take(kp[:, 0], idx + 1), _take(kp[:, 1], idx + 1), _take(kp[:, 2], idx + 1)
        curv = _take(kp[:, 5], idx + 1)
        length = _take(kp[:, 4], idx + 1)
        d = s - _take(kp[:, 3], idx)
        straight = curv == 0
        hp = math.pi / 2
        x_st = xs + (xf - xs) * d / length + e_y * torch.cos(pf + hp)
        y_st = ys + (yf - ys) * d / length + e_y * torch.sin(pf + hp)
        r = 1.0 / torch.where(straight, 1.0, curv)
        sg = torch.where(r >= 0, 1.0, -1.0).to(r.dtype)
        xc = xs + torch.abs(r) * torch.cos(ps + sg * hp)
        yc = ys + torch.abs(r) * torch.sin(ps + sg * hp)
        span = d / torch.abs(r)
        an = _wrap(ps + sg * hp)
        ang = -torch.where(an >= 0, 1.0, -1.0).to(r.dtype) * (math.pi - torch.abs(an))
        x_arc = xc + (torch.abs(r) - sg * e_y) * torch.cos(ang + sg * span)
        y_arc = yc + (torch.abs(r) - sg * e_y) * torch.sin(ang + sg * span)
        return torch.where(straight, x_st, x_arc), torch.where(straight, y_st, y_arc)


def chicane_track(theta_deg: float, half_width: float) -> ArcTrack:
    th = theta_deg * math.pi / 180
    return ArcTrack([[1.0, 0.0], [4.0, -4.0 / th], [1.0, 0.0], [4.0, 4.0 / th], [5.0, 0.0]],
                    half_width)


# ------------------------------------------------------------------------- the game
class ChicaneDuel:
    """The game at the sizes of ``cfg`` (the configuration's ``scenario`` object)."""

    M = 2
    nq_a, nu_a = 6, 2

    def __init__(self, cfg: dict):
        unsupported = {k: cfg[k] for k in ('blocking_weight', 'obs_weight') if cfg[k]}
        if unsupported or cfg['comp_linear'] or not cfg['rate_constraints']:
            raise ValueError(f'the plain game has no blocking, obstacle or linear '
                             f'competition cost and always rate rows: {cfg}')
        self.cfg = cfg
        self.N = int(cfg['N'])
        self.dt = float(cfg['dt'])
        self.hw = float(cfg['half_width'])
        self.track = chicane_track(float(cfg['theta_deg']), self.hw)
        self.n_q, self.n_u = self.M * self.nq_a, self.M * self.nu_a
        self.n_dec = self.N * self.n_u
        self.obs_d = 2 * float(cfg['agent_r'])
        self.u_max = (float(cfg['u_a_max']), float(cfg['u_steer_max']))
        self.rate = (float(cfg['u_a_rate']), float(cfg['u_steer_rate']))
        self.n_c = int(self.constraints(torch.zeros(1, self.N + 1, self.n_q, dtype=torch.float64),
                                        torch.zeros(1, self.n_dec, dtype=torch.float64),
                                        torch.zeros(1, self.n_u, dtype=torch.float64)).shape[-1])

    # layout
    def u_stages(self, u):
        """Agent-stacked (B, n_dec) -> per car (B, N, 2)."""
        B = u.shape[0]
        half = self.N * self.nu_a
        return [u[:, a * half:(a + 1) * half].reshape(B, self.N, self.nu_a) for a in range(self.M)]

    def stages_to_u(self, u_mat):
        """(B, N, n_u) stage-major joint inputs -> agent-stacked (B, n_dec)."""
        B = u_mat.shape[0]
        return torch.cat([u_mat[:, :, a * self.nu_a:(a + 1) * self.nu_a].reshape(B, -1)
                          for a in range(self.M)], dim=-1)

    def own_block(self, a: int):
        half = self.N * self.nu_a
        return slice(a * half, (a + 1) * half)

    # dynamics
    def fc(self, q, u):
        """One car's continuous dynamics."""
        c = self.cfg
        x, y, v, epsi, s, ey = q.unbind(-1)
        acc, steer = u.unbind(-1)
        L_f, L_r = float(c['wheel_dist_front']), float(c['wheel_dist_rear'])
        beta = torch.atan2(torch.tan(steer) * L_r, torch.full_like(steer, L_f + L_r))
        psidot = v / L_r * torch.sin(beta)
        kappa = self.track.curvature(s)
        psi_t = self.track.tangent_angle(s)
        ds = v * torch.cos(beta + epsi) / (1 - ey * kappa)
        f_ext = -float(c['drag_coefficient']) * v * torch.abs(v) \
            - float(c['slip_coefficient']) * psidot ** 2
        return torch.stack([v * torch.cos(beta + psi_t + epsi), v * torch.sin(beta + psi_t + epsi),
                            acc + f_ext / float(c['mass']), psidot - kappa * ds, ds,
                            v * torch.sin(beta + epsi)], dim=-1)

    def step(self, q, u):
        """Joint explicit Euler step: q (B, n_q), u (B, n_u)."""
        qa = q.reshape(*q.shape[:-1], self.M, self.nq_a)
        ua = u.reshape(*u.shape[:-1], self.M, self.nu_a)
        return (qa + self.dt * self.fc(qa, ua)).reshape(q.shape)

    def rollout(self, u, x0):
        """(B, N+1, n_q) by single shooting."""
        ua = self.u_stages(u)
        u_mat = torch.cat(ua, dim=-1)
        xs = [x0]
        for k in range(self.N):
            xs.append(self.step(xs[-1], u_mat[:, k]))
        return torch.stack(xs, dim=1)

    # costs and constraints
    def costs(self, x, u, up):
        """(B, M): each car's cost along the rollout ``x``."""
        c = self.cfg
        w, wr = c['input_weight'], c['input_rate_weight']
        c0, c1 = c['comp_weights']
        out = []
        for a, ua in enumerate(self.u_stages(u)):
            um = torch.cat([up[:, None, a * self.nu_a:(a + 1) * self.nu_a], ua[:, :-1]], dim=1)
            du = ua - um
            J = (0.5 * (w[0] * ua[..., 0] ** 2 + w[1] * ua[..., 1] ** 2)
                 + 0.5 * (wr[0] * du[..., 0] ** 2 + wr[1] * du[..., 1] ** 2)).sum(-1)
            s_own = x[:, self.N, a * self.nq_a + 4]
            s_oth = x[:, self.N, (1 - a) * self.nq_a + 4]
            out.append(J - c0 * s_own + c1 * torch.atan(s_oth - s_own))
        return torch.stack(out, dim=-1)

    def constraints(self, x, u, up):
        """(B, n_c): every inequality g <= 0 in the game's row order."""
        N, dt = self.N, self.dt
        ua = self.u_stages(u)
        um = [torch.cat([up[:, None, a * self.nu_a:(a + 1) * self.nu_a], ua[a][:, :-1]], dim=1)
              for a in range(self.M)]
        rows = []

        def shared(k):
            d = x[:, k, 0:2] - x[:, k, self.nq_a:self.nq_a + 2]
            rows.append((self.obs_d ** 2 - (d * d).sum(-1))[:, None])

        def lateral(a, k):
            ey = x[:, k, a * self.nq_a + 5]
            rows.append(torch.stack([ey - self.hw, -self.hw - ey], dim=-1))

        for k in range(N):
            if k >= 1:
                shared(k)
            for a in range(self.M):
                d = ua[a][:, k] - um[a][:, k]
                uk = ua[a][:, k]
                rows.append(torch.stack([d[:, 0] - dt * self.rate[0], -dt * self.rate[0] - d[:, 0],
                                         d[:, 1] - dt * self.rate[1], -dt * self.rate[1] - d[:, 1],
                                         uk[:, 0] - self.u_max[0], uk[:, 1] - self.u_max[1],
                                         -self.u_max[0] - uk[:, 0], -self.u_max[1] - uk[:, 1]],
                                        dim=-1))
                if k >= 1:
                    lateral(a, k)
        shared(N)
        for a in range(self.M):
            lateral(a, N)
        return torch.cat(rows, dim=-1)

    # ------------------------------------------------------------------ the sampler
    def _pid(self, q0, v_ref, lat_ref, n_sub: int = 10, steer_ki: float = 0.005):
        """One car's PID lane follower rolled by RK4 sub-steps: (B, N, 2) inputs."""
        N, dt = self.N, self.dt
        h = dt / n_sub
        q = q0
        ei = torch.zeros_like(q0[:, 0])
        ua_prev, us_prev = torch.zeros_like(ei), torch.zeros_like(ei)
        u_seq, q_seq = [], [q0]
        for _ in range(N):
            ua = -(q[:, 2] - v_ref)
            # the rate limits clamp the change a step, as the study's warm start does
            ua = torch.clamp(ua_prev + torch.clamp(ua - ua_prev, -self.rate[0], self.rate[0]),
                             -self.u_max[0], self.u_max[0])
            err = 5.0 * (q[:, 5] - lat_ref) + q[:, 3]
            ei = torch.clamp(ei + err * dt, -100.0, 100.0)
            us = -(err + steer_ki * ei)
            us = torch.clamp(us_prev + torch.clamp(us - us_prev, -self.rate[1], self.rate[1]),
                             -self.u_max[1], self.u_max[1])
            u = torch.stack([ua, us], dim=-1)
            for _s in range(n_sub):
                a1 = self.fc(q, u)
                a2 = self.fc(q + (h / 2) * a1, u)
                a3 = self.fc(q + (h / 2) * a2, u)
                a4 = self.fc(q + h * a3, u)
                q = q + h * (a1 + 2 * a2 + 2 * a3 + a4) / 6
            ua_prev, us_prev = ua, us
            u_seq.append(u)
            q_seq.append(q)
        return torch.stack(u_seq, dim=1), torch.stack(q_seq, dim=1)

    def sample(self, num: int, rng: np.random.Generator, device, max_rounds: int = 50,
               trajectories: bool = False):
        """``num`` accepted initial conditions of the study, in float64 on ``device``:
        (x0 (B, n_q), u_ws (B, N, n_u), up (B, n_u)), and with ``trajectories`` the
        warm starts' states (B, N+1, n_q).  Candidates, twice the batch and at least 8
        a round, are drawn on the first straight; a pair whose rival is
        off the track or whose PID warm starts collide is rejected."""
        hw, first = self.hw, float(self.track.key_pts[1, 4])
        t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
        xs, us, qs, need = [], [], [], num
        B = max(2 * num, 8)
        for _ in range(max_rounds):
            ego_s = np.maximum(0.1, rng.random(B) * first)
            ego_ey = rng.random(B) * hw * 2 - hw
            ego_v = rng.random(B) + 2
            d = 2 * np.pi * rng.random(B)
            tar_s = ego_s + 1.2 * self.obs_d * np.cos(d)
            tar_ey = ego_ey + 1.2 * self.obs_d * np.sin(d)
            tar_v = rng.random(B) + 2
            geo_ok = (tar_s >= 0) & (np.abs(tar_ey) <= hw)
            q_a = []
            for s, ey, v in ((ego_s, ego_ey, ego_v), (tar_s, tar_ey, tar_v)):
                gx, gy = self.track.local_to_global(t(s), t(ey))
                q_a.append(torch.stack([gx, gy, t(v), t(np.zeros(B)), t(s), t(ey)], dim=-1))
            # both cars' lane followers in one batch
            u_seq, q_seq = self._pid(torch.cat(q_a), t(np.concatenate([ego_v, tar_v])),
                                     t(np.concatenate([ego_ey, tar_ey])))
            u_a, traj = u_seq.split(B), q_seq.split(B)
            dist = torch.linalg.vector_norm(traj[0][..., 0:2] - traj[1][..., 0:2], dim=-1)
            collide = (dist < self.obs_d).any(-1).cpu().numpy()
            idx = np.where(geo_ok & ~collide)[0][:need]
            if idx.size:
                sel = torch.as_tensor(idx, device=device)
                xs.append(torch.cat(q_a, dim=-1)[sel])
                us.append(torch.cat(u_a, dim=-1)[sel])
                qs.append(torch.cat(traj, dim=-1)[sel])
                need -= idx.size
            if need == 0:
                break
        if need:
            raise RuntimeError(f'sampler: {need} of {num} initial conditions missing')
        x0, u_ws = torch.cat(xs), torch.cat(us)
        up = torch.zeros(num, self.n_u, dtype=torch.float64, device=device)
        return (x0, u_ws, up, torch.cat(qs)) if trajectories else (x0, u_ws, up)


def build(cfg: dict) -> ChicaneDuel:
    return ChicaneDuel(cfg)
