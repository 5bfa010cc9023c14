"""The exact dynamic-bicycle study's sampler and warm start, ported from
``dgsqp_tpu/harness/dynamic_study.py``.

Initial conditions are drawn around the ``L_track_barc`` raceline with numpy's
``default_rng(seed)`` in the JAX package's order (so the same seed draws the same
candidates), placed on the track and warm-started as one batch on the device, and
rejected on a vehicle-box collision at the start or a collision of the warm-start
rollouts.  The warm start is a raceline-following PID rollout of the dynamic bicycle
itself, one tensor loop over the horizon for every game and both cars at once (the
JAX package maps a per-game ``lax.scan``).  The approximate (progress-augmented) duel
is sampled through the exact one and converted to its layout.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from dgsqp_torch.tracks.track_lib import load_mpclab_raceline

# the reference study's car box
VL, VW = 0.37, 0.195
_RACELINE_NPZ = Path(__file__).parent / 'data' / 'L_track_barc_raceline.npz'
_BOX_R = float(np.sqrt((VL / 2) ** 2 + (VW / 2) ** 2))


def ltrack_raceline(time_scale: float = 1.7):
    """The study raceline on ``L_track_barc``: (raceline, s2t, raceline_mat)."""
    return load_mpclab_raceline(_RACELINE_NPZ, 'L_track_barc', time_scale=time_scale)


def rk4_substeps(model, q, u, dt: float, n_sub: int):
    """``n_sub`` RK4 sub-steps of ``model.fc`` over ``dt``.  Where that is the model's own
    discrete step (rk4, M = n_sub, its dt) it is taken as ``model.fd``: the same
    arithmetic, one fused operation for the dynamic bicycles on the card."""
    cfg = model.model_config
    if cfg.discretization_method == 'rk4' and model.M == n_sub and model.dt == dt:
        return model.fd(q, u)
    h = dt / n_sub
    for _ in range(n_sub):
        a1 = model.fc(q, u)
        a2 = model.fc(q + (h / 2) * a1, u)
        a3 = model.fc(q + (h / 2) * a2, u)
        a4 = model.fc(q + h * a3, u)
        q = q + h * (a1 + 2 * a2 + 2 * a3 + a4) / 6
    return q


def _collision(q_ws, xy1, xy2, obs_d: float):
    d2 = (q_ws[..., xy1[0]] - q_ws[..., xy2[0]]) ** 2 + (q_ws[..., xy1[1]] - q_ws[..., xy2[1]]) ** 2
    return torch.any(d2 < obs_d ** 2, dim=-1)


def dynamic_warm_start(scenario, x0_joint, v_refs, ey_refs, n_sub: int = 10):
    """PID raceline-follower rollout of both ``DynamicBicycleCombined`` cars for a batch.

    Per car [x, y, vx, vy, psidot, epsi, s, xtran]: speed PID (Kp = 1) on
    ``vx - v_ref``, steering PID on ``5 (xtran - ey_ref) + epsi``, clipped to the input
    box.  ``x0_joint`` (B, 16), ``v_refs``/``ey_refs`` (B, 2).  Returns (u_ws (B, N, 4),
    q_ws (B, N+1, 16), collision (B,)) at the shared-constraint radius ``obs_d``.
    """
    model = scenario.joint_model._shared_model
    if model is None:
        raise ValueError('dynamic_warm_start rolls both cars as one batch: they must share '
                         'one model definition')
    N, dt = scenario.N, scenario.dt
    ua_max, us_max = float(scenario.input_ub[0]), float(scenario.input_ub[1])
    V, EPSI, EY = 2, 5, 7
    B = x0_joint.shape[0]
    q = x0_joint.reshape(B, 2, model.n_q)
    u_seq, q_seq = [], [q]
    for _ in range(N):
        ua = torch.clamp(-(q[..., V] - v_refs), -ua_max, ua_max)
        err = 5.0 * (q[..., EY] - ey_refs) + q[..., EPSI]
        us = torch.clamp(-err, -us_max, us_max)
        u = torch.stack([ua, us], dim=-1)
        q = rk4_substeps(model, q, u, dt, n_sub)
        u_seq.append(u)
        q_seq.append(q)
    u_ws = torch.stack(u_seq, dim=1).reshape(B, N, -1)
    q_ws = torch.stack(q_seq, dim=1).reshape(B, N + 1, -1)
    return u_ws, q_ws, _collision(q_ws, (0, 1), (8, 9), scenario.obs_d)


def _raceline_lookup(raceline, s2t, s):
    """(v_long, e_psi, e_y) of the raceline at arc lengths ``s`` (a tensor), as numpy."""
    cols = raceline(s2t(s))
    return tuple(cols[i].cpu().numpy().astype(np.float64) for i in (3, 6, 8))


def sample_dynamic_duel_initial_conditions(scenario, num_samples: int, seed: int = 0,
                                           max_rounds: int = 60, dtype=torch.float32,
                                           device='cuda'):
    """Raceline-relative initial conditions of the exact dynamic duel.

    Car 1: s ~ U(0, L); lateral = raceline e_y + U(-1, 1) clipped to 90% of the local
    widths; v = raceline v_long + U(-0.75, 0.75); e_psi from the raceline.  Car 2: s
    displaced by ``1.2 obs_d U(-1, 1)``, the same laws.  A fixed candidate batch
    ``max(2 n, 8)`` a round; rejection on the vehicle boxes at the start and on the
    warm-start rollouts' collision.  Returns numpy x0 (n, 16), u_ws (n, N, 4),
    v_ref (n, 2), ey_ref (n, 2); the lookups, placement and warm start run in ``dtype``
    on ``device``.
    """
    track = scenario.track
    raceline, s2t, _ = ltrack_raceline()
    L = float(track.track_length)
    rng = np.random.default_rng(seed)
    obs_d = scenario.obs_d

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def draw_car(s):
        v_r, ep_r, ey_r = _raceline_lookup(raceline, s2t, t(s))
        lw = track.left_width(t(s)).cpu().numpy().astype(np.float64)
        rw = track.right_width(t(s)).cpu().numpy().astype(np.float64)
        ey = np.clip(ey_r + (2 * rng.random(s.shape) - 1), -0.9 * rw, 0.9 * lw)
        v = v_r + (1.5 * rng.random(s.shape) - 0.75)
        xyp = track.local_to_global(t(np.stack([s, ey, ep_r], axis=-1)))
        return v, ep_r, ey, xyp.cpu().numpy().astype(np.float64)

    xs, us, vrs, ers = [], [], [], []
    need = num_samples
    B = max(2 * num_samples, 8)
    for _ in range(max_rounds):
        s1 = L * rng.random(B)
        v1, ep1, ey1, xyp1 = draw_car(s1)
        s2 = s1 + 1.2 * obs_d * (2 * rng.random(B) - 1)
        s2 = np.mod(s2, L)
        v2, ep2, ey2, xyp2 = draw_car(s2)

        box_ok = np.sum((xyp1[:, :2] - xyp2[:, :2]) ** 2, axis=1) >= (2 * _BOX_R) ** 2
        zeros = np.zeros(B)
        x0 = np.stack([xyp1[:, 0], xyp1[:, 1], v1, zeros, zeros, ep1, s1, ey1,
                       xyp2[:, 0], xyp2[:, 1], v2, zeros, zeros, ep2, s2, ey2], axis=-1)
        v_ref = np.stack([v1, v2], axis=-1)
        ey_ref = np.stack([ey1, ey2], axis=-1)
        u_ws, _, collision = dynamic_warm_start(scenario, t(x0), t(v_ref), t(ey_ref))
        ok = box_ok & ~collision.cpu().numpy()
        idx = np.where(ok)[0][:need]
        if idx.size:
            xs.append(x0[idx])
            us.append(u_ws.cpu().numpy().astype(np.float64)[idx])
            vrs.append(v_ref[idx])
            ers.append(ey_ref[idx])
            need -= idx.size
        if need == 0:
            break
    if need > 0:
        raise RuntimeError(f'Dynamic sampler failed to draw {num_samples} valid ICs '
                           f'({need} missing after {max_rounds} rounds)')
    return (np.concatenate(xs), np.concatenate(us),
            np.concatenate(vrs), np.concatenate(ers))


def combined_to_pa_dynamic(x0_combined, q_ws, u_ws, track, dt):
    """Map exact-duel samples and warm starts to the progress-augmented layout.

    Per car [x, y, vx, vy, psidot, epsi, s, xtran] becomes [vx, vy, psidot, x, y, psi, s]
    with ``psi = epsi + the track's tangent angle at s``; the inputs gain the arc-speed
    channel ``u_ds_k = (s_{k+1} - s_k) / dt`` of the rollout.  numpy in and out:
    x0_combined (B, 16), q_ws (B, N+1, 16), u_ws (B, N, 4) -> (x0_pa (B, 14),
    u_pa (B, N, 6)).
    """
    B = x0_combined.shape[0]
    x0_pa = np.zeros((B, 14))
    u_pa_parts = []
    for a, off in enumerate((0, 8)):
        c = x0_combined[:, off:off + 8]
        psi = c[:, 5] + track.tangent_angle(torch.as_tensor(c[:, 6], dtype=torch.float64)).numpy()
        x0_pa[:, 7 * a:7 * (a + 1)] = np.stack(
            [c[:, 2], c[:, 3], c[:, 4], c[:, 0], c[:, 1], psi, c[:, 6]], axis=-1)
        s_traj = q_ws[:, :, off + 6]
        ds = (s_traj[:, 1:] - s_traj[:, :-1]) / dt
        u_pa_parts.append(np.concatenate(
            [u_ws[:, :, 2 * a:2 * (a + 1)], ds[:, :, None]], axis=-1))
    return x0_pa, np.concatenate(u_pa_parts, axis=-1)


def sample_dynamic_pa_initial_conditions(pa_scenario, num_samples: int, seed: int = 0,
                                         dtype=torch.float32, device='cuda'):
    """Initial conditions of the approximate dynamic duel: drawn by the exact duel's
    sampler (same horizon, step and car radius), its warm start rolled again for the
    progress trace, and both converted by :func:`combined_to_pa_dynamic`."""
    from dgsqp_torch.harness.scenarios import build_dynamic_duel
    exact = build_dynamic_duel(N=pa_scenario.N, dt=pa_scenario.dt,
                               car_r=pa_scenario.obs_d / 2)
    x0c, _, v_ref, ey_ref = sample_dynamic_duel_initial_conditions(
        exact, num_samples, seed=seed, dtype=dtype, device=device)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)
    u_ws, q_ws, _ = dynamic_warm_start(exact, t(x0c), t(v_ref), t(ey_ref))
    host = lambda a: a.cpu().numpy().astype(np.float64)
    x0_pa, u_pa = combined_to_pa_dynamic(x0c, host(q_ws), host(u_ws), pa_scenario.track,
                                         pa_scenario.dt)
    return x0_pa, u_pa, v_ref, ey_ref
