"""Monte-Carlo initial-condition samplers with rejection, ported from
``sample_duel_initial_conditions``, ``sample_agents_initial_conditions`` and
``sample_merge_initial_conditions`` in ``dgsqp_tpu/harness/samplers.py``.

Candidates are drawn with numpy's ``default_rng(seed)`` exactly as in the JAX package
(so the same seed draws the same candidates), placed on the track, warm-started as one
batch on the device, filtered (off-track target, warm-start collision) and topped up.
"""
from __future__ import annotations

import numpy as np
import torch

from dgsqp_torch.harness.warm_start import (duel_warm_start, pa_twins, pa_warm_start,
                                            pid_warm_start)


def sample_duel_initial_conditions(scenario, num_samples: int, seed: int = 0,
                                   max_rounds: int = 50, dtype=torch.float32,
                                   device='cuda'):
    """Draw ``num_samples`` accepted (x0_joint, u_ws, v_refs, lat_refs) tuples.

    Returns numpy arrays x0 (B, n_q), u_ws (B, N, n_u), v_ref (B, 2), lat_ref (B, 2);
    the track placement and warm start run in ``dtype`` on ``device``.  For a
    progress-augmented scenario the PID rolls on combined twins (``pa_warm_start``) and
    x0 comes back in the progress-augmented layout.
    """
    twins = pa_twins(scenario)
    track = scenario.track
    first_seg_len = float(scenario.track.cl_segs[0, 0])
    hw = scenario.half_width
    obs_d = scenario.obs_d
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    xs, us, vrs, lrs = [], [], [], []
    need = num_samples
    B = max(2 * num_samples, 8)
    for _ in range(max_rounds):
        ego_s = np.maximum(0.1, rng.random(B) * first_seg_len)
        ego_ey = rng.random(B) * hw * 2 - hw
        ego_v = rng.random(B) + 2
        d = 2 * np.pi * rng.random(B)
        tar_s = ego_s + 1.2 * obs_d * np.cos(d)
        tar_ey = ego_ey + 1.2 * obs_d * np.sin(d)
        tar_v = rng.random(B) + 2
        geo_ok = (tar_s >= 0) & (np.abs(tar_ey) <= hw)

        ego_xyp = track.local_to_global(t(np.stack([ego_s, ego_ey, np.zeros(B)], axis=-1)))
        tar_xyp = track.local_to_global(t(np.stack([tar_s, tar_ey, np.zeros(B)], axis=-1)))
        ego_xyp = ego_xyp.cpu().numpy().astype(np.float64)
        tar_xyp = tar_xyp.cpu().numpy().astype(np.float64)
        # joint state per agent: [x, y, v, e_psi, s, x_tran]
        x0 = np.stack([ego_xyp[:, 0], ego_xyp[:, 1], ego_v, np.zeros(B), ego_s, ego_ey,
                       tar_xyp[:, 0], tar_xyp[:, 1], tar_v, np.zeros(B), tar_s, tar_ey],
                      axis=-1)
        v_ref = np.stack([ego_v, tar_v], axis=-1)
        lat_ref = np.stack([ego_ey, tar_ey], axis=-1)

        if twins is None:
            u_ws, _, collision = duel_warm_start(scenario, t(x0), t(v_ref), t(lat_ref))
        else:
            u_ws, x0_pa, collision = pa_warm_start(scenario, twins, t(x0), t(v_ref),
                                                   t(lat_ref))
            x0 = x0_pa.cpu().numpy().astype(np.float64)
        ok = geo_ok & ~collision.cpu().numpy()
        idx = np.where(ok)[0][:need]
        if idx.size:
            xs.append(x0[idx])
            us.append(u_ws.cpu().numpy()[idx])
            vrs.append(v_ref[idx])
            lrs.append(lat_ref[idx])
            need -= idx.size
        if need == 0:
            break
    if need > 0:
        raise RuntimeError(f'Sampler failed to draw {num_samples} valid ICs '
                           f'({need} missing after {max_rounds} rounds)')
    return (np.concatenate(xs), np.concatenate(us),
            np.concatenate(vrs), np.concatenate(lrs))


def sample_agents_initial_conditions(scenario, num_samples: int, seed: int = 0,
                                     max_rounds: int = 400, dtype=torch.float32,
                                     device='cuda'):
    """Sampler of the M-agent scaling study: every agent placed independently on the
    first track segment, PID warm start, pairwise collision rejection.  Returns numpy
    arrays x0 (B, 6M), u_ws (B, N, 2M), v_ref (B, M), lat_ref (B, M)."""
    track = scenario.track
    M = scenario.joint_model.n_a
    first_seg_len = float(track.cl_segs[0, 0])
    hw = scenario.half_width
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    xs, us, vrs, lrs = [], [], [], []
    need = num_samples
    # the candidate batch is fixed, so every round draws the same count from the
    # generator whatever is still missing
    B = max(8 * num_samples, 64)
    for _ in range(max_rounds):
        s = np.maximum(0.1, rng.random((B, M)) * first_seg_len)
        ey = rng.random((B, M)) * hw * 2 - hw
        v = rng.random((B, M)) + 2

        x0 = np.zeros((B, 6 * M))
        for a in range(M):
            xyp = track.local_to_global(t(np.stack([s[:, a], ey[:, a], np.zeros(B)], axis=-1)))
            xyp = xyp.cpu().numpy().astype(np.float64)
            x0[:, 6 * a:6 * (a + 1)] = np.stack(
                [xyp[:, 0], xyp[:, 1], v[:, a], np.zeros(B), s[:, a], ey[:, a]], axis=-1)

        u_ws, _, collision = pid_warm_start(scenario, t(x0), t(v), t(ey))
        ok = ~collision.cpu().numpy()
        idx = np.where(ok)[0][:need]
        if idx.size:
            xs.append(x0[idx])
            us.append(u_ws.cpu().numpy()[idx])
            vrs.append(v[idx])
            lrs.append(ey[idx])
            need -= idx.size
        if need == 0:
            break
    if need > 0:
        raise RuntimeError(f'Agents sampler failed: {need} missing after {max_rounds} rounds')
    return (np.concatenate(xs), np.concatenate(us),
            np.concatenate(vrs), np.concatenate(lrs))


def sample_merge_initial_conditions(scenario, num_samples: int, seed: int = 1,
                                    max_rounds: int = 80, dtype=torch.float32,
                                    device='cuda'):
    """Sampler of the merge study: jittered nominal states for the two straight-lane cars
    and the ramp car, zero-input warm-start rollouts (one batch on the device), pairwise
    collision rejection over the whole rollout.

    Returns numpy arrays x0 (B, 12), u_ws (B, N, 6) all zero, and None, None.
    """
    geo = scenario.merge_geometry
    th = geo['th']
    x5, x7 = geo['x5'], geo['x7']
    N = scenario.N
    joint = scenario.joint_model
    rng = np.random.default_rng(seed)

    def rollout_zero(x0):
        q = torch.as_tensor(x0, dtype=dtype, device=device)
        u = q.new_zeros(q.shape[0], joint.n_u)
        qs = [q]
        for _ in range(N):
            qs.append(joint.fd(qs[-1], u))
        return torch.stack(qs, dim=1).cpu().numpy().astype(np.float64)

    xs = []
    need = num_samples
    for _ in range(max_rounds):
        B = max(2 * need, 8)

        def jitter(x_nom, y_nom, v_nom=0.3, p_nom=0.0):
            x = x_nom + 0.5 * rng.random(B) - 0.25
            y = y_nom + 0.1 * rng.random(B) - 0.05
            v = v_nom * (1 + 0.06 * rng.random(B) - 0.03)
            p = p_nom + (5 * rng.random(B) - 2.5) * np.pi / 180
            return np.stack([x, y, v, p], axis=-1)

        c1 = jitter(0.0, 0.15)
        c2 = jitter(0.5, 0.15)
        # ramp car: jitter along the ramp's direction
        x_nom = 0.25
        y_nom = -(float(x7[0] + x5[0]) / 2 - 0.25) * np.tan(th)
        s_r = 0.5 * rng.random(B) - 0.25
        ey_r = 0.1 * rng.random(B) - 0.05
        c3 = np.stack([x_nom + s_r * np.cos(th) - ey_r * np.sin(th),
                       y_nom + s_r * np.sin(th) + ey_r * np.cos(th),
                       0.3 * (1 + 0.06 * rng.random(B) - 0.03),
                       np.pi / 12 + (5 * rng.random(B) - 2.5) * np.pi / 180], axis=-1)
        x0 = np.concatenate([c1, c2, c3], axis=-1)

        q_traj = rollout_zero(x0)    # (B, N+1, 12)
        ok = np.ones(B, dtype=bool)
        for i in range(3):
            for j in range(i + 1, 3):
                d = np.linalg.norm(q_traj[:, :, 4 * i:4 * i + 2] -
                                   q_traj[:, :, 4 * j:4 * j + 2], axis=-1)
                ok &= (d >= scenario.obs_d).all(axis=1)
        idx = np.where(ok)[0][:need]
        if idx.size:
            xs.append(x0[idx])
            need -= idx.size
        if need == 0:
            break
    if need > 0:
        raise RuntimeError(f'Merge sampler failed: {need} missing after {max_rounds} rounds')
    return np.concatenate(xs), np.zeros((num_samples, N, joint.n_u)), None, None
