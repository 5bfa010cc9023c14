"""Monte-Carlo initial-condition sampler with rejection, ported from
``sample_duel_initial_conditions`` in ``dgsqp_tpu/harness/samplers.py``.

Candidates are drawn with numpy's ``default_rng(seed)`` exactly as in the JAX package
(so the same seed draws the same candidates), placed on the track, warm-started as one
batch on the device, filtered (off-track target, warm-start collision) and topped up.
"""
from __future__ import annotations

import numpy as np
import torch

from dgsqp_torch.harness.warm_start import duel_warm_start


def sample_duel_initial_conditions(scenario, num_samples: int, seed: int = 0,
                                   max_rounds: int = 50, dtype=torch.float32,
                                   device='cuda'):
    """Draw ``num_samples`` accepted (x0_joint, u_ws, v_refs, lat_refs) tuples.

    Returns numpy arrays x0 (B, n_q), u_ws (B, N, n_u), v_ref (B, 2), lat_ref (B, 2);
    the track placement and warm start run in ``dtype`` on ``device``.
    """
    if any(getattr(m, 'n_u', 2) != 2 for m in scenario.joint_model.dynamics_models):
        raise NotImplementedError('progress-augmented scenarios are not ported')
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

        u_ws, _, collision = duel_warm_start(scenario, t(x0), t(v_ref), t(lat_ref))
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
