"""Batched PID warm starts, ported from ``dgsqp_tpu/harness/warm_start.py``.

PID lane followers are rolled through the plant model with fine RK4 substeps and the
input sequences are stacked.  Every function takes an explicit leading batch dimension
(the JAX version vmaps a per-game ``lax.scan``; here the scan is a Python loop over the
horizon on the whole batch).
"""
from __future__ import annotations

import numpy as np
import torch


def pid_rollout(model, q0, v_ref, lat_ref, N: int, dt: float,
                u_abs, u_rate, steer_ki: float = 0.005, n_sub: int = 10):
    """Roll one agent's PID lane follower for N steps, for a batch.

    Speed PID with Kp=1 on ``v - v_ref``; steering PID with Kp=1, Ki=steer_ki on
    ``5*(x_tran - lat_ref) + e_psi``; per-step rate clamps, then absolute clamps.

    Args:
        model: dynamics model with ``fc(q, u)``; state indices v=2, e_psi=3, x_tran=5.
        q0: (B, n_q) initial states; v_ref, lat_ref: (B,).
        u_abs, u_rate: length-2 absolute and per-step rate limits.
    Returns:
        (u_seq (B, N, 2), q_seq (B, N+1, n_q))
    """
    V_IDX, EPSI_IDX, EY_IDX = 2, 3, 5
    h = dt / n_sub
    ua_max, us_max = float(u_abs[0]), float(u_abs[1])
    dua_max, dus_max = float(u_rate[0]), float(u_rate[1])

    q = q0
    ei = torch.zeros_like(q0[..., 0])
    ua_prev = torch.zeros_like(ei)
    us_prev = torch.zeros_like(ei)
    u_seq, q_seq = [], [q0]
    for _ in range(N):
        ua = -(q[..., V_IDX] - v_ref)
        dua = torch.clamp(ua - ua_prev, -dua_max, dua_max)
        ua = torch.clamp(ua_prev + dua, -ua_max, ua_max)
        err = 5.0 * (q[..., EY_IDX] - lat_ref) + q[..., EPSI_IDX]
        ei = torch.clamp(ei + err * dt, -100.0, 100.0)
        us = -(err + steer_ki * ei)
        dus = torch.clamp(us - us_prev, -dus_max, dus_max)
        us = torch.clamp(us_prev + dus, -us_max, us_max)
        u = torch.stack([ua, us], dim=-1)
        for _s in range(n_sub):
            a1 = model.fc(q, u)
            a2 = model.fc(q + (h / 2) * a1, u)
            a3 = model.fc(q + (h / 2) * a2, u)
            a4 = model.fc(q + h * a3, u)
            q = q + h * (a1 + 2 * a2 + 2 * a3 + a4) / 6
        ua_prev, us_prev = ua, us
        u_seq.append(u)
        q_seq.append(q)
    return torch.stack(u_seq, dim=-2), torch.stack(q_seq, dim=-2)


def pid_warm_start(scenario, q0_joint, v_refs, lat_refs):
    """Warm-start all M agents of a racing scenario from a batch of joint initial states.

    ``q0_joint`` (B, n_q), ``v_refs``/``lat_refs`` (B, M).  Returns (u_ws (B, N, n_u),
    q_ws (B, N+1, n_q), collision (B,)), where collision is any-step pairwise global xy
    distance below ``obs_d``.
    """
    models = scenario.joint_model.dynamics_models
    n_qs = scenario.joint_model.num_qa_d
    off = 0
    u_list, q_list = [], []
    for a, m in enumerate(models):
        q0 = q0_joint[..., off:off + n_qs[a]]
        u_seq, q_seq = pid_rollout(m, q0, v_refs[..., a], lat_refs[..., a], scenario.N,
                                   scenario.dt, scenario.input_ub, scenario.input_rate_ub)
        u_list.append(u_seq)
        q_list.append(q_seq)
        off += n_qs[a]
    u_ws = torch.cat(u_list, dim=-1)
    q_ws = torch.cat(q_list, dim=-1)
    collision = torch.zeros(q0_joint.shape[:-1], dtype=torch.bool, device=q0_joint.device)
    for i in range(len(models)):
        for j in range(i + 1, len(models)):
            d = torch.linalg.vector_norm(q_list[i][..., 0:2] - q_list[j][..., 0:2], dim=-1)
            collision = collision | torch.any(d < scenario.obs_d, dim=-1)
    return u_ws, q_ws, collision


# name of the 2-agent case in the JAX package
duel_warm_start = pid_warm_start


def seed_virtual_rate_prev(up, u_ws_stage0, joint_model):
    """Seed the previous-input vector's virtual arc-speed channels (third input of a
    progress-augmented agent) from the warm start; plain 2-input agents keep 0."""
    offs = np.cumsum([0] + [getattr(m, 'n_u', 2) for m in joint_model.dynamics_models])
    up = up.clone()
    for a, m in enumerate(joint_model.dynamics_models):
        if getattr(m, 'n_u', 2) >= 3:
            idx = int(offs[a]) + 2
            up[..., idx] = u_ws_stage0[..., idx]
    return up


def pa_twins(scenario):
    """Combined-bicycle twins for warm-starting progress-augmented scenarios: None for
    plain 2-input scenarios, else one ``KinematicBicycleCombined`` per agent with its
    configuration and track (the approximate game is warm-started by rolling the PID
    through the exact model and appending the arc-speed channel)."""
    models = scenario.joint_model.dynamics_models
    if all(getattr(m, 'n_u', 2) == 2 for m in models):
        return None
    from dgsqp_torch.dynamics.models import KinematicBicycleCombined
    return [KinematicBicycleCombined(0.0, m.model_config, track=m.track) for m in models]


def pa_warm_start(scenario, twins, q0_joint, v_refs, lat_refs):
    """PID warm start of a progress-augmented (MPCC) scenario, for a batch.

    ``q0_joint`` (B, 6M) is in the combined layout ([x, y, v, e_psi, s, x_tran] per
    agent, the sampler's frame).  The PID lane followers roll on the combined twins;
    each agent's inputs ``[u_a, u_steer]`` get the virtual arc speed
    ``u_ds_k = (s_{k+1} - s_k)/dt`` appended, and its initial state becomes
    ``[x, y, v, psi, s]`` with ``psi = e_psi + tangent angle at s``.

    Returns (u_ws (B, N, 3M), x0_pa (B, 5M), collision (B,)).
    """
    N, dt = scenario.N, scenario.dt
    u_list, q_list, x0_list = [], [], []
    for a, m in enumerate(twins):
        q0 = q0_joint[..., 6 * a:6 * (a + 1)]
        u_seq, q_seq = pid_rollout(m, q0, v_refs[..., a], lat_refs[..., a], N, dt,
                                   scenario.input_ub[:2], scenario.input_rate_ub[:2])
        ds = (q_seq[..., 1:, 4] - q_seq[..., :-1, 4]) / dt
        u_list.append(torch.cat([u_seq, ds[..., None]], dim=-1))
        q_list.append(q_seq)
        psi0 = q0[..., 3] + m.track.tangent_angle(q0[..., 4])
        x0_list.append(torch.stack([q0[..., 0], q0[..., 1], q0[..., 2], psi0, q0[..., 4]],
                                   dim=-1))
    u_ws = torch.cat(u_list, dim=-1)
    x0_pa = torch.cat(x0_list, dim=-1)
    collision = torch.zeros(q0_joint.shape[:-1], dtype=torch.bool, device=q0_joint.device)
    for i in range(len(twins)):
        for j in range(i + 1, len(twins)):
            d = torch.linalg.vector_norm(q_list[i][..., 0:2] - q_list[j][..., 0:2], dim=-1)
            collision = collision | torch.any(d < scenario.obs_d, dim=-1)
    return u_ws, x0_pa, collision
