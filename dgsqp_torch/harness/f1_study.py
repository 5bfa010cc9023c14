"""The F1-track comparison study, ported from ``dgsqp_tpu/harness/f1_study.py``.

A two-car duel of progress-augmented dynamic bicycles on a 20 m segment of the
tenth-scale Austin B-spline track: initial conditions sampled around the TUM raceline,
solved with DGSQP v2 on the approximate (MPCC) game (``DGSQPV2FrenetApprox``) or with
the PATH-role MCP oracle (``PATHMCPFrenetApprox``).  The warm start is a
raceline-following PID rollout of the progress-augmented model (speed and steering PID,
arc speed tied to body speed), batched over every game and both cars, with one batched
``global_to_local`` a step.
"""
from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from dgsqp_torch.dynamics import (DynamicBicycleConfig, MultiAgentDynamicsModel,
                                  MultiAgentModelConfig)
from dgsqp_torch.dynamics.progress_augmented import DynamicBicycleProgressAugmented
from dgsqp_torch.harness.scenarios import (Scenario, _linear_race_costs, _pa_bound,
                                           _pair_collision)
from dgsqp_torch.harness.warm_start import seed_virtual_rate_prev
from dgsqp_torch.tracks.track_lib import get_track, load_tum_raceline

# the reference study's constants
TRACK = 'f1_austin_tenth_scale'
DT = 0.1
VL, VW = 0.56, 0.2
CAR_R = float(np.hypot(VL / 2, VW / 2))
SEGMENT = (60.0, 80.0)
TOL = 1e-4

_RACELINE_CSV = Path(__file__).parent / 'data' / 'traj_race_cl.csv'


def f1_track_segment():
    """The 20 m Austin segment of the study."""
    return get_track(TRACK).get_track_segment(list(SEGMENT), 10)


def f1_raceline():
    """The TUM raceline on the study segment: (raceline, s2t, raceline_mat)."""
    return load_tum_raceline(_RACELINE_CSV, TRACK, tenth_scale=True, segment=list(SEGMENT))


def _car_config(dt):
    return DynamicBicycleConfig(dt=dt, model_name='dynamic_bicycle', noise=False,
                                discretization_method='rk4',
                                wheel_dist_front=0.18, wheel_dist_rear=0.18,
                                simple_slip=False, tire_model='pacejka',
                                mass=70.0, yaw_inertia=2.0627, wheel_friction=0.9,
                                pacejka_b_front=10.0, pacejka_b_rear=10.0,
                                pacejka_c_front=2.5, pacejka_c_rear=2.5)


def build_f1_scenario(N: int = 15, dt: float = DT,
                      comp_weights=(1.0, 5.0), input_weight=(1.0, 1.0, 1e-4),
                      input_rate_weight=(1.0, 1.0, 1e-4),
                      u_a_max: float = 2.1, u_steer_max: float = 0.436,
                      u_ds_max: float = 4.0, track=None) -> Scenario:
    """The two-car approximate dynamic game: quadratic input and input-rate stage costs,
    linear terminal progress and competition on the progress states, and shared
    collision avoidance as the only explicit constraint (the track boundary enters
    through the approximation inside ``DGSQPV2FrenetApprox``)."""
    if track is None:
        track = f1_track_segment()
    car1 = DynamicBicycleProgressAugmented(0.0, _car_config(dt), track=track)
    car2 = DynamicBicycleProgressAugmented(0.0, _car_config(dt), track=track)
    joint = MultiAgentDynamicsModel(0.0, [car1, car2], MultiAgentModelConfig(dt=dt))

    # per-agent PA state [vx, vy, psidot, x, y, psi, s]
    obs_d = 2 * CAR_R
    costs = _linear_race_costs((6, 13), input_weight, input_rate_weight, comp_weights)
    shared_constraints = _pair_collision(N, (3, 4), (10, 11), obs_d)
    agent_constraints = [[None] * (N + 1), [None] * (N + 1)]
    bounds = {'ub': [_pa_bound(1, u_a_max, u_steer_max, u_ds_max)] * 2,
              'lb': [_pa_bound(-1, u_a_max, u_steer_max, u_ds_max)] * 2}

    return Scenario(name='f1_austin', track=track, joint_model=joint, costs=costs,
                    agent_constraints=agent_constraints,
                    shared_constraints=shared_constraints, bounds=bounds, N=N, dt=dt,
                    obs_d=obs_d, half_width=float(track.half_width),
                    input_ub=np.array([u_a_max, u_steer_max, u_ds_max]),
                    input_lb=np.array([-u_a_max, -u_steer_max, 0.0]),
                    input_rate_ub=np.array([10.0, 4.5, 5.0]),
                    input_rate_lb=np.array([-10.0, -4.5, -5.0]))


def f1_warm_start(scenario, x0_joint, v_refs, ey_refs, n_sub: int = 4):
    """Raceline-following PID rollout of both progress-augmented cars for a batch.

    ``x0_joint`` (B, 14), ``v_refs``/``ey_refs`` (B, 2).  Returns (u_ws (B, N, 6),
    q_ws (B, N+1, 14), collision (B,)).
    """
    from dgsqp_torch.harness.dynamic_study import rk4_substeps
    track = scenario.track
    model = scenario.joint_model._shared_model
    if model is None:
        raise ValueError('f1_warm_start rolls both cars as one batch: they must share one '
                         'model definition')
    N, dt = scenario.N, scenario.dt
    B = x0_joint.shape[0]
    q = x0_joint.reshape(B, 2, model.n_q)
    u_seq, q_seq = [], [q]
    for _ in range(N):
        sey = track.global_to_local(q[..., 3:6])
        ua = torch.clamp(-(q[..., 0] - v_refs), -2.1, 2.1)
        err = 5.0 * (sey[..., 1] - ey_refs) + sey[..., 2]
        us = torch.clamp(-err, -0.436, 0.436)
        uds = torch.clamp(q[..., 0], 0.0, 4.0)
        u = torch.stack([ua, us, uds], dim=-1)
        q = rk4_substeps(model, q, u, dt, n_sub)
        u_seq.append(u)
        q_seq.append(q)
    u_ws = torch.stack(u_seq, dim=1).reshape(B, N, -1)
    q_ws = torch.stack(q_seq, dim=1).reshape(B, N + 1, -1)
    d2 = (q_ws[..., 3] - q_ws[..., 10]) ** 2 + (q_ws[..., 4] - q_ws[..., 11]) ** 2
    return u_ws, q_ws, torch.any(d2 < scenario.obs_d ** 2, dim=-1)


def sample_f1_initial_conditions(scenario, num_samples: int, seed: int = 0,
                                 max_rounds: int = 60, dtype=torch.float32, device='cuda'):
    """Raceline-relative initial conditions: car 1 anywhere on the first L - 10 m,
    lateral offset U(-1, 1) around the raceline clipped to 90% of the local widths,
    speed raceline +/- 0.75; car 2 ahead by up to 3 car lengths.  The candidate batch
    ``max(2 need, 8)`` shrinks with what is still needed, as in the JAX package (so the
    draws match).  Returns numpy x0 (n, 14), u_ws (n, N, 6), v_ref (n, 2), ey_ref (n, 2);
    the lookups, placement and warm start run in ``dtype`` on ``device``."""
    from dgsqp_torch.harness.dynamic_study import _raceline_lookup
    track = scenario.track
    raceline, s2t, _ = f1_raceline()
    L = float(track.track_length)
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def host(a):
        return a.cpu().numpy().astype(np.float64)

    xs, us, vrs, ers = [], [], [], []
    need = num_samples
    for _ in range(max_rounds):
        B = max(2 * need, 8)
        s1 = (L - 10.0) * rng.random(B)
        v1r, ep1, ey1r = _raceline_lookup(raceline, s2t, t(s1))
        lw1, rw1 = host(track.left_width(t(s1))), host(track.right_width(t(s1)))
        ey1 = np.clip(ey1r + (2 * rng.random(B) - 1), -0.9 * rw1, 0.9 * lw1)
        v1 = v1r + (1.5 * rng.random(B) - 0.75)

        s2 = s1 + 3 * rng.random(B) * VL
        v2r, ep2, ey2r = _raceline_lookup(raceline, s2t, t(s2))
        lw2, rw2 = host(track.left_width(t(s2))), host(track.right_width(t(s2)))
        ey2 = np.clip(ey2r + (2 * rng.random(B) - 1), -0.9 * rw2, 0.9 * lw2)
        v2 = v2r + (1.5 * rng.random(B) - 0.75)

        xyp1 = host(track.local_to_global(t(np.stack([s1, ey1, ep1], axis=-1))))
        xyp2 = host(track.local_to_global(t(np.stack([s2, ey2, ep2], axis=-1))))
        geo_ok = (np.sum((xyp1[:, :2] - xyp2[:, :2]) ** 2, axis=1)
                  >= scenario.obs_d ** 2) & (s2 <= L)

        # PA joint state [vx, vy, psidot, x, y, psi, s] per car
        zeros = np.zeros(B)
        x0 = np.stack([v1, zeros, zeros, xyp1[:, 0], xyp1[:, 1], xyp1[:, 2], s1,
                       v2, zeros, zeros, xyp2[:, 0], xyp2[:, 1], xyp2[:, 2], s2], axis=-1)
        v_ref = np.stack([v1, v2], axis=-1)
        ey_ref = np.stack([ey1, ey2], axis=-1)
        u_ws, _, collision = f1_warm_start(scenario, t(x0), t(v_ref), t(ey_ref))
        ok = geo_ok & ~collision.cpu().numpy()
        idx = np.where(ok)[0][:need]
        if idx.size:
            xs.append(x0[idx])
            us.append(host(u_ws)[idx])
            vrs.append(v_ref[idx])
            ers.append(ey_ref[idx])
            need -= idx.size
        if need == 0:
            break
    if need > 0:
        raise RuntimeError(f'F1 sampler failed to draw {num_samples} valid ICs')
    return (np.concatenate(xs), np.concatenate(us),
            np.concatenate(vrs), np.concatenate(ers))


def f1_solver_params(N: int, *, reference_faithful: bool = False, **overrides):
    """DGSQP v2's operating point for the F1 study: 150 iterations, constant reg 1,
    every step merit-checked (NMS frequency 1, delta0 0), gradient-scaled KKT tolerance.
    ``reference_faithful=True`` gives the reference study's own knobs (500 iterations,
    reg 1e2 decaying 0.95 a step, NMS frequency 10, delta0 20, absolute tolerances)."""
    from dgsqp_torch.solvers.solver_types import DGSQPV2Params
    if reference_faithful:
        kw = dict(N=N, dt=DT, nms=True, nms_frequency=10, nms_memory_size=10,
                  nms_initial_step_size_factor=20.0, line_search_iters=20,
                  sqp_iters=500, p_tol=TOL, d_tol=TOL,
                  reg=1e2, reg_decay=0.95, delta_decay=0.99, merit_decrease=0.01,
                  conv_scaled_stat=False, approximation_eval='once',
                  beta=0.01, tau=0.5)
    else:
        kw = dict(N=N, dt=DT, nms=True, nms_frequency=1, nms_memory_size=10,
                  nms_initial_step_size_factor=0.0, line_search_iters=20,
                  sqp_iters=150, p_tol=TOL, d_tol=TOL,
                  reg=1.0, reg_decay=1.0, delta_decay=0.99, merit_decrease=0.01,
                  conv_scaled_stat=True, approximation_eval='once',
                  beta=0.01, tau=0.5)
    kw.update(overrides)
    return DGSQPV2Params(**kw)


def run_f1_study(N: int = 15, num_samples: int = 10, seed: int = 0,
                 solver: str = 'dgsqp', params=None, scenario=None,
                 dtype=torch.float32, device='cuda'):
    """One F1-study configuration, batched, on ``device`` in ``dtype``: DGSQP v2 on the
    approximate game (``solver='dgsqp'``, ``params`` from :func:`f1_solver_params` by
    default) or the MCP oracle (``solver='path'``, its default parameters).  Returns the counts, the wall time
    of the solve, per-game ``statuses`` and ``iters``, ``u_sol`` and ``x0``."""
    from dgsqp_torch.solvers.dgsqp import CONV_ABS, CONV_REL, STATUS_MSG

    sc = scenario or build_f1_scenario(N=N)
    if solver == 'dgsqp':
        from dgsqp_torch.solvers.dgsqp_v2_frenet import DGSQPV2FrenetApprox
        slv = DGSQPV2FrenetApprox(sc.joint_model, sc.costs, sc.agent_constraints,
                                  sc.shared_constraints, sc.bounds,
                                  params or f1_solver_params(N), print_method=None,
                                  dtype=dtype, device=device)
        solve = lambda *a: slv.solve_batch_chunked(*a)
    elif solver == 'path':
        from dgsqp_torch.solvers.mcp import PATHMCPFrenetApprox
        from dgsqp_torch.solvers.solver_types import PATHMCPParams
        slv = PATHMCPFrenetApprox(sc.joint_model, sc.costs, sc.agent_constraints,
                                  sc.shared_constraints, sc.bounds,
                                  PATHMCPParams(N=N, dt=DT, tol=TOL),
                                  print_method=None, dtype=dtype, device=device)
        solve = lambda *a: slv.solve_batch(*a)
    else:
        raise ValueError(f'unknown solver {solver}')

    dtype, device = slv.dtype, slv.device
    x0_np, u_ws, _, _ = sample_f1_initial_conditions(sc, num_samples, seed=seed,
                                                     dtype=dtype, device=device)
    u_ws = torch.as_tensor(u_ws, dtype=dtype, device=device)
    u0 = slv.problem.stage_to_u(u_ws)
    x0 = torch.as_tensor(x0_np, dtype=dtype, device=device)
    up = torch.zeros(num_samples, sc.joint_model.n_u, dtype=dtype, device=device)
    up = seed_virtual_rate_prev(up, u_ws[:, 0, :], sc.joint_model)
    l0 = torch.zeros(num_samples, slv.n_c, dtype=dtype, device=device)

    sync = torch.cuda.synchronize if device.type == 'cuda' else (lambda: None)
    t0 = time.time()
    res = solve(u0, l0, x0, up)
    sync()
    wall = time.time() - t0
    statuses = res.status.cpu().numpy()
    iters = res.iters.cpu().numpy()
    conv = np.isin(statuses, (CONV_ABS, CONV_REL))
    return dict(total=num_samples, converged=int(conv.sum()),
                success_rate=float(conv.mean()), wall_time_s=wall,
                status_counts={STATUS_MSG.get(int(s), str(s)): int((statuses == s).sum())
                               for s in np.unique(statuses)},
                mean_iters=float(iters.mean()), max_iters=int(iters.max()),
                statuses=statuses, iters=iters,
                u_sol=res.u.cpu().numpy(), x0=x0.cpu().numpy())
