"""Benchmark scenario factories, ported from ``dgsqp_tpu/harness/scenarios.py``
(``Scenario``, ``build_racing_duel``, ``build_chicane_scenario``,
``build_dynamic_duel``, ``build_dynamic_approximate_duel``, ``build_curve_scenario``,
``build_agents_scenario``, ``build_merge_scenario``, ``build_approximate_duel``,
``build_exact_duel``, ``joint_constraints_for_algames``).

Costs and constraints are callables on tensors with any leading batch shape (the last
dimension holds the state or input), so the game evaluates a group of stages in one call.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dgsqp_torch.dynamics import (DynamicBicycleCombined, DynamicBicycleConfig,
                                  KinematicBicycleCombined, KinematicBicycleConfig,
                                  KinematicUnicycle, MultiAgentDynamicsModel,
                                  MultiAgentModelConfig, UnicycleConfig)
from dgsqp_torch.tracks import ChicaneTrack, CurveTrack
from dgsqp_torch.types import (BodyAngularVelocity, BodyLinearVelocity, OrientationEuler,
                               ParametricPose, Position, VehicleActuation, VehicleState)


@dataclass
class Scenario:
    name: str
    track: object
    joint_model: MultiAgentDynamicsModel
    costs: list
    agent_constraints: list
    shared_constraints: object
    bounds: dict
    N: int
    dt: float
    obs_d: float
    half_width: float
    # per-agent input bounds for warm-start/PID use
    input_ub: np.ndarray
    input_lb: np.ndarray
    input_rate_ub: np.ndarray
    input_rate_lb: np.ndarray


def _vehicle_bound(half_width, u_a, u_steer):
    return VehicleState(
        x=Position(x=np.inf, y=np.inf),
        p=ParametricPose(s=np.inf, x_tran=half_width, e_psi=np.inf),
        e=OrientationEuler(psi=np.inf),
        v=BodyLinearVelocity(v_long=np.inf, v_tran=np.inf),
        w=BodyAngularVelocity(w_psi=np.inf),
        u=VehicleActuation(u_a=u_a, u_steer=u_steer))


def _neg(st: VehicleState) -> VehicleState:
    return VehicleState(
        x=Position(x=-st.x.x, y=-st.x.y),
        p=ParametricPose(s=-st.p.s, x_tran=-st.p.x_tran, e_psi=-st.p.e_psi),
        e=OrientationEuler(psi=-st.e.psi),
        v=BodyLinearVelocity(v_long=-st.v.v_long, v_tran=-st.v.v_tran),
        w=BodyAngularVelocity(w_psi=-st.w.w_psi),
        u=VehicleActuation(u_a=-st.u.u_a, u_steer=-st.u.u_steer))


def build_racing_duel(track, N: int = 25, dt: float = 0.1,
                      comp_weights=(10.0, 5.0), input_weight=(1.0, 1.0),
                      input_rate_weight=(1.0, 1.0), blocking_weight: float = 0.0,
                      obs_weight: float = 0.0, obs_r: float = 0.3,
                      agent_r: float = 0.4, half_width: float = 1.0,
                      u_a_max: float = 2.1, u_steer_max: float = 0.436,
                      u_a_rate: float = 10.0, u_steer_rate: float = np.pi,
                      comp_linear: bool = False, drag_coefficient: float = 0.1,
                      slip_coefficient: float = 0.1, rate_constraints: bool = True,
                      name: str = 'duel') -> Scenario:
    """Two kinematic-bicycle-combined agents racing on a track: quadratic input and
    input-rate stage cost, terminal progress + arctan competitive cost, per-agent
    input-rate constraints, shared collision avoidance for stages 1..N."""
    cfg = KinematicBicycleConfig(dt=dt, model_name='kinematic_bicycle_cl', noise=False,
                                 discretization_method='euler',
                                 wheel_dist_front=0.13, wheel_dist_rear=0.13,
                                 drag_coefficient=drag_coefficient,
                                 slip_coefficient=slip_coefficient, code_gen=False)
    ego = KinematicBicycleCombined(0.0, cfg, track=track)
    tar = KinematicBicycleCombined(0.0, KinematicBicycleConfig(**{**cfg.__dict__}), track=track)
    joint = MultiAgentDynamicsModel(0.0, [ego, tar], MultiAgentModelConfig(dt=dt))

    # joint-state indices (ego block then tar block, 6 states each)
    EGO_X, EGO_Y, EGO_S, EGO_EY = 0, 1, 4, 5
    TAR_X, TAR_Y, TAR_S, TAR_EY = 6, 7, 10, 11
    obs_cost_d = 2 * obs_r
    obs_d = 2 * agent_r

    def obs_penalty(x):
        dxy = x[..., EGO_X:EGO_Y + 1] - x[..., TAR_X:TAR_Y + 1]
        v = obs_cost_d - torch.sqrt(torch.sum(dxy ** 2, dim=-1) + 1e-12)
        sat = torch.maximum(torch.zeros_like(v), v)
        return 0.5 * obs_weight * sat ** 2

    def make_costs(own_s, other_s, own_ey, other_ey):
        w_in = input_weight
        w_rt = input_rate_weight

        def stage(x, u, um):
            c = 0.5 * (w_in[0] * u[..., 0] ** 2 + w_in[1] * u[..., 1] ** 2) \
                + 0.5 * (w_rt[0] * (u[..., 0] - um[..., 0]) ** 2
                         + w_rt[1] * (u[..., 1] - um[..., 1]) ** 2)
            if blocking_weight > 0:
                c = c + 0.5 * blocking_weight * (x[..., own_ey] - x[..., other_ey]) ** 2
            if obs_weight > 0:
                c = c + obs_penalty(x)
            return c

        def term(x):
            if comp_linear:
                c = -comp_weights[0] * x[..., own_s] \
                    + comp_weights[1] * (x[..., other_s] - x[..., own_s])
            else:
                c = -comp_weights[0] * x[..., own_s] \
                    + comp_weights[1] * torch.atan(x[..., other_s] - x[..., own_s])
            if blocking_weight > 0:
                c = c + 0.5 * blocking_weight * (x[..., own_ey] - x[..., other_ey]) ** 2
            if obs_weight > 0:
                c = c + obs_penalty(x)
            return c

        return (stage, term)

    costs = [make_costs(EGO_S, TAR_S, EGO_EY, TAR_EY),
             make_costs(TAR_S, EGO_S, TAR_EY, EGO_EY)]

    # per-agent input-rate constraints (4 rows per stage per agent)
    def rate_constr(x, u, um):
        du0 = u[..., 0] - um[..., 0]
        du1 = u[..., 1] - um[..., 1]
        return torch.stack([du0 - dt * u_a_rate,
                            dt * (-u_a_rate) - du0,
                            du1 - dt * u_steer_rate,
                            dt * (-u_steer_rate) - du1], dim=-1)

    if rate_constraints:
        agent_constraints = [[rate_constr] * N + [None], [rate_constr] * N + [None]]
    else:
        agent_constraints = [[None] * (N + 1), [None] * (N + 1)]

    # shared collision avoidance: (obs_d)^2 - ||p_ego - p_tar||^2 <= 0, stages 1..N
    def obs_avoid(x, u, um):
        dx = x[..., EGO_X] - x[..., TAR_X]
        dy = x[..., EGO_Y] - x[..., TAR_Y]
        return (obs_d ** 2 - (dx * dx + dy * dy))[..., None]

    def obs_avoid_term(x):
        dx = x[..., EGO_X] - x[..., TAR_X]
        dy = x[..., EGO_Y] - x[..., TAR_Y]
        return (obs_d ** 2 - (dx * dx + dy * dy))[..., None]

    shared_constraints = [None] + [obs_avoid] * (N - 1) + [obs_avoid_term]

    ub = _vehicle_bound(half_width, u_a_max, u_steer_max)
    lb = _neg(ub)
    bounds = {'ub': [ub, ub.copy()], 'lb': [lb, lb.copy()]}

    return Scenario(name=name, track=track, joint_model=joint, costs=costs,
                    agent_constraints=agent_constraints, shared_constraints=shared_constraints,
                    bounds=bounds, N=N, dt=dt, obs_d=obs_d, half_width=half_width,
                    input_ub=np.array([u_a_max, u_steer_max]),
                    input_lb=np.array([-u_a_max, -u_steer_max]),
                    input_rate_ub=np.array([u_a_rate, u_steer_rate]),
                    input_rate_lb=np.array([-u_a_rate, -u_steer_rate]))


def build_chicane_scenario(N: int = 25, theta_deg: float = 45.0, dt: float = 0.1,
                           half_width: float = 1.0, **kw) -> Scenario:
    """The two-agent chicane duel (N=25, theta=45 deg in the bench)."""
    track = ChicaneTrack(enter_straight_length=1, curve1_length=4,
                         curve1_swept_angle=theta_deg * np.pi / 180, mid_straight_length=1,
                         exit_straight_length=5, curve2_length=4,
                         curve2_swept_angle=theta_deg * np.pi / 180,
                         width=half_width * 2, slack=0.8, mirror=False)
    return build_racing_duel(track, N=N, dt=dt, half_width=half_width,
                             name=f'chicane_t{int(theta_deg)}_N{N}', **kw)


def _barc_dynamic_config(dt: float) -> DynamicBicycleConfig:
    """The BARC car of the dynamic studies: Pacejka tires, rk4 with 10 sub-steps."""
    return DynamicBicycleConfig(dt=dt, model_name='dynamic_bicycle', noise=False,
                                discretization_method='rk4', M=10, simple_slip=False,
                                tire_model='pacejka', mass=2.2187, yaw_inertia=0.02723,
                                wheel_friction=0.9, pacejka_b_front=5.0,
                                pacejka_b_rear=5.0, pacejka_c_front=2.28,
                                pacejka_c_rear=2.28)


def _dynamic_cost_weights(cost_setting: int, ds_weight=()):
    """(input weights, input-rate weights, competition weights) of a cost setting; the
    approximate game appends the virtual arc-speed channel's weight ``ds_weight``."""
    if cost_setting == 0:
        return (1.0, 1.0) + ds_weight, (1.0, 1.0) + ds_weight, (1.0, 5.0)
    if cost_setting == 1:
        return (1e-1, 1e-1) + ds_weight, (1e-1, 1e-1) + ds_weight, (0.0, 1.0)
    raise ValueError(f'unknown cost_setting {cost_setting}')


def _linear_race_costs(s_idx, input_weight, input_rate_weight, comp_weights):
    """Per-agent (stage, terminal) costs of the dynamic duels: quadratic input and
    input-rate stage costs over every input channel, linear terminal progress and
    competition ``-c0 s_own + c1 (s_other - s_own)`` (two agents)."""
    w, wr = input_weight, input_rate_weight

    def make_cost(own_s, other_s):
        def stage(x, u, um):
            c = 0.5 * sum(w[i] * u[..., i] ** 2 for i in range(len(w)))
            return c + 0.5 * sum(wr[i] * (u[..., i] - um[..., i]) ** 2 for i in range(len(wr)))

        def term(x):
            return -comp_weights[0] * x[..., own_s] \
                + comp_weights[1] * (x[..., other_s] - x[..., own_s])
        return (stage, term)
    return [make_cost(s_idx[0], s_idx[1]), make_cost(s_idx[1], s_idx[0])]


def _pair_collision(N: int, xy1, xy2, obs_d: float):
    """Shared collision avoidance ``obs_d^2 - |p1 - p2|^2 <= 0`` at stages 1..N."""
    def obs_avoid(x, u, um):
        dx = x[..., xy1[0]] - x[..., xy2[0]]
        dy = x[..., xy1[1]] - x[..., xy2[1]]
        return (obs_d ** 2 - (dx * dx + dy * dy))[..., None]

    def obs_avoid_term(x):
        dx = x[..., xy1[0]] - x[..., xy2[0]]
        dy = x[..., xy1[1]] - x[..., xy2[1]]
        return (obs_d ** 2 - (dx * dx + dy * dy))[..., None]

    return [None] + [obs_avoid] * (N - 1) + [obs_avoid_term]


def _rate_rows(dt: float, rates):
    """A progress-augmented agent's input-rate rows ``|u_i - um_i| <= dt rate_i`` over
    its three channels, two rows a channel."""
    def rate_constr(x, u, um):
        du = u - um
        rows = []
        for i, r in enumerate(rates):
            rows += [du[..., i] - dt * r, -dt * r - du[..., i]]
        return torch.stack(rows, dim=-1)
    return rate_constr


def _pa_bound(sign, u_a_max, u_steer_max, u_ds_max):
    """An unbounded progress-augmented state with the input box (u_ds >= 0)."""
    return VehicleState(
        x=Position(x=sign * np.inf, y=sign * np.inf),
        p=ParametricPose(s=sign * np.inf, x_tran=sign * np.inf, e_psi=sign * np.inf),
        e=OrientationEuler(psi=sign * np.inf),
        v=BodyLinearVelocity(v_long=sign * np.inf, v_tran=sign * np.inf),
        w=BodyAngularVelocity(w_psi=sign * np.inf),
        u=VehicleActuation(u_a=sign * u_a_max, u_steer=sign * u_steer_max,
                           u_ds=u_ds_max if sign > 0 else 0.0))


def build_dynamic_duel(N: int = 25, dt: float = 0.1, cost_setting: int = 0,
                       track_name: str = 'L_track_barc',
                       car_r: float = 0.23) -> Scenario:
    """Two dynamic-bicycle (Pacejka) agents in the exact game on ``L_track_barc``: the
    BARC car (rk4, 10 sub-steps), quadratic input and input-rate stage costs, linear
    terminal progress and competition, no per-agent constraints, shared collision
    avoidance at stages 1..N.  Bounds |u_a| <= 2.1, |u_steer| <= 0.436, |x_tran| <=
    the track's half-width."""
    from dgsqp_torch.tracks.track_lib import get_track
    track = get_track(track_name)
    H = float(track.half_width)
    input_weight, input_rate_weight, comp_weights = _dynamic_cost_weights(cost_setting)

    cfg = _barc_dynamic_config(dt)
    car1 = DynamicBicycleCombined(0.0, cfg, track=track)
    car2 = DynamicBicycleCombined(0.0, DynamicBicycleConfig(**{**cfg.__dict__}), track=track)
    joint = MultiAgentDynamicsModel(0.0, [car1, car2], MultiAgentModelConfig(dt=dt))

    # joint-state indices (8 states per car: x y vx vy psidot epsi s xtran)
    obs_d = 2 * car_r
    costs = _linear_race_costs((6, 14), input_weight, input_rate_weight, comp_weights)
    shared_constraints = _pair_collision(N, (0, 1), (8, 9), obs_d)
    agent_constraints = [[None] * (N + 1), [None] * (N + 1)]

    u_a_max, u_steer_max = 2.1, 0.436
    ub = _vehicle_bound(H, u_a_max, u_steer_max)
    lb = _neg(ub)
    bounds = {'ub': [ub, ub.copy()], 'lb': [lb, lb.copy()]}

    return Scenario(name=f'dynamic_duel_N{N}_c{cost_setting}', track=track,
                    joint_model=joint, costs=costs, agent_constraints=agent_constraints,
                    shared_constraints=shared_constraints, bounds=bounds, N=N, dt=dt,
                    obs_d=obs_d, half_width=H,
                    input_ub=np.array([u_a_max, u_steer_max]),
                    input_lb=np.array([-u_a_max, -u_steer_max]),
                    input_rate_ub=np.array([10.0, 4.5]),
                    input_rate_lb=np.array([-10.0, -4.5]))


def build_dynamic_approximate_duel(N: int = 25, dt: float = 0.1, cost_setting: int = 0,
                                   track_name: str = 'L_track_barc',
                                   car_r: float = 0.23,
                                   rate_constraints: bool = True) -> Scenario:
    """The approximate (MPCC) counterpart of :func:`build_dynamic_duel`: two
    progress-augmented dynamic bicycles on ``L_track_barc`` with quadratic input and
    input-rate stage costs (the virtual arc-speed channel at weight 1e-4), linear
    terminal progress and competition on the progress states and shared collision
    avoidance on the global positions; ``DGSQPV2FrenetApprox`` adds the contouring/lag
    costs and the track-boundary rows.  ``rate_constraints=True`` adds the input-rate
    rows as a per-stage trust region; ``False`` is the reference study's configuration
    (it builds them but passes none)."""
    from dgsqp_torch.dynamics.progress_augmented import DynamicBicycleProgressAugmented
    from dgsqp_torch.tracks.track_lib import get_track
    track = get_track(track_name)
    H = float(track.half_width)
    input_weight, input_rate_weight, comp_weights = _dynamic_cost_weights(cost_setting,
                                                                          (1e-4,))

    cfg = _barc_dynamic_config(dt)
    car1 = DynamicBicycleProgressAugmented(0.0, cfg, track=track)
    car2 = DynamicBicycleProgressAugmented(
        0.0, DynamicBicycleConfig(**{**cfg.__dict__}), track=track)
    joint = MultiAgentDynamicsModel(0.0, [car1, car2], MultiAgentModelConfig(dt=dt))

    # per-car PA layout [vx, vy, psidot, x, y, psi, s]
    obs_d = 2 * car_r
    costs = _linear_race_costs((6, 13), input_weight, input_rate_weight, comp_weights)
    shared_constraints = _pair_collision(N, (3, 4), (10, 11), obs_d)

    rates = (10.0, 4.5, 5.0)
    if rate_constraints:
        rate_constr = _rate_rows(dt, rates)
        agent_constraints = [[rate_constr] * N + [None], [rate_constr] * N + [None]]
    else:
        agent_constraints = [[None] * (N + 1), [None] * (N + 1)]

    u_a_max, u_steer_max, u_ds_max = 2.1, 0.436, 4.0
    bounds = {'ub': [_pa_bound(1, u_a_max, u_steer_max, u_ds_max)] * 2,
              'lb': [_pa_bound(-1, u_a_max, u_steer_max, u_ds_max)] * 2}

    return Scenario(name=f'dynamic_approx_duel_N{N}_c{cost_setting}', track=track,
                    joint_model=joint, costs=costs, agent_constraints=agent_constraints,
                    shared_constraints=shared_constraints, bounds=bounds, N=N, dt=dt,
                    obs_d=obs_d, half_width=H,
                    input_ub=np.array([u_a_max, u_steer_max, u_ds_max]),
                    input_lb=np.array([-u_a_max, -u_steer_max, 0.0]),
                    input_rate_ub=np.array(rates), input_rate_lb=-np.array(rates))


def build_curve_scenario(N: int = 25, theta_deg: float = 90.0, dt: float = 0.1,
                         half_width: float = 1.0, **kw) -> Scenario:
    """The two-agent duel on a curved track."""
    track = CurveTrack(enter_straight_length=1, curve_length=8,
                       curve_swept_angle=theta_deg * np.pi / 180, exit_straight_length=5,
                       width=half_width * 2, slack=0.8, ccw=True)
    return build_racing_duel(track, N=N, dt=dt, half_width=half_width,
                             name=f'curve_t{int(theta_deg)}_N{N}', **kw)


def build_agents_scenario(M: int = 3, N: int = 25, theta_deg: float = 90.0,
                          dt: float = 0.1, half_width: float = 1.0,
                          comp_weights=(10.0, 5.0), obs_r: float = 0.4,
                          u_a_max: float = 2.1, u_steer_max: float = 0.436,
                          u_a_rate: float = 10.0, u_steer_rate: float = np.pi) -> Scenario:
    """Agent-count scaling study: M kinematic-bicycle-combined agents on a curved track.

    Per-agent terminal cost: own progress + arctan competitive terms against every other
    agent; shared constraints: pairwise collision avoidance with radius ``obs_r`` each.
    """
    track = CurveTrack(enter_straight_length=1, curve_length=8,
                       curve_swept_angle=theta_deg * np.pi / 180, exit_straight_length=5,
                       width=half_width * 2, slack=0.8, ccw=True)
    cfg = KinematicBicycleConfig(dt=dt, model_name='kinematic_bicycle_cl', noise=False,
                                 discretization_method='euler',
                                 wheel_dist_front=0.13, wheel_dist_rear=0.13,
                                 drag_coefficient=0.1, slip_coefficient=0.1)
    models = [KinematicBicycleCombined(0.0, KinematicBicycleConfig(**{**cfg.__dict__}),
                                       track=track) for _ in range(M)]
    joint = MultiAgentDynamicsModel(0.0, models, MultiAgentModelConfig(dt=dt))

    n_qa = 6
    s_idx = [4 + n_qa * a for a in range(M)]

    def make_cost(a):
        def stage(x, u, um):
            return 0.5 * (u[..., 0] ** 2 + u[..., 1] ** 2) \
                + 0.5 * ((u[..., 0] - um[..., 0]) ** 2 + (u[..., 1] - um[..., 1]) ** 2)

        def term(x):
            c = -comp_weights[0] * x[..., s_idx[a]]
            for b in range(M):
                if b != a:
                    c = c + comp_weights[1] * torch.atan(x[..., s_idx[b]] - x[..., s_idx[a]])
            return c
        return (stage, term)

    costs = [make_cost(a) for a in range(M)]

    def rate_constr(x, u, um):
        du0 = u[..., 0] - um[..., 0]
        du1 = u[..., 1] - um[..., 1]
        return torch.stack([du0 - dt * u_a_rate,
                            dt * (-u_a_rate) - du0,
                            du1 - dt * u_steer_rate,
                            dt * (-u_steer_rate) - du1], dim=-1)

    agent_constraints = [[rate_constr] * N + [None] for _ in range(M)]

    obs_d = 2 * obs_r

    def obs_avoid(x):
        rows = []
        for i in range(M):
            for j in range(i + 1, M):
                dxy = x[..., n_qa * i:n_qa * i + 2] - x[..., n_qa * j:n_qa * j + 2]
                rows.append(obs_d ** 2 - torch.sum(dxy * dxy, dim=-1))
        return torch.stack(rows, dim=-1)

    obs_avoid_stage = lambda x, u, um: obs_avoid(x)
    shared_constraints = [None] + [obs_avoid_stage] * (N - 1) + [lambda x: obs_avoid(x)]

    ub = _vehicle_bound(half_width, u_a_max, u_steer_max)
    bounds = {'ub': [ub.copy() for _ in range(M)],
              'lb': [_neg(ub) for _ in range(M)]}

    return Scenario(name=f'agents_M{M}_t{int(theta_deg)}_N{N}', track=track,
                    joint_model=joint, costs=costs, agent_constraints=agent_constraints,
                    shared_constraints=shared_constraints, bounds=bounds, N=N, dt=dt,
                    obs_d=obs_d, half_width=half_width,
                    input_ub=np.array([u_a_max, u_steer_max]),
                    input_lb=np.array([-u_a_max, -u_steer_max]),
                    input_rate_ub=np.array([u_a_rate, u_steer_rate]),
                    input_rate_lb=np.array([-u_a_rate, -u_steer_rate]))


def build_merge_scenario(N: int = 20, dt: float = 0.1) -> Scenario:
    """Three-unicycle highway merge in a hand-built polygonal environment.

    Cars 1-2 drive the straight lane, car 3 enters on a ramp; per-agent lane half-plane
    constraints (piecewise normals on the ramp), pairwise collision avoidance shared
    constraints, quadratic goal-tracking costs.  ``merge_geometry`` holds the lane
    geometry and goals the merge sampler reads.
    """
    ll, lw, mw, mp = 5.0, 0.3, 0.3, 1.5
    th = np.pi / 12
    r = 0.1

    ns = np.array([0.0, 1.0])
    nm = np.array([-np.sin(th), np.cos(th)])
    x1 = np.array([0.0, lw])
    x3 = np.array([0.0, 0.0])
    x5 = np.array([mp, 0.0])
    x6 = np.array([mp + lw / np.tan(th), lw])
    x7 = np.array([mp + mw / np.sin(th), 0.0])

    goals = [np.array([4.0, 0.15, 0.3, 0.0]),
             np.array([4.5, 0.15, 0.3, 0.0]),
             np.array([4.25, 0.15, 0.3, 0.0])]

    models = [KinematicUnicycle(0.0, UnicycleConfig(dt=dt, discretization_method='rk3', M=1))
              for _ in range(3)]
    joint = MultiAgentDynamicsModel(0.0, models, MultiAgentModelConfig(dt=dt))

    n_qa = 4
    W = (1.0, 10.0, 1.0, 1.0)   # the diagonal of the goal-tracking weight

    def make_cost(a):
        goal = [float(v) for v in goals[a]]

        def tracking(x):
            return sum(W[i] * (x[..., n_qa * a + i] - goal[i]) ** 2 for i in range(n_qa))

        def stage(x, u, um):
            return 0.5 * 0.1 * (u[..., 0] ** 2 + u[..., 1] ** 2) + 0.5 * tracking(x)

        def term(x):
            return 10.0 * 0.5 * tracking(x)
        return (stage, term)

    costs = [make_cost(a) for a in range(3)]

    def straight_lane(px, py):
        return torch.stack([py - (lw - r),     # below left boundary (shifted in by r)
                            r - py], dim=-1)   # above right boundary

    (m0, m1), (s0, s1) = nm.tolist(), ns.tolist()
    (l0, l1), (r0, r1) = x6.tolist(), x7.tolist()

    def ramp_lane(px, py):
        # the normal of each boundary switches from the ramp's to the lane's at its
        # corner; at the corner itself the lane's, as the JAX package's jnp.where picks
        dl, dr = (px - l0, py - l1), (px - r0, py - r1)
        c_l = torch.where(px < l0, m0 * dl[0] + m1 * dl[1], s0 * dl[0] + s1 * dl[1]) + r
        c_r = torch.where(px < r0, -m0 * dr[0] - m1 * dr[1], -s0 * dr[0] - s1 * dr[1]) + r
        return torch.stack([c_l, c_r], dim=-1)

    def make_lane(a):
        lane = ramp_lane if a == 2 else straight_lane

        def stage(x, u, um):
            return lane(x[..., n_qa * a], x[..., n_qa * a + 1])

        def term(x):
            return lane(x[..., n_qa * a], x[..., n_qa * a + 1])
        return [stage] * N + [term]

    agent_constraints = [make_lane(a) for a in range(3)]

    agent_r = 0.1
    obs_d = 2 * agent_r

    def obs_avoid(x):
        rows = []
        for i in range(3):
            for j in range(i + 1, 3):
                dxy = x[..., n_qa * i:n_qa * i + 2] - x[..., n_qa * j:n_qa * j + 2]
                rows.append(obs_d ** 2 - torch.sum(dxy * dxy, dim=-1))
        return torch.stack(rows, dim=-1)

    obs_avoid_stage = lambda x, u, um: obs_avoid(x)
    shared_constraints = [None] + [obs_avoid_stage] * (N - 1) + [lambda x: obs_avoid(x)]

    def bound(sign):
        return VehicleState(
            x=Position(x=sign * np.inf, y=sign * np.inf),
            p=ParametricPose(s=sign * np.inf, x_tran=sign * np.inf, e_psi=sign * np.inf),
            e=OrientationEuler(psi=sign * np.inf),
            v=BodyLinearVelocity(v_long=sign * 2.0, v_tran=sign * np.inf),
            w=BodyAngularVelocity(w_psi=sign * np.inf),
            u=VehicleActuation(u_a=sign * 2.0, u_steer=sign * 4.5))

    bounds = {'ub': [bound(1) for _ in range(3)], 'lb': [bound(-1) for _ in range(3)]}

    sc = Scenario(name=f'merge_N{N}', track=None, joint_model=joint, costs=costs,
                  agent_constraints=agent_constraints, shared_constraints=shared_constraints,
                  bounds=bounds, N=N, dt=dt, obs_d=obs_d, half_width=lw / 2,
                  input_ub=np.array([2.0, 4.5]), input_lb=np.array([-2.0, -4.5]),
                  input_rate_ub=np.array([np.inf, np.inf]),
                  input_rate_lb=np.array([-np.inf, -np.inf]))
    sc.merge_geometry = dict(ll=ll, lw=lw, mw=mw, mp=mp, th=th, r=r,
                             x1=x1, x3=x3, x5=x5, x6=x6, x7=x7, goals=goals)
    return sc


def _default_duel_track(half_width: float):
    return ChicaneTrack(enter_straight_length=1, curve1_length=4,
                        curve1_swept_angle=np.pi / 4, mid_straight_length=1,
                        exit_straight_length=5, curve2_length=4,
                        curve2_swept_angle=np.pi / 4, width=half_width * 2,
                        slack=0.8, mirror=False)


def build_approximate_duel(track=None, N: int = 25, dt: float = 0.1,
                           comp_weights=(1.0, 5.0), input_weight=(1.0, 1.0, 1e-4),
                           input_rate_weight=(1.0, 1.0, 1e-4), agent_r: float = 0.21,
                           u_a_max: float = 2.1, u_steer_max: float = 0.436,
                           u_ds_max: float = 4.0, u_a_rate: float = 10.0,
                           u_steer_rate: float = 4.5, u_ds_rate: float = 5.0,
                           half_width: float = 1.0, rate_constraints: bool = True,
                           name: str = 'approx_duel') -> Scenario:
    """Approximate (MPCC) racing duel on progress-augmented kinematic bicycles.

    Quadratic input and input-rate stage costs (the virtual arc-speed channel
    included), linear progress + competitive terminal costs on the progress states,
    shared collision avoidance.  The contouring/lag costs and the track-boundary
    constraints are added by ``DGSQPV2FrenetApprox``.

    The input-rate rows (``rate_constraints=True``) act as a per-stage trust region
    that keeps the linearisation point honest; the reference study builds them but
    passes none (``rate_constraints=False``).  With the rows, the virtual channel's
    previous input must be seeded with the car's initial progress rate
    (``seed_virtual_rate_prev``), else the first row caps u_ds(0) at dt * u_ds_rate.
    """
    from dgsqp_torch.dynamics.progress_augmented import KinematicBicycleProgressAugmented
    if track is None:
        track = _default_duel_track(half_width)
    cfg = KinematicBicycleConfig(dt=dt, model_name='kinematic_bicycle', noise=False,
                                 discretization_method='euler',
                                 wheel_dist_front=0.13, wheel_dist_rear=0.13)
    car1 = KinematicBicycleProgressAugmented(0.0, cfg, track=track)
    car2 = KinematicBicycleProgressAugmented(
        0.0, KinematicBicycleConfig(**{**cfg.__dict__}), track=track)
    joint = MultiAgentDynamicsModel(0.0, [car1, car2], MultiAgentModelConfig(dt=dt))

    # joint indices: agent blocks of 5 states [x, y, v, psi, s]
    obs_d = 2 * agent_r
    costs = _linear_race_costs((4, 9), input_weight, input_rate_weight, comp_weights)
    shared_constraints = _pair_collision(N, (0, 1), (5, 6), obs_d)
    rates = (u_a_rate, u_steer_rate, u_ds_rate)
    if rate_constraints:
        rate_constr = _rate_rows(dt, rates)
        agent_constraints = [[rate_constr] * N + [None], [rate_constr] * N + [None]]
    else:
        agent_constraints = [[None] * (N + 1), [None] * (N + 1)]
    bounds = {'ub': [_pa_bound(1, u_a_max, u_steer_max, u_ds_max)] * 2,
              'lb': [_pa_bound(-1, u_a_max, u_steer_max, u_ds_max)] * 2}

    return Scenario(name=name, track=track, joint_model=joint, costs=costs,
                    agent_constraints=agent_constraints,
                    shared_constraints=shared_constraints, bounds=bounds, N=N, dt=dt,
                    obs_d=obs_d, half_width=half_width,
                    input_ub=np.array([u_a_max, u_steer_max, u_ds_max]),
                    input_lb=np.array([-u_a_max, -u_steer_max, 0.0]),
                    input_rate_ub=np.array(rates),
                    input_rate_lb=-np.array(rates))


def build_exact_duel(track=None, N: int = 25, dt: float = 0.1,
                     comp_weights=(1.0, 5.0), agent_r: float = 0.21,
                     half_width: float = 1.0, name: str = 'exact_duel') -> Scenario:
    """The exact formulation of the game of :func:`build_approximate_duel`, on the same
    track with the same costs: kinematic-bicycle-combined agents, linear terminal
    progress/competition, the same collision radius and input-rate rows on the real
    channels, the track kept by the |x_tran| <= half-width state bound, and no drag or
    slip (the progress-augmented plant has none)."""
    if track is None:
        track = _default_duel_track(half_width)
    return build_racing_duel(track, N=N, dt=dt, comp_weights=comp_weights,
                             input_weight=(1.0, 1.0), input_rate_weight=(1.0, 1.0),
                             agent_r=agent_r, half_width=half_width,
                             u_a_rate=10.0, u_steer_rate=4.5, comp_linear=True,
                             drag_coefficient=0.0, slip_coefficient=0.0,
                             rate_constraints=True, name=name)


def joint_constraints_for_algames(scenario):
    """Concatenate per-agent and shared constraints into the joint stage lists ALGAMES
    consumes: each stage's agent rows in agent order, then the shared rows."""
    M = scenario.joint_model.n_a
    offs = scenario.joint_model.u_offsets
    N = scenario.N
    shared = scenario.shared_constraints or [None] * (N + 1)

    def make_stage(k):
        fns = [(a, scenario.agent_constraints[a][k]) for a in range(M)
               if scenario.agent_constraints[a] is not None
               and scenario.agent_constraints[a][k] is not None]
        sh = shared[k]
        if not fns and sh is None:
            return None

        # a plain closure of three arguments: more would read as a P-parameterised one
        def stage(x, u, um):
            parts = [fn(x, u[..., offs[a]:offs[a + 1]], um[..., offs[a]:offs[a + 1]])
                     for a, fn in fns]
            if sh is not None:
                parts.append(sh(x, u, um))
            return torch.cat(parts, dim=-1)
        return stage

    def make_term():
        fns = [scenario.agent_constraints[a][N] for a in range(M)
               if scenario.agent_constraints[a] is not None
               and scenario.agent_constraints[a][N] is not None]
        sh = shared[N]
        if not fns and sh is None:
            return None

        def term(x):
            parts = [fn(x) for fn in fns]
            if sh is not None:
                parts.append(sh(x))
            return torch.cat(parts, dim=-1)
        return term

    # stages with the same parts share one closure, so that they evaluate as one group
    cache = {}

    def stage_for(k):
        key = (tuple(id(scenario.agent_constraints[a][k])
                     if scenario.agent_constraints[a] is not None else None
                     for a in range(M)), id(shared[k]))
        if key not in cache:
            cache[key] = make_stage(k)
        return cache[key]

    return [stage_for(k) for k in range(N)] + [make_term()]
