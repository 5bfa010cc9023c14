"""Benchmark scenario factories, ported from ``dgsqp_tpu/harness/scenarios.py``
(``Scenario``, ``build_racing_duel``, ``build_chicane_scenario``).

Costs and constraints are callables on tensors with any leading batch shape (the last
dimension holds the state or input), so the game evaluates a group of stages in one call.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dgsqp_torch.dynamics import (KinematicBicycleCombined, KinematicBicycleConfig,
                                  MultiAgentDynamicsModel, MultiAgentModelConfig)
from dgsqp_torch.tracks import ChicaneTrack
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
