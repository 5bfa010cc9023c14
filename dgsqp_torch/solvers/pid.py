"""PID controller and PID lane follower, ported from ``dgsqp_tpu/solvers/pid.py`` (host
numpy, as there): a scalar PID with anti-windup, rate and absolute saturation, optional
noise and periodic disturbance, and a lane follower combining a speed PID with a
steering PID acting on ``5*x_tran + 1*e_psi``.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np

from dgsqp_torch.solvers.solver_types import PIDParams
from dgsqp_torch.types import VehicleState


class PID:
    def __init__(self, params: PIDParams = None):
        params = params or PIDParams()
        self.dt = params.dt
        self.Kp, self.Ki, self.Kd = params.Kp, params.Ki, params.Kd
        self.int_e_max, self.int_e_min = params.int_e_max, params.int_e_min
        self.u_max, self.u_min = params.u_max, params.u_min
        self.du_max, self.du_min = params.du_max, params.du_min
        self.noise = params.noise
        self.noise_min, self.noise_max = params.noise_min, params.noise_max
        self.periodic_disturbance = params.periodic_disturbance
        self.disturbance_amplitude = params.disturbance_amplitude
        self.disturbance_period = params.disturbance_period
        self.x_ref = params.x_ref
        self.u_ref = params.u_ref
        self.u_prev = 0.0
        self.e = 0.0
        self.de = 0.0
        self.ei = 0.0
        self.t0 = time.time()
        self.initialized = True

    def initialize(self, x_ref: float = 0.0, u_ref: float = 0.0, de: float = 0.0,
                   ei: float = 0.0):
        self.de, self.ei = de, ei
        self.x_ref, self.u_ref = x_ref, u_ref
        self.u_prev = None
        self.initialized = True

    def solve(self, x: float, u_prev: Optional[float] = None) -> Tuple[float, dict]:
        if self.u_prev is None and u_prev is None:
            u_prev = 0.0
        elif u_prev is None:
            u_prev = self.u_prev

        e_t = x - self.x_ref
        de_t = (e_t - self.e) / self.dt
        ei_t = np.clip(self.ei + e_t * self.dt, self.int_e_min, self.int_e_max)

        u = -(self.Kp * e_t + self.Ki * ei_t + self.Kd * de_t) + self.u_ref
        if self.noise:
            u += np.random.uniform(self.noise_min, self.noise_max)
        if self.periodic_disturbance:
            t = time.time() - self.t0
            u += self.disturbance_amplitude * np.sin(2 * np.pi * t / self.disturbance_period)

        du = u - u_prev
        if self.du_max is not None:
            du = min(du, self.du_max)
        if self.du_min is not None:
            du = max(du, self.du_min)
        u = du + u_prev
        if self.u_max is not None:
            u = min(u, self.u_max)
        if self.u_min is not None:
            u = max(u, self.u_min)

        self.e, self.de, self.ei = e_t, de_t, ei_t
        self.u_prev = u
        return u, {'success': True}

    def set_x_ref(self, x_ref: float):
        self.x_ref = x_ref
        self.ei = 0.0
        self.e = 0.0

    def set_u_ref(self, u_ref: float):
        self.u_ref = u_ref

    def clear_errors(self):
        self.ei = 0.0
        self.de = 0.0


class PIDLaneFollower:
    """Speed PID + steering PID on the lane error ``5*x_tran + e_psi``."""

    def __init__(self, dt: float, steer_pid_params: PIDParams = None,
                 speed_pid_params: PIDParams = None):
        if steer_pid_params is None:
            steer_pid_params = PIDParams(dt=dt)
            steer_pid_params.default_steer_params()
        if speed_pid_params is None:
            speed_pid_params = PIDParams(dt=dt)
            speed_pid_params.default_speed_params()
        steer_pid_params.dt = dt
        speed_pid_params.dt = dt
        self.dt = dt
        self.steer_pid = PID(steer_pid_params)
        self.speed_pid = PID(speed_pid_params)
        self.lat_ref = steer_pid_params.x_ref
        self.steer_pid.set_x_ref(0.0)

    def initialize(self, **kwargs):
        pass

    def step(self, vehicle_state: VehicleState, env_state=None):
        v = vehicle_state.v.v_long
        vehicle_state.u.u_a, _ = self.speed_pid.solve(v)
        alpha, beta = 5.0, 1.0
        err = alpha * (vehicle_state.p.x_tran - self.lat_ref) + beta * vehicle_state.p.e_psi
        vehicle_state.u.u_steer, _ = self.steer_pid.solve(err)
