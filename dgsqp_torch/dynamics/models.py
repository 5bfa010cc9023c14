"""Vehicle dynamics models on tensors, ported from ``dgsqp_tpu/dynamics/models.py``.

This slice carries the ``DynamicsModel`` base (continuous ODE, euler/rk
discretisations, Jacobians by ``torch.func``) and the kinematic-bicycle-combined model
of the chicane duel.  ``fc``/``fd`` take ``q`` of shape (..., n_q) and ``u`` of shape
(..., n_u) with any matching leading batch shape, so one definition serves a single
game, an explicit batch and ``torch.func`` transforms alike.
"""
from __future__ import annotations

from abc import abstractmethod
from typing import Optional, Tuple

import numpy as np
import torch
from torch.func import jacfwd

from dgsqp_torch.dynamics.model_types import DynamicsConfig, KinematicBicycleConfig
from dgsqp_torch.types import VehicleState
from dgsqp_torch.utils.math import hard_abs, smooth_sign


class DynamicsModel:
    """Base dynamics model: continuous ODE + generic discretization + AD derivatives."""

    n_q: int
    n_u: int
    curvature_model: bool = False

    def __init__(self, t0: float, config: DynamicsConfig, track=None):
        if config.track_name is not None:
            raise NotImplementedError('loading saved tracks by name is not ported')
        if config.noise:
            raise NotImplementedError('process noise is not ported')
        self.t0 = t0
        self.model_config = config
        self.track = track
        self.dt = config.dt
        self.M = config.M
        self.h = self.dt / self.M

    @abstractmethod
    def fc(self, q, u):
        """Continuous-time dynamics dq/dt = fc(q, u)."""

    def fd(self, q, u, dt: Optional[float] = None):
        """One discrete step with the configured integrator."""
        dt = self.dt if dt is None else dt
        method = self.model_config.discretization_method
        if method == 'euler':
            return q + dt * self.fc(q, u)
        M, h = self.M, dt / self.M
        x = q
        for _ in range(M):
            if method == 'rk4':
                a1 = self.fc(x, u)
                a2 = self.fc(x + (h / 2) * a1, u)
                a3 = self.fc(x + (h / 2) * a2, u)
                a4 = self.fc(x + h * a3, u)
                x = x + h * (a1 + 2 * a2 + 2 * a3 + a4) / 6
            elif method == 'rk3':
                a1 = h * self.fc(x, u)
                a2 = h * self.fc(x + a1 / 2, u)
                a3 = h * self.fc(x - a1 + 2 * a2, u)
                x = x + (a1 + 4 * a2 + a3) / 6
            elif method == 'rk2':
                a1 = self.fc(x, u)
                a2 = self.fc(x + h * a1, u)
                x = x + h * (a1 + a2) / 2
            else:
                raise ValueError(f'Discretization method {method} not recognized')
        return x

    # single-instance Jacobians (vmap them for a batch)
    def fA(self, q, u):
        return jacfwd(self.fc, argnums=0)(q, u)

    def fB(self, q, u):
        return jacfwd(self.fc, argnums=1)(q, u)

    def fAd(self, q, u):
        return jacfwd(self.fd, argnums=0)(q, u)

    def fBd(self, q, u):
        return jacfwd(self.fd, argnums=1)(q, u)

    @abstractmethod
    def state2qu(self, state: VehicleState) -> Tuple[np.ndarray, np.ndarray]:
        ...

    def state2q(self, state: VehicleState) -> np.ndarray:
        return self.state2qu(state)[0]


class _KinematicBicycleBase(DynamicsModel):
    def __init__(self, t0, config: KinematicBicycleConfig = None, track=None):
        config = config or KinematicBicycleConfig()
        super().__init__(t0, config, track)
        self.L_f = config.wheel_dist_front
        self.L_r = config.wheel_dist_rear
        self.c_dr = config.drag_coefficient
        self.c_da = config.damping_coefficient
        self.c_s = config.slip_coefficient
        self.c_r = config.rolling_resistance
        self.p_r = config.rolling_resistance_exponent
        self.m = config.mass

    def beta(self, u_steer):
        """Sideslip angle from steering."""
        L = self.L_f + self.L_r
        return torch.atan2(torch.tan(u_steer) * self.L_r, torch.full_like(u_steer, L))

    def f_ext(self, v, psidot):
        """Drag / damping / rolling-resistance / slip force."""
        return (-self.c_da * v
                - self.c_dr * v * hard_abs(v)
                - self.c_r * hard_abs(v) ** self.p_r * smooth_sign(v)
                - self.c_s * psidot ** 2)


class KinematicBicycleCombined(_KinematicBicycleBase):
    """Global + Frenet kinematic bicycle: q=[x, y, v, epsi, s, xtran], u=[a, steer]."""

    n_q, n_u = 6, 2
    curvature_model = True

    def fc(self, q, u):
        x, y, v, epsi, s, xtran = q.unbind(-1)
        u_a, u_s = u.unbind(-1)
        beta = self.beta(u_s)
        psidot = v / self.L_r * torch.sin(beta)
        c = self.track.curvature(s)
        psi_t = self.track.tangent_angle(s)
        ds = v * torch.cos(beta + epsi) / (1 - xtran * c)
        return torch.stack([v * torch.cos(beta + psi_t + epsi),
                            v * torch.sin(beta + psi_t + epsi),
                            u_a + self.f_ext(v, psidot) / self.m,
                            psidot - c * ds,
                            ds,
                            v * torch.sin(beta + epsi)], dim=-1)

    def state2qu(self, state):
        return (np.array([state.x.x, state.x.y, state.v.v_long,
                          state.p.e_psi, state.p.s, state.p.x_tran]),
                np.array([state.u.u_a, state.u.u_steer]))
