"""Vehicle dynamics models on tensors, ported from ``dgsqp_tpu/dynamics/models.py``.

It carries the ``DynamicsModel`` base (continuous ODE, euler/rk discretisations,
Jacobians and Hessians by ``torch.func``, the host-side marshalling hooks), the single
integrator, the kinematic unicycles (global, Frenet and combined frames; the merge
scenario's cars) and the kinematic bicycles (global, Frenet, velocity-input Frenet and
combined; the racing scenarios'), and the string-keyed ``get_dynamics_model``.
``fc``/``fd`` take ``q`` of shape (..., n_q) and ``u`` of shape (..., n_u) with any
matching leading batch shape, so one definition serves a single game, an explicit batch
and ``torch.func`` transforms alike.
"""
from __future__ import annotations

from abc import abstractmethod
from typing import Optional, Tuple

import numpy as np
import torch
from torch.func import jacfwd

from dgsqp_torch.dynamics.model_types import (DynamicsConfig, KinematicBicycleConfig,
                                              UnicycleConfig)
from dgsqp_torch.types import VehiclePrediction, VehicleState
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

    # per-state-dimension discrete Hessians: Ed[i] = d2 fd_i/dq2, Fd[i] = d2 fd_i/du2,
    # Gd[i] = d2 fd_i/(du dq)
    def fEd(self, q, u):
        return jacfwd(jacfwd(self.fd, argnums=0), argnums=0)(q, u)

    def fFd(self, q, u):
        return jacfwd(jacfwd(self.fd, argnums=1), argnums=1)(q, u)

    def fGd(self, q, u):
        return jacfwd(jacfwd(self.fd, argnums=1), argnums=0)(q, u)

    @abstractmethod
    def state2qu(self, state: VehicleState) -> Tuple[np.ndarray, np.ndarray]:
        ...

    def state2q(self, state: VehicleState) -> np.ndarray:
        return self.state2qu(state)[0]

    @abstractmethod
    def qu2state(self, state: VehicleState, q: Optional[np.ndarray] = None,
                 u: Optional[np.ndarray] = None):
        ...

    def qu2prediction(self, prediction: Optional[VehiclePrediction],
                      q: Optional[np.ndarray] = None, u: Optional[np.ndarray] = None):
        if prediction is None:
            prediction = VehiclePrediction()
        if q is not None:
            for name, col in self._pred_q_fields():
                setattr(prediction, name, np.asarray(q[:, col]))
        if u is not None:
            prediction.u_a = np.asarray(u[:, 0])
            if self.n_u > 1:
                prediction.u_steer = np.asarray(u[:, 1])
            if self.n_u > 2:
                prediction.u_ds = np.asarray(u[:, 2])
        return prediction

    def _pred_q_fields(self):
        """(prediction field name, q column) pairs; overridden per model."""
        return []


class IntegratorModel(DynamicsModel):
    """Single integrator: q=[v], u=[a]."""

    n_q, n_u = 1, 1

    def fc(self, q, u):
        return u[..., 0:1]

    def state2qu(self, state):
        return np.array([state.v.v_long]), np.array([state.u.u_a])

    def qu2state(self, state, q=None, u=None):
        if q is not None:
            state.v.v_long = float(q[0])
        if u is not None:
            state.u.u_a = float(u[0])

    def _pred_q_fields(self):
        return [('v_long', 0)]


class KinematicUnicycle(DynamicsModel):
    """Global-frame kinematic unicycle: q=[x, y, v, psi], u=[Fx, wz]."""

    n_q, n_u = 4, 2

    def __init__(self, t0, config: UnicycleConfig = None, track=None):
        config = config or UnicycleConfig()
        super().__init__(t0, config, track)
        self.m = config.mass

    def fc(self, q, u):
        x, y, v, psi = q.unbind(-1)
        Fx, wz = u.unbind(-1)
        return torch.stack([v * torch.cos(psi), v * torch.sin(psi), Fx / self.m, wz], dim=-1)

    def state2qu(self, state):
        return (np.array([state.x.x, state.x.y, state.v.v_long, state.e.psi]),
                np.array([state.u.u_a, state.u.u_steer]))

    def qu2state(self, state, q=None, u=None):
        if q is not None:
            state.x.x, state.x.y = float(q[0]), float(q[1])
            state.v.v_long, state.e.psi = float(q[2]), float(q[3])
        if u is not None:
            state.u.u_a, state.u.u_steer = float(u[0]), float(u[1])

    def _pred_q_fields(self):
        return [('x', 0), ('y', 1), ('v_long', 2), ('psi', 3)]


class KinematicClUnicycle(DynamicsModel):
    """Frenet-frame unicycle: q=[v, epsi, s, xtran], u=[ax, wz]."""

    n_q, n_u = 4, 2
    curvature_model = True

    def __init__(self, t0, config: UnicycleConfig = None, track=None):
        config = config or UnicycleConfig()
        super().__init__(t0, config, track)
        self.m = config.mass
        self.c_da = config.damping_coefficient

    def fc(self, q, u):
        v, epsi, s, xtran = q.unbind(-1)
        ax, wz = u.unbind(-1)
        c = self.track.curvature(s)
        ds = v * torch.cos(epsi) / (1 - xtran * c)
        return torch.stack([ax - self.c_da * v / self.m,
                            wz - c * ds,
                            ds,
                            v * torch.sin(epsi)], dim=-1)

    def state2qu(self, state):
        return (np.array([state.v.v_long, state.p.e_psi, state.p.s, state.p.x_tran]),
                np.array([state.u.u_a, state.u.u_steer]))

    def qu2state(self, state, q=None, u=None):
        if q is not None:
            state.v.v_long, state.p.e_psi = float(q[0]), float(q[1])
            state.p.s, state.p.x_tran = float(q[2]), float(q[3])
        if u is not None:
            state.u.u_a, state.u.u_steer = float(u[0]), float(u[1])

    def _pred_q_fields(self):
        return [('v_long', 0), ('e_psi', 1), ('s', 2), ('x_tran', 3)]


class KinematicUnicycleCombined(DynamicsModel):
    """Global + Frenet unicycle: q=[x, y, v, epsi, s, xtran], u=[Fx, wz]."""

    n_q, n_u = 6, 2
    curvature_model = True

    def __init__(self, t0, config: UnicycleConfig = None, track=None):
        config = config or UnicycleConfig()
        super().__init__(t0, config, track)
        self.m = config.mass
        self.c_da = config.damping_coefficient

    def fc(self, q, u):
        x, y, v, epsi, s, xtran = q.unbind(-1)
        Fx, wz = u.unbind(-1)
        c = self.track.curvature(s)
        psi_t = self.track.tangent_angle(s)
        ds = v * torch.cos(epsi) / (1 - xtran * c)
        return torch.stack([v * torch.cos(psi_t + epsi),
                            v * torch.sin(psi_t + epsi),
                            (Fx - self.c_da * v) / self.m,
                            wz - c * ds,
                            ds,
                            v * torch.sin(epsi)], dim=-1)

    def state2qu(self, state):
        return (np.array([state.x.x, state.x.y, state.v.v_long,
                          state.p.e_psi, state.p.s, state.p.x_tran]),
                np.array([state.u.u_a, state.u.u_steer]))

    def qu2state(self, state, q=None, u=None):
        if q is not None:
            state.x.x, state.x.y, state.v.v_long = float(q[0]), float(q[1]), float(q[2])
            state.p.e_psi, state.p.s, state.p.x_tran = float(q[3]), float(q[4]), float(q[5])
        if u is not None:
            state.u.u_a, state.u.u_steer = float(u[0]), float(u[1])

    def _pred_q_fields(self):
        return [('x', 0), ('y', 1), ('v_long', 2), ('e_psi', 3), ('s', 4), ('x_tran', 5)]


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


class KinematicBicycle(_KinematicBicycleBase):
    """Global-frame kinematic bicycle: q=[x, y, v, psi], u=[a, steer]."""

    n_q, n_u = 4, 2

    def fc(self, q, u):
        x, y, v, psi = q.unbind(-1)
        u_a, u_s = u.unbind(-1)
        beta = self.beta(u_s)
        psidot = v / self.L_r * torch.sin(beta)
        dv = u_a + self.f_ext(v, psidot) / self.m
        return torch.stack([v * torch.cos(beta + psi), v * torch.sin(beta + psi), dv, psidot],
                           dim=-1)

    def state2qu(self, state):
        return (np.array([state.x.x, state.x.y, state.v.v_long, state.e.psi]),
                np.array([state.u.u_a, state.u.u_steer]))

    def qu2state(self, state, q=None, u=None):
        if q is not None:
            state.x.x, state.x.y = float(q[0]), float(q[1])
            state.v.v_long, state.e.psi = float(q[2]), float(q[3])
        if u is not None:
            state.u.u_a, state.u.u_steer = float(u[0]), float(u[1])

    def _pred_q_fields(self):
        return [('x', 0), ('y', 1), ('v_long', 2), ('psi', 3)]


class KinematicCLBicycle(_KinematicBicycleBase):
    """Frenet-frame kinematic bicycle: q=[v, epsi, s, xtran], u=[a, steer]."""

    n_q, n_u = 4, 2
    curvature_model = True

    def fc(self, q, u):
        v, epsi, s, xtran = q.unbind(-1)
        u_a, u_s = u.unbind(-1)
        beta = self.beta(u_s)
        psidot = v * torch.sin(beta) / self.L_r
        c = self.track.curvature(s)
        ds = v * torch.cos(beta + epsi) / (1 - xtran * c)
        return torch.stack([u_a + self.f_ext(v, psidot) / self.m,
                            psidot - c * ds,
                            ds,
                            v * torch.sin(beta + epsi)], dim=-1)

    def state2qu(self, state):
        return (np.array([state.v.v_long, state.p.e_psi, state.p.s, state.p.x_tran]),
                np.array([state.u.u_a, state.u.u_steer]))

    def qu2state(self, state, q=None, u=None):
        if q is not None:
            state.v.v_long, state.p.e_psi = float(q[0]), float(q[1])
            state.p.s, state.p.x_tran = float(q[2]), float(q[3])
        if u is not None:
            state.u.u_a, state.u.u_steer = float(u[0]), float(u[1])

    def _pred_q_fields(self):
        return [('v_long', 0), ('e_psi', 1), ('s', 2), ('x_tran', 3)]


class KinematicCLVelBicycle(_KinematicBicycleBase):
    """Velocity-input Frenet kinematic bicycle: q=[epsi, s, xtran], u=[v, steer]."""

    n_q, n_u = 3, 2
    curvature_model = True

    def fc(self, q, u):
        epsi, s, xtran = q.unbind(-1)
        u_v, u_s = u.unbind(-1)
        beta = self.beta(u_s)
        c = self.track.curvature(s)
        ds = u_v * torch.cos(beta + epsi) / (1 - xtran * c)
        return torch.stack([u_v * torch.sin(beta) / self.L_r - c * ds,
                            ds,
                            u_v * torch.sin(beta + epsi)], dim=-1)

    def state2qu(self, state):
        return (np.array([state.p.e_psi, state.p.s, state.p.x_tran]),
                np.array([state.v.v_long, state.u.u_steer]))

    def qu2state(self, state, q=None, u=None):
        if q is not None:
            state.p.e_psi, state.p.s, state.p.x_tran = float(q[0]), float(q[1]), float(q[2])
        if u is not None:
            state.v.v_long, state.u.u_steer = float(u[0]), float(u[1])

    def _pred_q_fields(self):
        return [('e_psi', 0), ('s', 1), ('x_tran', 2)]


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

    def qu2state(self, state, q=None, u=None):
        if q is not None:
            state.x.x, state.x.y, state.v.v_long = float(q[0]), float(q[1]), float(q[2])
            state.p.e_psi, state.p.s, state.p.x_tran = float(q[3]), float(q[4]), float(q[5])
            if u is not None:
                state.w.w_psi = float(q[2] / self.L_r * np.sin(
                    np.arctan(np.tan(u[1]) * self.L_f / (self.L_f + self.L_r))))
                state.v.v_tran = state.w.w_psi * self.L_r
        if u is not None:
            state.u.u_a, state.u.u_steer = float(u[0]), float(u[1])

    def _pred_q_fields(self):
        return [('x', 0), ('y', 1), ('v_long', 2), ('e_psi', 3), ('s', 4), ('x_tran', 5)]


_DYNAMIC_BICYCLES = ('dynamic_bicycle', 'dynamic_bicycle_cl', 'dynamic_bicycle_combined')


def get_dynamics_model(name: str, t0: float, config, track=None) -> DynamicsModel:
    """String-keyed factory.  The dynamic (Pacejka) bicycles are not ported yet (ROADMAP
    queue 1, item 3: the dynamic-bicycle family) and raise ``NotImplementedError``."""
    registry = {
        'kinematic_bicycle': KinematicBicycle,
        'kinematic_bicycle_cl': KinematicCLBicycle,
        'kinematic_bicycle_combined': KinematicBicycleCombined,
        'kinematic_unicycle': KinematicUnicycle,
        'kinematic_unicycle_cl': KinematicClUnicycle,
        'kinematic_unicycle_combined': KinematicUnicycleCombined,
        'integrator': IntegratorModel,
    }
    if name in _DYNAMIC_BICYCLES:
        raise NotImplementedError(f'{name} is not ported yet (ROADMAP queue 1, item 3: '
                                  'the dynamic-bicycle family)')
    if name not in registry:
        raise ValueError(f'Unknown dynamics model {name}; available: {sorted(registry)}')
    return registry[name](t0, config, track=track)
