"""Vehicle dynamics models on tensors, ported from ``dgsqp_tpu/dynamics/models.py``.

It carries the ``DynamicsModel`` base (continuous ODE, euler/rk discretisations,
Jacobians and Hessians by ``torch.func``, additive process noise, the host-side step and
marshalling hooks, a saved track loaded by ``config.track_name``), the single
integrator, the kinematic unicycles (global, Frenet and combined frames; the merge
scenario's cars), the kinematic bicycles
(global, Frenet, velocity-input Frenet and combined; the racing scenarios'), the
dynamic (Pacejka or linear tire) bicycles in the same three frames (the dynamic
studies'), and the string-keyed ``get_dynamics_model``.
``fc``/``fd`` take ``q`` of shape (..., n_q) and ``u`` of shape (..., n_u) with any
matching leading batch shape, so one definition serves a single game, an explicit batch
and ``torch.func`` transforms alike.
"""
from __future__ import annotations

from abc import abstractmethod
from typing import Optional, Tuple

import numpy as np
import torch
from torch.func import jacfwd, jacrev

from dgsqp_torch.dynamics.model_types import (DynamicBicycleConfig, DynamicsConfig,
                                              KinematicBicycleConfig, UnicycleConfig)
from dgsqp_torch.ops.dynamics import dyn_step, fd_step
from dgsqp_torch.types import VehicleActuation, VehiclePrediction, VehicleState
from dgsqp_torch.utils.math import resistance


class DynamicsModel:
    """Base dynamics model: continuous ODE + generic discretization + AD derivatives."""

    n_q: int
    n_u: int
    curvature_model: bool = False
    # the step and its derivatives are one operation (``ops.dynamics.dyn_step``)
    fused_step: bool = False

    def __init__(self, t0: float, config: DynamicsConfig, track=None):
        self.t0 = t0
        self.model_config = config
        if config.track_name is not None:
            from dgsqp_torch.tracks.track_lib import get_track
            track = get_track(config.track_name)
        self.track = track
        self.dt = config.dt
        self.M = config.M
        self.h = self.dt / self.M

        # additive process noise: fd_noisy(q, u, m) = fd(q, u) + sqrtm(cov) @ m
        self.noise_sqrt = None
        if config.noise:
            if config.noise_cov is None:
                raise RuntimeError('Noise covariance matrix not provided to dynamics model')
            cov = np.asarray(config.noise_cov, dtype=np.float64)
            if cov.ndim == 1:
                cov = np.diag(cov)
            from scipy.linalg import sqrtm
            self.noise_sqrt = np.real(sqrtm(cov))

    @abstractmethod
    def fc(self, q, u):
        """Continuous-time dynamics dq/dt = fc(q, u)."""

    def fd(self, q, u, dt: Optional[float] = None):
        """One discrete step with the configured integrator."""
        return self.fd_plain(q, u, dt)

    def fd_plain(self, q, u, dt: Optional[float] = None, M: Optional[int] = None,
                 method: Optional[str] = None):
        """``fd`` written in tensor operations (the dynamic bicycles' kernel's plain
        version); ``dt``, the sub-step count ``M`` and ``method`` default to the
        model's own."""
        dt = self.dt if dt is None else dt
        method = method or self.model_config.discretization_method
        if method == 'euler':
            return q + dt * self.fc(q, u)
        M = M or self.M
        h = dt / M
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

    def fd_noisy(self, q, u, m):
        """Discrete step with an additive process-noise sample ``m`` (standard normal)."""
        if self.noise_sqrt is None:
            return self.fd(q, u)
        return self.fd(q, u) + m @ torch.as_tensor(self.noise_sqrt.T, dtype=m.dtype,
                                                   device=m.device)

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

    # ----------------------------------------------------------- host-side step
    def _host_rk4(self, q, u, T: float, n_sub: int):
        """``n_sub`` rk4 sub-steps over ``T`` of one point q (n_q,), u (n_u,)."""
        return self.fd_plain(q, u, T, n_sub, 'rk4')

    def step(self, vehicle_state: VehicleState, T: Optional[float] = None,
             device='cuda', dtype=torch.float64):
        """Integrate the noise-free model forward one interval ``T`` (default its
        ``dt``) by fine fixed-step rk4 (``max(8, M)`` sub-steps, whatever the model's
        own discretization) on ``device`` in ``dtype``, and write the result back into
        the state, with the frame the model does not carry recomputed by the track."""
        q, u = self.state2qu(vehicle_state)
        dt = self.dt if T is None else T
        qt = torch.as_tensor(q, dtype=dtype, device=device)
        ut = torch.as_tensor(u, dtype=dtype, device=device)
        q_n = self._host_rk4(qt, ut, dt, max(8, self.M)).cpu().numpy()
        self.qu2state(vehicle_state, q_n, u)
        vehicle_state.t = (vehicle_state.t or 0.0) + dt
        if self.track is not None:
            if self.curvature_model:
                self.track.local_to_global_typed(vehicle_state)
            else:
                self.track.global_to_local_typed(vehicle_state)

    @abstractmethod
    def state2qu(self, state: VehicleState) -> Tuple[np.ndarray, np.ndarray]:
        ...

    def state2q(self, state: VehicleState) -> np.ndarray:
        return self.state2qu(state)[0]

    def input2u(self, inp: VehicleActuation) -> np.ndarray:
        return np.array([inp.u_a, inp.u_steer])[:self.n_u]

    def u2input(self, inp: VehicleActuation, u: np.ndarray):
        inp.u_a = float(u[0])
        if self.n_u > 1:
            inp.u_steer = float(u[1])
        if self.n_u > 2:
            inp.u_ds = float(u[2])

    @abstractmethod
    def qu2state(self, state: VehicleState, q: Optional[np.ndarray] = None,
                 u: Optional[np.ndarray] = None):
        ...

    def q2state(self, state: VehicleState, q: np.ndarray):
        self.qu2state(state, q, None)

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

    def qu2interpolator(self, t0: float, q: np.ndarray, u: Optional[np.ndarray] = None,
                        extrapolate: bool = False):
        """Dense-time interpolator over a predicted trajectory: f(t) -> (q(t), u(t)) by
        per-channel linear interpolation on the grid t0 + k*dt (host numpy)."""
        q = np.asarray(q)
        T = t0 + self.dt * np.arange(q.shape[0])
        u = np.asarray(u) if u is not None else None
        Tu = t0 + self.dt * np.arange(u.shape[0]) if u is not None else None

        def f(t):
            t = np.clip(t, T[0], T[-1]) if not extrapolate else t
            qt = np.stack([np.interp(t, T, q[:, i]) for i in range(q.shape[1])], axis=-1)
            if u is None:
                return qt, None
            tu = np.clip(t, Tu[0], Tu[-1]) if not extrapolate else t
            ut = np.stack([np.interp(tu, Tu, u[:, i]) for i in range(u.shape[1])], axis=-1)
            return qt, ut
        return f


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
        return resistance(v, self.c_da, self.c_dr, self.c_r, self.p_r) - self.c_s * psidot ** 2


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


class _DynamicBicycleBase(DynamicsModel):
    fused_step = True

    def __init__(self, t0, config: DynamicBicycleConfig = None, track=None):
        config = config or DynamicBicycleConfig()
        if config.tire_model not in ('pacejka', 'linear'):
            raise ValueError("Tire model must be 'linear' or 'pacejka'")
        if config.drive_wheels not in ('all', 'rear'):
            raise ValueError("drive_wheels must be 'all' or 'rear'")
        super().__init__(t0, config, track)
        self.L_f = config.wheel_dist_front
        self.L_r = config.wheel_dist_rear
        self.m = config.mass
        self.I_z = config.yaw_inertia
        self.g = config.gravity
        self.c_dr = config.drag_coefficient
        self.c_da = config.damping_coefficient
        self.c_r = config.rolling_resistance
        self.p_r = config.rolling_resistance_exponent
        self.mu = config.wheel_friction
        self.tire_model = config.tire_model
        self.drive_wheels = config.drive_wheels
        self.pacejka_Bf = config.pacejka_b_front
        self.pacejka_Br = config.pacejka_b_rear
        self.pacejka_Cf = config.pacejka_c_front
        self.pacejka_Cr = config.pacejka_c_rear
        self.pacejka_Df = config.pacejka_d_front
        self.pacejka_Dr = config.pacejka_d_rear
        self.linear_Bf = config.linear_bf
        self.linear_Br = config.linear_br
        self.simple_slip = config.simple_slip

    def fd(self, q, u, dt: Optional[float] = None):
        """One discrete step at the model's own ``dt``, the step and its derivatives one
        operation (``dgsqp_torch.ops.dynamics.fd_step``): ``csrc/dyn_step.cu`` on the
        card, which raises for a model or track it does not have, and ``fd_plain`` under
        ``torch.func`` on the CPU."""
        if dt is not None and dt != self.dt:
            raise ValueError(f'{type(self).__name__}.fd steps only at its own dt '
                             f'{self.dt}, not {dt}')
        return fd_step(self, q, u)

    def _host_rk4(self, q, u, T: float, n_sub: int):
        """The host step's rk4 as one ``dyn_step`` launch at the step's own ``T`` and
        sub-step count on a CUDA tensor (its plain version on the CPU)."""
        return dyn_step(self, q[None], u[None], 0, dt=T, M=n_sub, method='rk4')[0][0]

    # the fused step's second derivatives reach a forward pass only through its reverse
    # rule (see dgsqp_torch.ops.dynamics), so the Hessians are taken forward-over-reverse
    def fEd(self, q, u):
        return jacfwd(jacrev(self.fd, argnums=0), argnums=0)(q, u)

    def fFd(self, q, u):
        return jacfwd(jacrev(self.fd, argnums=1), argnums=1)(q, u)

    def fGd(self, q, u):
        return jacfwd(jacrev(self.fd, argnums=1), argnums=0)(q, u)

    def body_accels(self, vx, vy, psidot, u_a, u_s):
        """Slip angles, tire forces and the body-frame accelerations (ax, ay, yaw)."""
        vyf = vy + self.L_f * psidot
        cs, ss = torch.cos(u_s), torch.sin(u_s)
        if self.simple_slip:
            alpha_f = -torch.atan2(vyf, vx) + u_s
        else:
            alpha_f = -torch.atan2(vyf * cs - vx * ss, vx * cs + vyf * ss)
        alpha_r = -torch.atan2(vy - self.L_r * psidot, vx)

        if self.tire_model == 'pacejka':
            fyf = self.pacejka_Df * torch.sin(self.pacejka_Cf * torch.atan(self.pacejka_Bf * alpha_f))
            fyr = self.pacejka_Dr * torch.sin(self.pacejka_Cr * torch.atan(self.pacejka_Br * alpha_r))
        else:
            fyf = self.linear_Bf * self.m * self.g * self.L_r / (self.L_f + self.L_r) * alpha_f
            fyr = self.linear_Br * self.m * self.g * self.L_f / (self.L_f + self.L_r) * alpha_r

        F_ext = resistance(vx, self.c_da, self.c_dr, self.c_r, self.p_r)
        if self.drive_wheels == 'all':
            ar = af = u_a / 2
            ax = ar + af * cs + (F_ext - fyf * ss) / self.m
            ay = af * ss + (fyf * cs + fyr) / self.m
        else:
            # rear drive: the front wheels' share af = 0 drops out of both sums
            ax = u_a + (F_ext - fyf * ss) / self.m
            ay = (fyf * cs + fyr) / self.m
        alphaz = (self.L_f * fyf * cs - self.L_r * fyr) / self.I_z
        return ax, ay, alphaz


class DynamicBicycle(_DynamicBicycleBase):
    """Global-frame dynamic bicycle: q=[vx, vy, psidot, x, y, psi], u=[a, steer]."""

    n_q, n_u = 6, 2

    def fc(self, q, u):
        vx, vy, psidot, x, y, psi = q.unbind(-1)
        u_a, u_s = u.unbind(-1)
        ax, ay, alphaz = self.body_accels(vx, vy, psidot, u_a, u_s)
        cp, sp = torch.cos(psi), torch.sin(psi)
        return torch.stack([ax + psidot * vy,
                            ay - psidot * vx,
                            alphaz,
                            vx * cp - vy * sp,
                            vy * cp + vx * sp,
                            psidot], dim=-1)

    def state2qu(self, state):
        return (np.array([state.v.v_long, state.v.v_tran, state.w.w_psi,
                          state.x.x, state.x.y, state.e.psi]),
                np.array([state.u.u_a, state.u.u_steer]))

    def qu2state(self, state, q=None, u=None):
        if q is not None:
            state.v.v_long, state.v.v_tran, state.w.w_psi = float(q[0]), float(q[1]), float(q[2])
            state.x.x, state.x.y, state.e.psi = float(q[3]), float(q[4]), float(q[5])
        if u is not None:
            state.u.u_a, state.u.u_steer = float(u[0]), float(u[1])

    def _pred_q_fields(self):
        return [('v_long', 0), ('v_tran', 1), ('psidot', 2), ('x', 3), ('y', 4), ('psi', 5)]


class DynamicCLBicycle(_DynamicBicycleBase):
    """Frenet-frame dynamic bicycle: q=[vx, vy, psidot, epsi, s, xtran], u=[a, steer]."""

    n_q, n_u = 6, 2
    curvature_model = True

    def fc(self, q, u):
        vx, vy, psidot, epsi, s, xtran = q.unbind(-1)
        u_a, u_s = u.unbind(-1)
        ax, ay, alphaz = self.body_accels(vx, vy, psidot, u_a, u_s)
        c = self.track.curvature(s)
        ce, se = torch.cos(epsi), torch.sin(epsi)
        ds = (vx * ce - vy * se) / (1 - xtran * c)
        return torch.stack([ax + psidot * vy,
                            ay - psidot * vx,
                            alphaz,
                            psidot - c * ds,
                            ds,
                            vx * se + vy * ce], dim=-1)

    def state2qu(self, state):
        return (np.array([state.v.v_long, state.v.v_tran, state.w.w_psi,
                          state.p.e_psi, state.p.s, state.p.x_tran]),
                np.array([state.u.u_a, state.u.u_steer]))

    def qu2state(self, state, q=None, u=None):
        if q is not None:
            state.v.v_long, state.v.v_tran, state.w.w_psi = float(q[0]), float(q[1]), float(q[2])
            state.p.e_psi, state.p.s, state.p.x_tran = float(q[3]), float(q[4]), float(q[5])
        if u is not None:
            state.u.u_a, state.u.u_steer = float(u[0]), float(u[1])

    def _pred_q_fields(self):
        return [('v_long', 0), ('v_tran', 1), ('psidot', 2), ('e_psi', 3), ('s', 4), ('x_tran', 5)]


class DynamicBicycleCombined(_DynamicBicycleBase):
    """Global + Frenet dynamic bicycle: q=[x, y, vx, vy, psidot, epsi, s, xtran],
    u=[a, steer]."""

    n_q, n_u = 8, 2
    curvature_model = True

    def fc(self, q, u):
        x, y, vx, vy, psidot, epsi, s, xtran = q.unbind(-1)
        u_a, u_s = u.unbind(-1)
        ax, ay, alphaz = self.body_accels(vx, vy, psidot, u_a, u_s)
        c = self.track.curvature(s)
        psi_t = self.track.tangent_angle(s)
        ce, se = torch.cos(epsi), torch.sin(epsi)
        cg, sg = torch.cos(epsi + psi_t), torch.sin(epsi + psi_t)
        ds = (vx * ce - vy * se) / (1 - xtran * c)
        return torch.stack([vx * cg - vy * sg,
                            vy * cg + vx * sg,
                            ax + psidot * vy,
                            ay - psidot * vx,
                            alphaz,
                            psidot - c * ds,
                            ds,
                            vx * se + vy * ce], dim=-1)

    def state2qu(self, state):
        return (np.array([state.x.x, state.x.y, state.v.v_long, state.v.v_tran,
                          state.w.w_psi, state.p.e_psi, state.p.s, state.p.x_tran]),
                np.array([state.u.u_a, state.u.u_steer]))

    def qu2state(self, state, q=None, u=None):
        if q is not None:
            state.x.x, state.x.y = float(q[0]), float(q[1])
            state.v.v_long, state.v.v_tran, state.w.w_psi = float(q[2]), float(q[3]), float(q[4])
            state.p.e_psi, state.p.s, state.p.x_tran = float(q[5]), float(q[6]), float(q[7])
        if u is not None:
            state.u.u_a, state.u.u_steer = float(u[0]), float(u[1])

    def _pred_q_fields(self):
        return [('x', 0), ('y', 1), ('v_long', 2), ('v_tran', 3), ('psidot', 4),
                ('e_psi', 5), ('s', 6), ('x_tran', 7)]


def get_dynamics_model(name: str, t0: float, config, track=None) -> DynamicsModel:
    """String-keyed factory."""
    registry = {
        'dynamic_bicycle': DynamicBicycle,
        'dynamic_bicycle_cl': DynamicCLBicycle,
        'dynamic_bicycle_combined': DynamicBicycleCombined,
        'kinematic_bicycle': KinematicBicycle,
        'kinematic_bicycle_cl': KinematicCLBicycle,
        'kinematic_bicycle_combined': KinematicBicycleCombined,
        'kinematic_unicycle': KinematicUnicycle,
        'kinematic_unicycle_cl': KinematicClUnicycle,
        'kinematic_unicycle_combined': KinematicUnicycleCombined,
        'integrator': IntegratorModel,
    }
    if name not in registry:
        raise ValueError(f'Unknown dynamics model {name}; available: {sorted(registry)}')
    return registry[name](t0, config, track=track)
