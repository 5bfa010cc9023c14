"""Host-side vehicle state containers, a jax-free copy of ``dgsqp_tpu/types.py``.

The port keeps its own copy so that nothing under ``dgsqp_torch`` imports the JAX
package.  ``VehicleState`` is a composite of typed sub-messages (position, velocities,
parametric pose, actuation); ``VehiclePrediction`` holds arrays over a horizon.  The
tensor compute path never touches these objects: each dynamics model's
``state2q``/``state2qu`` turns them into flat arrays at the solver boundary.
"""
from __future__ import annotations

import copy as _copy
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class PythonMsg:
    """Base message type: guard against creating undeclared attributes (typo safety).

    Mirrors reference ``DGSQP/types.py:13-84`` behavior: setting an attribute that was not
    declared as a dataclass field raises ``AttributeError``.
    """

    def __setattr__(self, key, value):
        if not hasattr(self, key) and key not in self.__dataclass_fields__:
            raise AttributeError(f'Cannot add new field "{key}" to frozen message {type(self).__name__}')
        object.__setattr__(self, key, value)

    def copy(self):
        return _copy.deepcopy(self)

    def pprint(self, indent=0):
        print(' ' * indent + type(self).__name__)
        for f in self.__dataclass_fields__:
            v = getattr(self, f)
            if isinstance(v, PythonMsg):
                v.pprint(indent + 2)
            else:
                print(' ' * (indent + 2) + f'{f}: {v}')


@dataclass
class Position(PythonMsg):
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0


@dataclass
class VehicleActuation(PythonMsg):
    t: float = 0.0
    u_a: float = 0.0
    u_steer: float = 0.0
    u_ds: float = 0.0  # virtual arc-speed input (progress-augmented models)


@dataclass
class BodyLinearVelocity(PythonMsg):
    v_long: float = 0.0
    v_tran: float = 0.0
    v_n: float = 0.0


@dataclass
class BodyAngularVelocity(PythonMsg):
    w_phi: float = 0.0
    w_theta: float = 0.0
    w_psi: float = 0.0


@dataclass
class BodyLinearAcceleration(PythonMsg):
    a_long: float = 0.0
    a_tran: float = 0.0
    a_n: float = 0.0


@dataclass
class BodyAngularAcceleration(PythonMsg):
    a_phi: float = 0.0
    a_theta: float = 0.0
    a_psi: float = 0.0


@dataclass
class OrientationEuler(PythonMsg):
    phi: float = 0.0
    theta: float = 0.0
    psi: float = 0.0


@dataclass
class OrientationQuaternion(PythonMsg):
    """Unit quaternion (qr scalar part).  Reference: ``DGSQP/types.py:234-335``."""

    qr: float = 1.0
    qi: float = 0.0
    qj: float = 0.0
    qk: float = 0.0

    def e1(self):
        return np.array([1 - 2 * self.qj ** 2 - 2 * self.qk ** 2,
                         2 * (self.qi * self.qj + self.qk * self.qr),
                         2 * (self.qi * self.qk - self.qj * self.qr)])

    def e2(self):
        return np.array([2 * (self.qi * self.qj - self.qk * self.qr),
                         1 - 2 * self.qi ** 2 - 2 * self.qk ** 2,
                         2 * (self.qj * self.qk + self.qi * self.qr)])

    def e3(self):
        return np.array([2 * (self.qi * self.qk + self.qj * self.qr),
                         2 * (self.qj * self.qk - self.qi * self.qr),
                         1 - 2 * self.qi ** 2 - 2 * self.qj ** 2])

    def R(self):
        return np.stack([self.e1(), self.e2(), self.e3()], axis=1)

    def Rinv(self):
        return self.R().T

    def to_yaw(self):
        return np.arctan2(2 * (self.qr * self.qk + self.qi * self.qj),
                          1 - 2 * (self.qj ** 2 + self.qk ** 2))

    def from_yaw(self, yaw: float):
        self.qr = np.cos(yaw / 2)
        self.qi = 0.0
        self.qj = 0.0
        self.qk = np.sin(yaw / 2)

    def norm(self):
        return np.sqrt(self.qr ** 2 + self.qi ** 2 + self.qj ** 2 + self.qk ** 2)

    def normalize(self):
        n = self.norm()
        self.qr /= n
        self.qi /= n
        self.qj /= n
        self.qk /= n


@dataclass
class ParametricPose(PythonMsg):
    """Frenet-frame pose: arc-length progress s, lateral offset x_tran, heading error e_psi."""

    s: float = 0.0
    x_tran: float = 0.0
    n: float = 0.0
    e_psi: float = 0.0


@dataclass
class ParametricVelocity(PythonMsg):
    ds: float = 0.0
    dx_tran: float = 0.0
    dn: float = 0.0
    de_psi: float = 0.0


def _f(factory):
    return field(default_factory=factory)


@dataclass
class VehicleState(PythonMsg):
    """Full vehicle state composite (reference ``DGSQP/types.py:377-435``)."""

    t: Optional[float] = None
    x: Position = _f(Position)
    v: BodyLinearVelocity = _f(BodyLinearVelocity)
    w: BodyAngularVelocity = _f(BodyAngularVelocity)
    a: BodyLinearAcceleration = _f(BodyLinearAcceleration)
    aa: BodyAngularAcceleration = _f(BodyAngularAcceleration)
    q: OrientationQuaternion = _f(OrientationQuaternion)
    e: OrientationEuler = _f(OrientationEuler)
    p: ParametricPose = _f(ParametricPose)
    pt: ParametricVelocity = _f(ParametricVelocity)
    u: VehicleActuation = _f(VehicleActuation)
    du: VehicleActuation = _f(VehicleActuation)
    lap_num: Optional[int] = None

    def update_body_velocity_from_global(self):
        psi = self.e.psi
        vx, vy = self.v.v_long, self.v.v_tran  # already body frame; no-op helper retained for API parity
        return vx, vy


@dataclass
class VehiclePrediction(PythonMsg):
    """Arrays over a prediction horizon (reference ``DGSQP/types.py:484-576``)."""

    t: Optional[float] = None
    x: Optional[np.ndarray] = None
    y: Optional[np.ndarray] = None
    v_x: Optional[np.ndarray] = None
    v_y: Optional[np.ndarray] = None
    a_x: Optional[np.ndarray] = None
    a_y: Optional[np.ndarray] = None
    psi: Optional[np.ndarray] = None
    psidot: Optional[np.ndarray] = None
    v_long: Optional[np.ndarray] = None
    v_tran: Optional[np.ndarray] = None
    a_long: Optional[np.ndarray] = None
    a_tran: Optional[np.ndarray] = None
    e_psi: Optional[np.ndarray] = None
    s: Optional[np.ndarray] = None
    x_tran: Optional[np.ndarray] = None
    u_a: Optional[np.ndarray] = None
    u_steer: Optional[np.ndarray] = None
    u_ds: Optional[np.ndarray] = None
    lap_num: Optional[int] = None
    sey_cov: Optional[np.ndarray] = None


@dataclass
class ControllerStatus(PythonMsg):
    t: float = 0.0
    status: bool = True
    info: str = ''
