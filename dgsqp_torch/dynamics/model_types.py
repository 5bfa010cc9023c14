"""Dynamics model configuration dataclasses, a jax-free copy of
``dgsqp_tpu/dynamics/model_types.py`` for the models the port holds.

Codegen-related flags (``code_gen``, ``jit``, ``opt_flag``, ``install_dir``) are kept for
API compatibility and are inert.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from dgsqp_torch.types import PythonMsg


@dataclass
class ModelConfig(PythonMsg):
    model_name: str = 'model'
    use_mx: bool = False                   # inert
    enable_jacobians: bool = True          # inert
    compute_hessians: bool = False
    verbose: bool = False
    code_gen: bool = False                 # inert
    jit: bool = True                       # inert
    opt_flag: str = 'O0'                   # inert
    install: bool = True                   # inert
    install_dir: str = '~/.dgsqp_models'   # inert


@dataclass
class DynamicsConfig(ModelConfig):
    track_name: Optional[str] = None
    dt: float = 0.01
    discretization_method: str = 'euler'
    M: int = 10  # integration substeps for rk discretizations
    noise: bool = False
    noise_cov: Optional[np.ndarray] = None


@dataclass
class DynamicBicycleConfig(DynamicsConfig):
    wheel_dist_front: float = 0.13
    wheel_dist_rear: float = 0.13
    wheel_dist_center_front: float = 0.1
    wheel_dist_center_rear: float = 0.1
    bump_dist_front: float = 0.15
    bump_dist_rear: float = 0.15
    bump_dist_center: float = 0.1
    bump_dist_top: float = 0.1
    com_height: float = 0.05

    mass: float = 2.2187
    gravity: float = 9.81

    yaw_inertia: float = 0.02723
    pitch_inertia: float = 0.03
    roll_inertia: float = 0.03

    drag_coefficient: float = 0.0
    damping_coefficient: float = 0.0
    rolling_resistance: float = 0.0
    rolling_resistance_exponent: float = 0.0

    tire_model: str = 'pacejka'
    drive_wheels: str = 'all'

    wheel_friction: float = 0.9
    pacejka_b_front: float = 5.0
    pacejka_b_rear: float = 5.0
    pacejka_c_front: float = 2.28
    pacejka_c_rear: float = 2.28
    pacejka_d_front: Optional[float] = None
    pacejka_d_rear: Optional[float] = None

    linear_bf: float = 1.0
    linear_br: float = 1.0

    simple_slip: bool = False

    def __post_init__(self):
        # the Pacejka peak forces from friction and the static axle loads
        if self.pacejka_d_front is None:
            self.pacejka_d_front = (self.wheel_friction * self.mass * self.gravity *
                                    self.wheel_dist_rear / (self.wheel_dist_rear + self.wheel_dist_front))
        if self.pacejka_d_rear is None:
            self.pacejka_d_rear = (self.wheel_friction * self.mass * self.gravity *
                                   self.wheel_dist_front / (self.wheel_dist_rear + self.wheel_dist_front))


@dataclass
class KinematicBicycleConfig(DynamicsConfig):
    wheel_dist_front: float = 0.13
    wheel_dist_rear: float = 0.13
    wheel_dist_center_front: float = 0.1
    wheel_dist_center_rear: float = 0.1
    bump_dist_front: float = 0.15
    bump_dist_rear: float = 0.15
    bump_dist_center: float = 0.1
    bump_dist_top: float = 0.1
    com_height: float = 0.05

    mass: float = 2.366

    drag_coefficient: float = 0.0
    damping_coefficient: float = 0.0
    slip_coefficient: float = 0.0
    rolling_resistance: float = 0.0
    rolling_resistance_exponent: float = 0.5


@dataclass
class PointMassConfig(DynamicsConfig):
    mass: float = 2.366
    damping_coefficient: float = 0.0
    drag_coefficient: float = 0.0
    rolling_resistance: float = 0.0
    rolling_resistance_exponent: float = 0.5


@dataclass
class UnicycleConfig(DynamicsConfig):
    mass: float = 2.366
    damping_coefficient: float = 0.0
    drag_coefficient: float = 0.0
    rolling_resistance: float = 0.0
    rolling_resistance_exponent: float = 0.5


@dataclass
class MultiAgentModelConfig(DynamicsConfig):
    use_mx: bool = False
