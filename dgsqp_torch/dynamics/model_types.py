"""Dynamics model configuration dataclasses, a jax-free copy of the part of
``dgsqp_tpu/dynamics/model_types.py`` that the kinematic bicycles and unicycles read.

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
class UnicycleConfig(DynamicsConfig):
    mass: float = 2.366
    damping_coefficient: float = 0.0
    drag_coefficient: float = 0.0
    rolling_resistance: float = 0.0
    rolling_resistance_exponent: float = 0.5


@dataclass
class MultiAgentModelConfig(DynamicsConfig):
    use_mx: bool = False
