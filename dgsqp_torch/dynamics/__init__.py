from dgsqp_torch.dynamics.model_types import (DynamicBicycleConfig, DynamicsConfig,
                                              KinematicBicycleConfig, ModelConfig,
                                              MultiAgentModelConfig, PointMassConfig,
                                              UnicycleConfig)
from dgsqp_torch.dynamics.models import (DynamicBicycle, DynamicBicycleCombined,
                                         DynamicCLBicycle, DynamicsModel, IntegratorModel,
                                         KinematicBicycle, KinematicBicycleCombined,
                                         KinematicCLBicycle, KinematicCLVelBicycle,
                                         KinematicClUnicycle, KinematicUnicycle,
                                         KinematicUnicycleCombined, get_dynamics_model)
from dgsqp_torch.dynamics.multi_agent import MultiAgentDynamicsModel
from dgsqp_torch.dynamics.simulator import DynamicsSimulator
