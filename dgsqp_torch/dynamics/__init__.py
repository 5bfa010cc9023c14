from dgsqp_torch.dynamics.model_types import (DynamicsConfig, KinematicBicycleConfig,
                                              ModelConfig, MultiAgentModelConfig,
                                              UnicycleConfig)
from dgsqp_torch.dynamics.models import (DynamicsModel, IntegratorModel, KinematicBicycle,
                                         KinematicBicycleCombined, KinematicCLBicycle,
                                         KinematicCLVelBicycle, KinematicClUnicycle,
                                         KinematicUnicycle, KinematicUnicycleCombined,
                                         get_dynamics_model)
from dgsqp_torch.dynamics.multi_agent import MultiAgentDynamicsModel
