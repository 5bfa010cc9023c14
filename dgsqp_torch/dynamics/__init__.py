from dgsqp_torch.dynamics.model_types import (DynamicsConfig, KinematicBicycleConfig,
                                              ModelConfig, MultiAgentModelConfig)
from dgsqp_torch.dynamics.models import (DynamicsModel, IntegratorModel,
                                         KinematicBicycleCombined)
from dgsqp_torch.dynamics.multi_agent import MultiAgentDynamicsModel
