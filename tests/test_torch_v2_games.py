"""The two-agent integrator game of ``tests/test_dgsqp_v2.py``, built for the JAX
package and for the port.  It holds no test: the ``test_torch_dgsqp_v2*`` files import
their games from here."""
import numpy as np
import jax.numpy as jnp
import torch

from dgsqp_tpu.dynamics import DynamicsConfig as JaxDynamicsConfig
from dgsqp_tpu.dynamics import IntegratorModel as JaxIntegratorModel
from dgsqp_tpu.dynamics import MultiAgentDynamicsModel as JaxMultiAgent
from dgsqp_tpu.types import VehicleState as JaxVehicleState
from dgsqp_torch.dynamics import DynamicsConfig, IntegratorModel, MultiAgentDynamicsModel
from dgsqp_torch.types import VehicleState

N = 5
DT = 0.1


def _bounds(state_cls):
    ub = state_cls()
    ub.v.v_long = np.inf
    ub.u.u_a = 5.0
    lb = state_cls()
    lb.v.v_long = -np.inf
    lb.u.u_a = -5.0
    return {'ub': [ub, ub.copy()], 'lb': [lb, lb.copy()]}


def jax_game(param_cost: bool = False):
    """(joint, costs, shared constraints, bounds); with ``param_cost`` the terminal
    costs take a per-game parameter P and add ``P * x_a``."""
    joint = JaxMultiAgent(0.0, [JaxIntegratorModel(0.0, JaxDynamicsConfig(dt=DT)),
                                JaxIntegratorModel(0.0, JaxDynamicsConfig(dt=DT))])

    def stage(x, u, um):
        return 0.5 * u[0] ** 2

    def term(a):
        if param_cost:
            return lambda x, P: 50.0 * (x[a] - 1.0) ** 2 + 0.3 * x[0] * x[1] + P * x[a]
        return lambda x: 50.0 * (x[a] - 1.0) ** 2 + 0.3 * x[0] * x[1]

    def shared(x, u, um):
        return jnp.array([x[0] + x[1] - 1.0])

    def shared_term(x):
        return jnp.array([x[0] + x[1] - 1.0])

    costs = [(stage, term(0)), (stage, term(1))]
    return joint, costs, [None] + [shared] * (N - 1) + [shared_term], _bounds(JaxVehicleState)


def torch_game(param_cost: bool = False):
    joint = MultiAgentDynamicsModel(0.0, [IntegratorModel(0.0, DynamicsConfig(dt=DT)),
                                          IntegratorModel(0.0, DynamicsConfig(dt=DT))])

    def stage(x, u, um):
        return 0.5 * u[..., 0] ** 2

    def term(a):
        if param_cost:
            return lambda x, P: (50.0 * (x[..., a] - 1.0) ** 2 + 0.3 * x[..., 0] * x[..., 1]
                                 + P * x[..., a])
        return lambda x: 50.0 * (x[..., a] - 1.0) ** 2 + 0.3 * x[..., 0] * x[..., 1]

    def shared(x, u, um):
        return (x[..., 0] + x[..., 1] - 1.0)[..., None]

    def shared_term(x):
        return (x[..., 0] + x[..., 1] - 1.0)[..., None]

    costs = [(stage, term(0)), (stage, term(1))]
    return joint, costs, [None] + [shared] * (N - 1) + [shared_term], _bounds(VehicleState)


def make_solvers(jax_cls, jax_params, torch_cls, torch_params, param_cost=False):
    """The same game and parameters in both packages; the port in float64 on the CPU."""
    joint, costs, shared, bounds = jax_game(param_cost)
    jsolver = jax_cls(joint, costs, [None, None], shared, bounds, jax_params,
                      print_method=None)
    joint, costs, shared, bounds = torch_game(param_cost)
    tsolver = torch_cls(joint, costs, [None, None], shared, bounds, torch_params,
                        print_method=None, dtype=torch.float64, device='cpu')
    return jsolver, tsolver
