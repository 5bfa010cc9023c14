from dgsqp_torch.solvers.dgsqp import DGSQP, SQPResult, STATUS_MSG
from dgsqp_torch.solvers.dgsqp_v2 import DGSQPV2
from dgsqp_torch.solvers.game_problem import GameProblem
from dgsqp_torch.solvers.qp import QPSolution, solve_qp
from dgsqp_torch.solvers.solver_types import DGSQPParams, DGSQPV2Params
