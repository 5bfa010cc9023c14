from dgsqp_torch.solvers.abstract_solver import AbstractSolver
from dgsqp_torch.solvers.algames import ALGAMES
from dgsqp_torch.solvers.ca_ltv_mpc import CA_LTV_MPC
from dgsqp_torch.solvers.dgsqp import DGSQP, SQPResult, STATUS_MSG
from dgsqp_torch.solvers.dgsqp_v2 import DGSQPV2
from dgsqp_torch.solvers.dgsqp_v2_frenet import DGSQPV2FrenetApprox
from dgsqp_torch.solvers.game_problem import GameProblem
from dgsqp_torch.solvers.ibr import IBR
from dgsqp_torch.solvers.mcp import PATHMCP, PATHMCPFrenetApprox
from dgsqp_torch.solvers.pid import PID, PIDLaneFollower
from dgsqp_torch.solvers.qp import (QPSolution, solve_elastic_qp, solve_eq_qp, solve_qp,
                                    solve_qp_batch)
from dgsqp_torch.solvers.solver_types import (ALGAMESParams, CALTVMPCParams, DGSQPParams,
                                              DGSQPV2Params, IBRParams, PATHMCPParams,
                                              PIDParams)
