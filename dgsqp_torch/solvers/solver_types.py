"""Solver parameter dataclasses, a jax-free copy of ``DGSQPParams``, ``DGSQPV2Params``,
``ALGAMESParams``, ``IBRParams`` and ``PATHMCPParams`` from
``dgsqp_tpu/solvers/solver_types.py`` (field for field, same defaults).

CasADi/codegen knobs (``qp_interface``, ``code_gen``, ``jit`` ...) are kept as inert
fields so configurations port unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from dgsqp_torch.types import PythonMsg


@dataclass
class ControllerConfig(PythonMsg):
    dt: float = 0.1


@dataclass
class DGSQPParams(ControllerConfig):
    N: int = 10

    beta: float = 0.25           # Armijo slope fraction
    tau: float = 0.5             # backtracking factor

    p_tol: float = 1e-3
    d_tol: float = 1e-3

    reg: float = 1e-3
    line_search_iters: int = 50
    nonmono_ls: bool = False
    sqp_iters: int = 50
    merit_function: str = 'stat_l1'

    verbose: bool = False
    save_iter_data: bool = True

    solver_name: str = 'DGSQP'
    time_limit: Optional[float] = None
    qp_interface: str = 'torch'          # inert (single QP backend)
    qp_solver: str = 'ipm'               # inert
    conv_approx: bool = True
    hessian_approximation: str = 'none'

    code_gen: bool = False               # inert
    jit: bool = False                    # inert
    opt_flag: str = 'O0'                 # inert
    enable_jacobians: bool = True        # inert
    solver_dir: Optional[str] = None     # inert
    so_name: Optional[str] = None        # inert
    debug_plot: bool = False
    pause_on_plot: bool = False
    local_pos: bool = False

    qp_tol: float = 1e-8
    qp_max_iters: int = 50
    # a game whose cumulative QP-solve count reaches this budget stops with status
    # 'time_limit' (deterministic analog of a wall-clock limit).  None = unlimited.
    qp_solves_limit: Optional[int] = None
    # stagnation escape: 'stalled' after this many consecutive accepted-iterate
    # evaluations without a 1% stationarity improvement (None = off)
    stall_its: Optional[int] = None
    # IPM warm start across rounds of the flat machine
    qp_warm_start: bool = False
    # game-Hessian assembly: only 'ad' (forward-over-reverse) is ported
    hessian_mode: str = 'ad'
    # PDAS polish iterations in the QP solver
    qp_polish_iters: int = 4
    # Gondzio centrality correctors per IPM iteration (0 = plain Mehrotra)
    qp_correctors: int = 0
    # fold the input-box rows (and paired state-bound rows) of G into the IPM
    # normal matrix instead of GEMM rows; decision-identical
    qp_box_split: bool = False
    # Hessian PSD projection: 'eigh' (exact clipping) or 'ns' (Newton-Schulz)
    conv_method: str = 'eigh'
    conv_ns_iters: int = 14
    conv_ns_safety: float = 1e-3
    conv_ns_equil: bool = False
    # lockstep execution model: 'auto' = flat round machine when the watchdog is on
    # and Hessians are exact (the only model ported)
    execution: str = 'auto'


@dataclass
class DGSQPV2Params(DGSQPParams):
    """Journal-algorithm (v2) parameters."""
    p_tol: float = 1e-4
    d_tol: float = 1e-4
    reg: float = 1e2
    reg_decay: float = 0.95
    nms: bool = True
    nms_frequency: int = 5
    nms_memory_size: int = 3
    sqp_iters: int = 500
    merit_parameter: Optional[float] = None   # None => adaptive
    merit_decrease: float = 0.01              # sigma
    merit_decrease_condition: str = 'armijo'  # or 'max'
    approximation_eval: str = 'always'        # 'once' (approximate-game variant)
    delta_decay: float = 0.95                 # gamma: d-step trust shrink factor
    # delta init = factor * ||first (du, dl)||.  factor <= 0 disables the unconditional
    # first d-step so that every iteration is merit-checked
    nms_initial_step_size_factor: float = 20.0
    # relative KKT tolerance: scale the stationarity/complementarity tests by
    # max(1, ||q||_inf) at the current iterate.  Off by default (absolute residuals)
    conv_scaled_stat: bool = False
    save_qp_data: bool = False


@dataclass
class ALGAMESParams(ControllerConfig):
    N: int = 10

    rho: float = 1.0
    gamma: float = 10.0
    rho_max: float = 1e7
    lam_max: float = 1e7

    beta: float = 0.25
    tau: float = 0.5

    q_reg: float = 1e-2
    u_reg: float = 1e-2
    line_search_tol: float = 1e-6
    newton_step_tol: float = 1e-6
    ineq_tol: float = 1e-3
    eq_tol: float = 1e-3
    opt_tol: float = 1e-3

    dynamics_hessians: bool = False

    outer_iters: int = 50
    line_search_iters: int = 50
    newton_iters: int = 50

    verbose: bool = False
    solver_name: str = 'ALGAMES'

    debug: bool = False
    debug_plot: bool = False
    pause_on_plot: bool = False
    local_pos: bool = False


@dataclass
class IBRParams(ControllerConfig):
    N: int = 10
    ibr_iters: int = 1
    use_ps: bool = False
    p_tol: float = 1e-3
    d_tol: float = 1e-3
    line_search_iters: int = 50
    verbose: bool = False
    solver_name: str = 'IBR'
    debug_plot: bool = False
    pause_on_plot: bool = False
    # inner best-response SQP controls
    br_sqp_iters: int = 50
    br_reg: float = 1e-3


@dataclass
class PATHMCPParams(ControllerConfig):
    """Parameters of the semismooth-Newton MCP baseline (see ``solvers/mcp.py``)."""
    N: int = 10
    max_iters: int = 200
    tol: float = 1e-8
    verbose: bool = False
    solver_name: str = 'MCP'
    line_search_iters: int = 24
    beta: float = 1e-4
    tau: float = 0.5
    reg: float = 1e-6              # initial Levenberg shift (adapted in-loop)
    fb_lambda: float = 0.8         # penalized-FB weight (1.0 = plain FB)
    nonmono_memory: int = 16       # nonmonotone Armijo reference window
    stall_its: int = 6             # iterations without material progress -> restart
    max_restarts: int = 4          # proximal-perturbation restart budget
    pert0: float = 1e-2            # first restart's proximal perturbation
    pert_decay: float = 0.5        # per-iteration perturbation decay
    # smoothing continuation: the FB function starts at eps0 and shrinks toward the
    # dtype's floor as the sharp residual falls
    eps0: float = 1e-1
    eps_decay: float = 0.7         # per-accepted-step multiplicative shrink
    eps_frac: float = 0.05         # eps also capped at eps_frac * sharp residual
    # 'fbnewton' = smoothed FB semismooth Newton; 'josephy' = the linearized MCP solved
    # exactly per iteration (an indefinite QP); 'hybrid' = josephy, then fbnewton
    method: str = 'fbnewton'
    qp_tol: Optional[float] = None         # None -> dtype default (1e-8 / 3e-7)
    qp_max_iters: int = 50
    jos_gamma: float = 2.0         # residual-watchdog growth tolerance (josephy)
