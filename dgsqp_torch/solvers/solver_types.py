"""Solver parameter dataclasses, a jax-free copy of ``DGSQPParams`` from
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
