"""Construction of the flagship bench problem, ported from
``dgsqp_tpu/harness/bench_setup.py``: the chicane duel with DGSQP v1 or v2, or the
approximate (MPCC) duel with ``DGSQPV2FrenetApprox`` (``solver_name='approx'``).

The same environment knobs set the same parameters as in the JAX package, and the QP
tolerance follows the same rule: 1e-8 in float64, 3e-7 in float32.
"""
from __future__ import annotations

import os

import torch

from dgsqp_torch.harness.mc_study import _dual_warm_start
from dgsqp_torch.harness.samplers import sample_duel_initial_conditions
from dgsqp_torch.harness.scenarios import build_approximate_duel, build_chicane_scenario
from dgsqp_torch.harness.warm_start import seed_virtual_rate_prev
from dgsqp_torch.solvers.dgsqp import DGSQP
from dgsqp_torch.solvers.dgsqp_v2 import DGSQPV2
from dgsqp_torch.solvers.dgsqp_v2_frenet import DGSQPV2FrenetApprox
from dgsqp_torch.solvers.solver_types import DGSQPParams, DGSQPV2Params


def build_bench_solver(horizon: int = 25, solver_name: str = 'v1', scenario=None,
                       dtype=torch.float32, device='cuda'):
    """Returns (scenario, solver) in the bench configuration (env-overridable)."""
    if solver_name not in ('v1', 'v2', 'approx'):
        raise ValueError(f'unknown solver {solver_name!r}: v1, v2 or approx')
    env = os.environ.get
    qp_tol = 1e-8 if dtype == torch.float64 else 3e-7
    if solver_name == 'approx':
        # the approximate (progress-augmented MPCC) duel at its measured operating point:
        # every step merit-checked (NMS frequency 1, delta0 0) with a constant reg of 1,
        # a 10-trial line search (each trial re-rolls the track geometry), 'exact'
        # evaluation through the track splines (the frozen linearisation of 'once'
        # creeps for ~400 iterations), an accurate Newton-Schulz PSD projection
        # (30 iterations, safety 1e-5, equilibrated) and the gradient-scaled KKT test
        sc = scenario or build_approximate_duel(N=horizon)
        params = DGSQPV2Params(N=sc.N, dt=sc.dt,
                               sqp_iters=int(env('DGSQP_BENCH_SQP_ITERS', 150)),
                               p_tol=1e-3, d_tol=1e-3,
                               line_search_iters=int(env('DGSQP_BENCH_LS', 10)),
                               merit_function='stat_l1',
                               merit_decrease_condition=env('DGSQP_BENCH_MERIT_COND', 'armijo'),
                               nms_frequency=int(env('DGSQP_BENCH_NMSFREQ', 1)),
                               nms_memory_size=int(env('DGSQP_BENCH_NMSMEM', 10)),
                               reg=float(env('DGSQP_BENCH_REG', 1.0)),
                               reg_decay=float(env('DGSQP_BENCH_REG_DECAY', 1.0)),
                               approximation_eval=env('DGSQP_BENCH_EVAL', 'exact'),
                               nms_initial_step_size_factor=float(env('DGSQP_BENCH_DELTA0', 0.0)),
                               conv_scaled_stat=env('DGSQP_BENCH_SCALED', '1') == '1',
                               conv_method=env('DGSQP_BENCH_CONV', 'ns'),
                               conv_ns_iters=int(env('DGSQP_BENCH_NS_ITERS', 30)),
                               conv_ns_safety=float(env('DGSQP_BENCH_NS_SAFETY', 1e-5)),
                               conv_ns_equil=env('DGSQP_BENCH_NS_EQUIL', '1') == '1',
                               nms=True, qp_tol=qp_tol,
                               stall_its=int(env('DGSQP_BENCH_STALL', 0)) or None,
                               qp_box_split=env('DGSQP_BENCH_BOX', '1') == '1',
                               qp_correctors=int(env('DGSQP_BENCH_CORR', 2)))
        solver = DGSQPV2FrenetApprox(sc.joint_model, sc.costs, sc.agent_constraints,
                                     sc.shared_constraints, sc.bounds, params,
                                     print_method=None, dtype=dtype, device=device)
        return sc, solver
    sc = scenario or build_chicane_scenario(N=horizon, theta_deg=45.0)
    if solver_name == 'v2':
        # the exact game's NMS operating point: the journal's NMS knobs (freq=10,
        # mem=10, delta0=20: blind d-steps tolerate the merit excursion of productive
        # full Newton steps) with small, constant regularization
        params = DGSQPV2Params(N=sc.N, dt=sc.dt,
                               reg=float(env('DGSQP_BENCH_REG', 1e-3)),
                               reg_decay=float(env('DGSQP_BENCH_REG_DECAY', 1.0)),
                               nms=True,
                               nms_frequency=int(env('DGSQP_BENCH_NMSFREQ', 10)),
                               nms_memory_size=int(env('DGSQP_BENCH_NMSMEM', 10)),
                               nms_initial_step_size_factor=float(
                                   env('DGSQP_BENCH_DELTA0', 20.0)),
                               sqp_iters=int(env('DGSQP_BENCH_SQP_ITERS', 100)),
                               p_tol=1e-3, d_tol=1e-3, merit_decrease=0.01,
                               merit_decrease_condition=env('DGSQP_BENCH_MERIT_COND', 'armijo'),
                               qp_tol=qp_tol,
                               conv_method=env('DGSQP_BENCH_CONV', 'ns'),
                               stall_its=int(env('DGSQP_BENCH_STALL', 15)) or None,
                               hessian_mode=env('DGSQP_BENCH_HESS', 'ad'),
                               qp_box_split=env('DGSQP_BENCH_BOX', '1') == '1',
                               qp_correctors=int(env('DGSQP_BENCH_CORR', 2)))
        solver = DGSQPV2(sc.joint_model, sc.costs, sc.agent_constraints,
                         sc.shared_constraints, sc.bounds, params, print_method=None,
                         dtype=dtype, device=device)
        return sc, solver
    params = DGSQPParams(N=sc.N, dt=sc.dt, reg=1e-3,
                         nonmono_ls=env('DGSQP_BENCH_NMLS', '1') == '1',
                         line_search_iters=int(env('DGSQP_BENCH_LS', 20)),
                         sqp_iters=int(env('DGSQP_BENCH_SQP_ITERS', 50)),
                         p_tol=1e-3, d_tol=1e-3,
                         beta=0.01, tau=0.5, qp_tol=qp_tol,
                         qp_max_iters=int(env('DGSQP_BENCH_QP_ITERS', 25)),
                         qp_solves_limit=int(env('DGSQP_BENCH_QP_BUDGET', 100)),
                         conv_method=env('DGSQP_BENCH_CONV', 'ns'),
                         qp_polish_iters=int(env('DGSQP_BENCH_POLISH', 4)),
                         stall_its=int(env('DGSQP_BENCH_STALL', 15)) or None,
                         qp_warm_start=env('DGSQP_BENCH_QP_WS', '1') == '1',
                         qp_box_split=env('DGSQP_BENCH_BOX', '1') == '1',
                         qp_correctors=int(env('DGSQP_BENCH_CORR', 2)),
                         hessian_mode=env('DGSQP_BENCH_HESS', 'ad'))
    solver = DGSQP(sc.joint_model, sc.costs, sc.agent_constraints, sc.shared_constraints,
                   sc.bounds, params, print_method=None, dtype=dtype, device=device)
    return sc, solver


def build_bench_batch(sc, solver, batch: int, seed: int = 0):
    """Sample and warm-start the bench batch; returns (u0, l0, x0, up) on the solver's
    device in its dtype."""
    dtype, device = solver.dtype, solver.device
    x0, u_ws, _, _ = sample_duel_initial_conditions(sc, batch, seed=seed, dtype=dtype,
                                                    device=device)
    u_ws = torch.as_tensor(u_ws, dtype=dtype, device=device)
    u0 = solver.problem.stage_to_u(u_ws)
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    up = torch.zeros(batch, sc.joint_model.n_u, dtype=dtype, device=device)
    up = seed_virtual_rate_prev(up, u_ws[:, 0, :], sc.joint_model)
    # an approximate-game solver builds its parameter pytree from the warm start first
    l0 = _dual_warm_start(solver, u0, x0, up)
    return u0, l0, x0, up
