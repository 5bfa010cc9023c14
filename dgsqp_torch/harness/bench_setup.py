"""Construction of the flagship bench problem (chicane duel, DGSQP v1 or v2), ported
from the v1 and v2 branches of ``dgsqp_tpu/harness/bench_setup.py``.

The same environment knobs set the same parameters as in the JAX package, and the QP
tolerance follows the same rule: 1e-8 in float64, 3e-7 in float32.
"""
from __future__ import annotations

import os

import torch

from dgsqp_torch.harness.samplers import sample_duel_initial_conditions
from dgsqp_torch.harness.scenarios import build_chicane_scenario
from dgsqp_torch.harness.warm_start import seed_virtual_rate_prev
from dgsqp_torch.solvers.dgsqp import DGSQP
from dgsqp_torch.solvers.dgsqp_v2 import DGSQPV2
from dgsqp_torch.solvers.solver_types import DGSQPParams, DGSQPV2Params


def build_bench_solver(horizon: int = 25, solver_name: str = 'v1', scenario=None,
                       dtype=torch.float32, device='cuda'):
    """Returns (scenario, solver) in the bench configuration (env-overridable)."""
    if solver_name not in ('v1', 'v2'):
        raise NotImplementedError(f'solver {solver_name!r} is not ported; only v1 and v2')
    env = os.environ.get
    qp_tol = 1e-8 if dtype == torch.float64 else 3e-7
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
    l0 = solver.problem.dual_warm_start(u0, x0, up)
    return u0, l0, x0, up
