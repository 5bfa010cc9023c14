#!/usr/bin/env python3
"""Monte-Carlo study dispatcher of the PyTorch/CUDA port (``dgsqp_torch``).

The counterpart of ``scripts/monte_carlo_main.py`` for what the port holds: one argparse
entry point dispatching {scenario} x {solver}; each configuration is one batched solve
on one device.

Examples:
    python scripts/torch_monte_carlo_main.py --scenario chicane --solver dgsqp --n 200
    python scripts/torch_monte_carlo_main.py --scenario chicane --solver dgsqp_v2 --n 256
    python scripts/torch_monte_carlo_main.py --scenario agents --agents 3 --solver dgsqp_v2
    python scripts/torch_monte_carlo_main.py --scenario curve --device cpu --dtype float64 \\
        --n 8 --N 6
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import argparse
import json

# choices of scripts/monte_carlo_main.py; those outside PORTED_* exit with code 2
SCENARIOS = ['chicane', 'curve', 'merge', 'agents', 'dynamic', 'duel']
SOLVERS = ['dgsqp', 'dgsqp_v2', 'algames', 'mcp']
PORTED_SCENARIOS = ('chicane', 'curve', 'agents')
PORTED_SOLVERS = ('dgsqp', 'dgsqp_v2')


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--scenario', default='chicane', choices=SCENARIOS)
    ap.add_argument('--solver', default='dgsqp', choices=SOLVERS)
    ap.add_argument('--n', type=int, default=200, help='number of Monte-Carlo samples')
    ap.add_argument('--N', type=int, default=25, help='horizon length')
    ap.add_argument('--theta', type=float, default=45.0, help='track swept angle (deg)')
    ap.add_argument('--agents', type=int, default=3, help='agent count (agents scenario)')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--sqp_iters', type=int, default=50)
    ap.add_argument('--p_tol', type=float, default=1e-3)
    ap.add_argument('--d_tol', type=float, default=1e-3)
    ap.add_argument('--merit_function', default='stat_l1')
    ap.add_argument('--merit_decrease_condition', default='armijo')
    ap.add_argument('--conv', default=None, choices=['eigh', 'ns', 'none'],
                    help='Hessian convexification (DGSQP v1)')
    ap.add_argument('--no_nms', action='store_true')
    ap.add_argument('--reg_init', type=float, default=None)
    ap.add_argument('--reg_decay', type=float, default=None)
    ap.add_argument('--nms_frequency', type=int, default=None)
    ap.add_argument('--nms_memory', type=int, default=None)
    ap.add_argument('--delta0', type=float, default=None,
                    help='nms_initial_step_size_factor (0 = merit-check every step '
                         'incl. the first)')
    ap.add_argument('--out', default='results')
    ap.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    ap.add_argument('--dtype', default='float32', choices=['float32', 'float64'])
    ap.add_argument('--skip_existing', action='store_true',
                    help='skip configs whose output pickle already exists')
    args = ap.parse_args(argv)

    if args.scenario not in PORTED_SCENARIOS:
        print(f'scenario {args.scenario} is not ported yet', file=sys.stderr)
        sys.exit(2)
    if args.solver not in PORTED_SOLVERS:
        print(f'solver {args.solver} batched study not wired yet', file=sys.stderr)
        sys.exit(2)

    import torch

    from dgsqp_torch.harness.mc_study import analyze_results, run_mc_study, save_results
    from dgsqp_torch.harness.scenarios import (build_agents_scenario,
                                               build_chicane_scenario,
                                               build_curve_scenario)
    from dgsqp_torch.solvers.dgsqp_v2 import DGSQPV2
    from dgsqp_torch.solvers.solver_types import DGSQPParams, DGSQPV2Params

    dtype = getattr(torch, args.dtype)
    # the bench's rule (``build_bench_solver``): the parameters' default of 1e-8 is below
    # what a float32 QP can certify, and a QP that misses it counts as failed
    qp_tol = 1e-8 if dtype == torch.float64 else 3e-7
    if args.scenario == 'chicane':
        scenario = build_chicane_scenario(N=args.N, theta_deg=args.theta)
    elif args.scenario == 'curve':
        scenario = build_curve_scenario(N=args.N, theta_deg=max(args.theta, 60.0))
    else:
        scenario = build_agents_scenario(M=args.agents, N=args.N, theta_deg=args.theta)

    reg_tag = ''
    if args.reg_init is not None or args.reg_decay is not None:
        reg_tag = f'_reg{args.reg_init if args.reg_init is not None else "d"}' \
                  f'_decay{args.reg_decay if args.reg_decay is not None else "d"}'
    out_name = Path(args.out) / (f'{scenario.name}_{args.solver}_exact'
                                 f'{reg_tag}_n{args.n}_s{args.seed}.pkl')
    if args.skip_existing and out_name.exists():
        print(f'skip (exists): {out_name}', file=sys.stderr)
        return

    if args.solver == 'dgsqp':
        params = DGSQPParams(N=scenario.N, dt=scenario.dt, reg=1e-3, nonmono_ls=True,
                             line_search_iters=50, sqp_iters=args.sqp_iters,
                             p_tol=args.p_tol, d_tol=args.d_tol, beta=0.01, tau=0.5,
                             merit_function=args.merit_function, qp_tol=qp_tol)
        if args.conv:
            params.conv_method = args.conv
        res = run_mc_study(scenario, solver_params=params, num_samples=args.n,
                           seed=args.seed, dtype=dtype, device=args.device)
    else:
        params = DGSQPV2Params(N=scenario.N, dt=scenario.dt, sqp_iters=args.sqp_iters,
                               p_tol=args.p_tol, d_tol=args.d_tol,
                               merit_function=args.merit_function,
                               merit_decrease_condition=args.merit_decrease_condition,
                               nms=not args.no_nms, qp_tol=qp_tol)
        if args.reg_init is not None:
            params.reg = args.reg_init
        if args.reg_decay is not None:
            params.reg_decay = args.reg_decay
        if args.nms_frequency is not None:
            params.nms_frequency = args.nms_frequency
        if args.nms_memory is not None:
            params.nms_memory_size = args.nms_memory
        if args.delta0 is not None:
            params.nms_initial_step_size_factor = args.delta0
        res = run_mc_study(scenario, solver_params=params, num_samples=args.n,
                           seed=args.seed, solver_cls=DGSQPV2, dtype=dtype,
                           device=args.device)

    stats = analyze_results(res)
    save_results(res, out_name)
    print(json.dumps(stats, indent=2, default=str))


if __name__ == '__main__':
    main()
