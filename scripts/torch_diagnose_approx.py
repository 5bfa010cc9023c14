#!/usr/bin/env python3
"""Per-iteration diagnosis of the approximate (MPCC) game at the bench configuration,
on the port.

The counterpart of ``scripts/diagnose_approx.py``: trace a small batch of bench-sampled
games through the bench solver (``DGSQPV2FrenetApprox``; with ``--solver v2`` or ``v1``
the exact chicane game) at several (reg_init, reg_decay) points of the reference
regularization study, printing each game's stationarity and feasibility trajectory
(``solve_batch_traced``).

Usage:
    python3 scripts/torch_diagnose_approx.py [--N 25] [--batch 4]
    python3 scripts/torch_diagnose_approx.py --device cpu --dtype float64 --N 5 \\
        --batch 2 --iters 4 --configs 1:0.8        # a rehearsal on the CPU
"""
import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--N', type=int, default=25)
    ap.add_argument('--batch', type=int, default=4)
    ap.add_argument('--iters', type=int, default=200)
    ap.add_argument('--eval_type', default='once')
    ap.add_argument('--solver', default='approx', choices=['approx', 'v2', 'v1'],
                    help='approx = MPCC formulation; v2 = exact game, v2 engine')
    ap.add_argument('--configs', default='100:0.95,10:0.8,1:0.8,0:1.0')
    ap.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    ap.add_argument('--dtype', default='float32', choices=['float32', 'float64'])
    args = ap.parse_args(argv)

    import torch
    from dgsqp_torch.harness.bench_setup import build_bench_batch, build_bench_solver

    dtype = getattr(torch, args.dtype)
    if args.solver == 'approx':
        from dgsqp_torch.harness.scenarios import build_approximate_duel
        sc = build_approximate_duel(N=args.N)
    else:
        from dgsqp_torch.harness.scenarios import build_chicane_scenario
        sc = build_chicane_scenario(N=args.N, theta_deg=45.0)
    for cfg in args.configs.split(','):
        reg, decay = (float(v) for v in cfg.split(':'))
        os.environ['DGSQP_BENCH_REG'] = str(reg)
        os.environ['DGSQP_BENCH_REG_DECAY'] = str(decay)
        os.environ['DGSQP_BENCH_EVAL'] = args.eval_type
        _, solver = build_bench_solver(horizon=args.N, solver_name=args.solver, scenario=sc,
                                       dtype=dtype, device=args.device)
        batch = build_bench_batch(sc, solver, args.batch, seed=0)
        res, trace = solver.solve_batch_traced(*batch, num_iters=args.iters)
        stat = trace['stat'].double().cpu().numpy()
        pf = trace['p_feas'].double().cpu().numpy()
        print(f'\n=== solver={args.solver} reg={reg} decay={decay} eval={args.eval_type} ===')
        print('statuses:', res.status.tolist(), 'iters:', res.iters.tolist())
        print('final stat:', ' '.join(f'{v:.2e}' for v in res.stat.double().tolist()))
        step = max(1, args.iters // 10)
        for b in range(args.batch):
            print(f'  g{b} stat: ' + ' '.join(f'{v:9.2e}' for v in stat[b, ::step]))
            print(f'  g{b} feas: ' + ' '.join(f'{v:9.2e}' for v in pf[b, ::step]))
        sys.stdout.flush()


if __name__ == '__main__':
    main()
