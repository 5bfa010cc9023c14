#!/usr/bin/env python3
"""F1 comparison-study runner of the PyTorch/CUDA port (``dgsqp_torch``), the counterpart
of ``scripts/f1_study_main.py``: the progress-augmented dynamic-bicycle approximate game
on the 20 m Austin segment, raceline-sampled initial conditions, solved as one batch by
DGSQP v2 on the approximate game (``dgsqp``) and/or the MCP oracle (``path``).

Usage:
    python scripts/torch_f1_study_main.py --n 32 --N 15 --solvers dgsqp
    python scripts/torch_f1_study_main.py --n 64 --N 15 --solvers dgsqp path \\
        --out build/f1_study_N15.json
    python scripts/torch_f1_study_main.py --device cpu --dtype float64 --n 1 --N 3 \\
        --sqp_iters 40

The report JSON holds, per solver, the counts, success rate, wall time of the solve and
iterations.  DGSQP runs in float32 and the MCP oracle in float64 unless ``--dtype`` says
otherwise, as in ``scripts/torch_monte_carlo_main.py``; in float32 the QP tolerance is
3e-7, as in the other study scripts.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--n', type=int, default=32)
    ap.add_argument('--N', type=int, default=15)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--solvers', nargs='+', default=['dgsqp'], choices=['dgsqp', 'path'])
    ap.add_argument('--sqp_iters', type=int, default=150)
    ap.add_argument('--eval_type', default='exact', choices=['always', 'once', 'exact'])
    ap.add_argument('--dtype', default=None, choices=['float32', 'float64'],
                    help='float32 for dgsqp, float64 for path')
    ap.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    ap.add_argument('--out', default='build/f1_study.json')
    args = ap.parse_args(argv)

    import torch

    from dgsqp_torch.harness.f1_study import (build_f1_scenario, f1_solver_params,
                                              run_f1_study)

    sc = build_f1_scenario(N=args.N)
    report = {'N': args.N, 'n': args.n, 'seed': args.seed, 'results': {}}
    for solver in args.solvers:
        # the oracle certifies a small residual of an ill-conditioned system, which
        # float32 cannot carry
        dtype = getattr(torch, args.dtype or ('float64' if solver == 'path' else 'float32'))
        # a float32 QP cannot certify the parameters' default 1e-8 (see build_bench_solver)
        qp_tol = 1e-8 if dtype == torch.float64 else 3e-7
        params = f1_solver_params(args.N, sqp_iters=args.sqp_iters,
                                  approximation_eval=args.eval_type, qp_tol=qp_tol) \
            if solver == 'dgsqp' else None
        out = run_f1_study(N=args.N, num_samples=args.n, seed=args.seed, solver=solver,
                           params=params, scenario=sc, dtype=dtype, device=args.device)
        for key in ('u_sol', 'x0', 'iters'):
            out.pop(key)
        out['statuses'] = ''.join(str(int(s)) for s in out['statuses'])
        out['dtype'] = str(dtype).split('.')[-1]
        if args.device != 'cpu':
            out['device_name'] = torch.cuda.get_device_name(torch.device(args.device))
        report['results'][solver] = out
        print(f'# {solver}: {out}', file=sys.stderr, flush=True)

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=2, default=str))
    print(json.dumps(report, indent=2, default=str))


if __name__ == '__main__':
    main()
