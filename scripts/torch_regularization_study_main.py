#!/usr/bin/env python3
"""In-process regularization sweep of the approximate (MPCC) game, on the port.

The counterpart of ``scripts/regularization_study_main.py``: a reg_init x reg_decay
grid under the ``--evals`` cadences (plus the unregularized cell), ``--m`` samples a
cell, each cell one batched solve of ``DGSQPV2FrenetApprox`` on one device, every cell
on the same sampled games.  Writes ``regularization_sweep.json`` in ``--out`` (one row
a cell: conv_abs, conv incl. rel, iterations, wall time, status counts).

Usage:
    python3 scripts/torch_regularization_study_main.py --m 64 --N 25 \\
        --out build/regularization
    python3 scripts/torch_regularization_study_main.py --device cpu --dtype float64 \\
        --m 2 --N 5 --regs 1 --decays 0.8 --evals once --sqp_iters 3 \\
        --out build/reg_cpu                      # a rehearsal on the CPU
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def cells_of(evals, regs, decays, include_reg0: bool):
    cells = []
    for ev in evals:
        cells += [(ev, reg, decay) for reg in regs for decay in decays]
        if include_reg0:
            cells.append((ev, 0.0, 1.0))
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--m', type=int, default=64, help='samples per cell')
    ap.add_argument('--N', type=int, default=25)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--evals', nargs='+', default=['once', 'always'])
    ap.add_argument('--regs', nargs='+', type=float, default=[1.0, 100.0, 1000.0])
    ap.add_argument('--decays', nargs='+', type=float, default=[0.5, 0.8, 0.95, 1.0])
    ap.add_argument('--no_reg0', action='store_true',
                    help='leave out the unregularized cell of each cadence')
    ap.add_argument('--sqp_iters', type=int, default=150)
    ap.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    ap.add_argument('--dtype', default='float32', choices=['float32', 'float64'])
    ap.add_argument('--out', default='results/regularization')
    args = ap.parse_args(argv)

    import torch
    from dgsqp_torch.harness.mc_study import _dual_warm_start, run_provenance
    from dgsqp_torch.harness.samplers import sample_duel_initial_conditions
    from dgsqp_torch.harness.scenarios import build_approximate_duel
    from dgsqp_torch.harness.warm_start import seed_virtual_rate_prev
    from dgsqp_torch.solvers.dgsqp import CONV_ABS, CONV_REL, STATUS_MSG
    from dgsqp_torch.solvers.dgsqp_v2_frenet import DGSQPV2FrenetApprox
    from dgsqp_torch.solvers.solver_types import DGSQPV2Params

    dtype, device = getattr(torch, args.dtype), args.device
    sc = build_approximate_duel(N=args.N)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    cells = cells_of(args.evals, args.regs, args.decays, not args.no_reg0)
    # sampled once: every cell sees the same games
    x0_np, u_ws, _, _ = sample_duel_initial_conditions(sc, args.m, seed=args.seed,
                                                       dtype=dtype, device=device)
    u_ws = torch.as_tensor(u_ws, dtype=dtype, device=device)
    x0 = torch.as_tensor(x0_np, dtype=dtype, device=device)
    up = seed_virtual_rate_prev(torch.zeros(args.m, sc.joint_model.n_u, dtype=dtype,
                                            device=device), u_ws[:, 0, :], sc.joint_model)
    rows = []
    for ci, (ev, reg, decay) in enumerate(cells):
        params = DGSQPV2Params(N=sc.N, dt=sc.dt, sqp_iters=args.sqp_iters, p_tol=1e-3,
                               d_tol=1e-3, merit_function='stat_l1',
                               merit_decrease_condition='armijo', approximation_eval=ev,
                               reg=reg, reg_decay=decay, nms_frequency=1,
                               nms_memory_size=10, nms_initial_step_size_factor=0.0,
                               conv_scaled_stat=True, conv_method='eigh', nms=True,
                               qp_tol=1e-8 if dtype == torch.float64 else 3e-7)
        solver = DGSQPV2FrenetApprox(sc.joint_model, sc.costs, sc.agent_constraints,
                                     sc.shared_constraints, sc.bounds, params,
                                     print_method=None, dtype=dtype, device=device)
        u0 = solver.problem.stage_to_u(u_ws)
        l0 = _dual_warm_start(solver, u0, x0, up)
        t0 = time.time()
        res = solver.solve_batch_chunked(u0, l0, x0, up)
        if device != 'cpu':
            torch.cuda.synchronize()
        wall = time.time() - t0
        st, iters = res.status.cpu().numpy(), res.iters.cpu().numpy()
        conv_any = np.isin(st, (CONV_ABS, CONV_REL))
        row = dict(eval=ev, reg=reg, decay=decay, m=args.m,
                   conv_abs=int((st == CONV_ABS).sum()), conv_incl_rel=int(conv_any.sum()),
                   mean_iters=float(iters[conv_any].mean()) if conv_any.any() else None,
                   max_iters=int(iters.max()), wall_s=round(wall, 1),
                   status_counts={STATUS_MSG.get(int(s), str(s)): int((st == s).sum())
                                  for s in np.unique(st)})
        rows.append(row)
        print(f'[{ci + 1}/{len(cells)}] {json.dumps(row)}', flush=True)

    report = dict(rows=rows, N=args.N, m=args.m, seed=args.seed,
                  provenance=run_provenance(solver, seed=args.seed))
    (out_dir / 'regularization_sweep.json').write_text(json.dumps(report, indent=2,
                                                                  default=str))
    print(f'# wrote {out_dir / "regularization_sweep.json"}')


if __name__ == '__main__':
    main()
