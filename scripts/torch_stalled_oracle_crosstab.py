#!/usr/bin/env python3
"""Per-game cross-tab of the flagship bench's failures against independent oracles, on
the port.

The counterpart of ``scripts/stalled_oracle_crosstab.py``: solve the first ``--n``
bench games (chicane duel, N=25, seed 0) in the bench configuration (DGSQP v1,
``solve_batch_chunked(chunk_iters=4)``), align the oracle runs' samples (the pickles
``scripts/torch_monte_carlo_main.py`` writes, e.g. ``--solver mcp --n 128``) to the
bench's games by initial state, and count for the games the bench does not bring to
``conv_abs_tol`` whether an oracle does.  The JAX package's record of this study is
``docs/stalled_oracle_crosstab_r5.json``.

Usage:
    python3 scripts/torch_stalled_oracle_crosstab.py \\
        --oracles results/chicane_mcp_exact_n128_s0.pkl --n 128 \\
        --out build/stalled_oracle_crosstab.json
"""
import argparse
import json
import pickle
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def crosstab(bench_status, bench_x0, oracles, status_msg, conv_abs):
    """The report: ``oracles`` maps a path to its ``MCResults``; a bench game is
    covered by an oracle whose sample starts within 1e-5 of it."""
    n = bench_status.size
    conv_by, covered = {}, np.zeros(n, bool)
    aligned = {}
    for path, o in oracles.items():
        d = np.linalg.norm(bench_x0[:, None, :] - o.x0[None, :, :], axis=-1)
        j = d.argmin(axis=1)
        hit = d[np.arange(n), j] < 1e-5
        conv = np.zeros(n, bool)
        conv[hit] = np.isin(o.statuses[j[hit]], (conv_abs,))
        covered |= hit
        aligned[str(path)] = int(hit.sum())
        conv_by[o.solver] = conv_by.get(o.solver, np.zeros(n, bool)) | conv
    oracle_any = np.zeros(n, bool)
    for conv in conv_by.values():
        oracle_any |= conv
    fail = (bench_status != conv_abs) & covered
    rows = [dict(sample=int(i), bench_status=status_msg.get(int(bench_status[i]), '?'),
                 **{k: bool(v[i]) for k, v in conv_by.items()})
            for i in np.where(fail)[0]]
    return dict(n=n, aligned=int(covered.sum()), aligned_by_file=aligned,
                bench_conv_abs=int((bench_status == conv_abs).sum()),
                bench_failures=int(fail.sum()),
                failures_oracle_solved=int((fail & oracle_any).sum()),
                failures_oracle_also_fails=int((fail & ~oracle_any).sum()),
                oracle_conv_counts={k: int(v.sum()) for k, v in conv_by.items()},
                per_failure=rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--oracles', nargs='+', required=True)
    ap.add_argument('--n', type=int, default=128)
    ap.add_argument('--horizon', type=int, default=25)
    ap.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    ap.add_argument('--dtype', default='float32', choices=['float32', 'float64'])
    ap.add_argument('--out', default='results/stalled_oracle_crosstab.json')
    args = ap.parse_args(argv)

    import torch
    from dgsqp_torch.harness.bench_setup import build_bench_batch, build_bench_solver
    from dgsqp_torch.harness.mc_study import MCResults  # noqa: F401  (unpickling)
    from dgsqp_torch.solvers.dgsqp import CONV_ABS, STATUS_MSG

    sc, solver = build_bench_solver(horizon=args.horizon, solver_name='v1',
                                    dtype=getattr(torch, args.dtype), device=args.device)
    u0, l0, x0, up = build_bench_batch(sc, solver, args.n, seed=0)
    res = solver.solve_batch_chunked(u0, l0, x0, up, chunk_iters=4)
    oracles = {}
    for p in args.oracles:
        with open(p, 'rb') as f:
            oracles[p] = pickle.load(f)
    report = crosstab(res.status.cpu().numpy(), x0.double().cpu().numpy(), oracles,
                      STATUS_MSG, CONV_ABS)
    for p, k in report['aligned_by_file'].items():
        print(f'# {p}: aligned {k}/{args.n} bench samples', file=sys.stderr)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    print(json.dumps({k: v for k, v in report.items() if k != 'per_failure'}, indent=2))


if __name__ == '__main__':
    main()
