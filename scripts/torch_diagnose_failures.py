#!/usr/bin/env python3
"""Classify the non-converged games of the flagship chicane bench, on the port.

The counterpart of ``scripts/diagnose_failures.py``: solve the bench batch (DGSQP v1,
chicane duel, N=25, seed 0) with ``solve_batch_chunked(chunk_iters=8)``, take every
game that did not reach ``conv_abs_tol``, re-solve them (padded to a power of two, at
least 16) with a per-iteration trace (v1's ``solve_batch_traced``, the nested machine)
and classify each failure:

  * ``stalled``      stationarity plateaued (relative change < 10%) over the last
                     third of the trace while feasible;
  * ``slow``         stationarity still decreasing at the horizon (a budget problem);
  * ``oscillating``  stationarity non-monotone with large swings (watchdog cycling);
  * ``infeasible``   primal feasibility above p_tol in the last third.

``--retries`` also re-solves the failures under five other configurations and counts
how many each converts.  The whole batch runs on the card (``--device cuda``, the
default) in float32; the JAX script cuts the batch to 16 on the CPU, this one does not.

Usage:
    python3 scripts/torch_diagnose_failures.py --batch 256 --out build/diagnosis.json
    python3 scripts/torch_diagnose_failures.py --device cpu --dtype float64 --batch 4 \\
        --horizon 6 --trace_iters 5          # a rehearsal on the CPU
"""
import argparse
import json
import sys
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

LABELS = ('stalled', 'slow', 'oscillating', 'infeasible')


def classify_trace(p_feas, comp, stat, p_tol, d_tol):
    """Label one game's (T,) trace tails."""
    T = len(stat)
    tail = slice(2 * T // 3, T)
    s_tail = stat[tail]
    if np.max(p_feas[tail]) > p_tol:
        return 'infeasible'
    # steadily improving ('slow', budget-limited) is checked before 'oscillating': a
    # monotone decreasing tail also has a large max/min ratio
    first, last = np.median(s_tail[:len(s_tail) // 2]), np.median(s_tail[len(s_tail) // 2:])
    if last < 0.7 * first:
        return 'slow'
    rng = np.max(s_tail) - np.min(s_tail)
    if np.max(s_tail) > 3 * np.min(s_tail) and rng > 0.5 * np.median(s_tail):
        return 'oscillating'
    return 'stalled'


def padded(fail: np.ndarray) -> np.ndarray:
    """The failures' indices padded to a power of two (at least 16) by repeating the
    first."""
    n_pad = max(16, 1 << (fail.size - 1).bit_length())
    return np.concatenate([fail, np.repeat(fail[:1], n_pad - fail.size)])


def trace_failures(solver, batch, fail: np.ndarray, trace_iters: int):
    """Trace the games ``fail`` of ``batch`` (padded) through ``trace_iters`` iterations
    of ``solver.solve_batch_traced``; returns (index rows traced, result, trace as
    numpy arrays cut to the failures)."""
    import torch
    pad = padded(fail)
    rows = torch.as_tensor(pad, device=batch[0].device)
    res, trace = solver.solve_batch_traced(*(a[rows] for a in batch), num_iters=trace_iters)
    return pad, res, {k: v.cpu().numpy()[:fail.size] for k, v in trace.items()}


def classify_failures(fail, trace, status, p_tol, d_tol, status_msg) -> dict:
    """The report's failure part: each failure's label and terminal quantities, the
    class counts and the terminal stationarity's percentiles."""
    labels = {}
    for i, g in enumerate(fail):
        labels[int(g)] = dict(
            label=classify_trace(trace['p_feas'][i], trace['comp'][i], trace['stat'][i],
                                 p_tol, d_tol),
            status=status_msg[int(status[g])],
            stat_final=float(trace['stat'][i, -1]),
            p_feas_final=float(trace['p_feas'][i, -1]),
            comp_final=float(trace['comp'][i, -1]),
            stat_min=float(trace['stat'][i].min()),
            qp_solves=int(trace['qp_solves'][i, -1]))
    stat_fin = np.array([v['stat_final'] for v in labels.values()])
    return dict(failure_classes=dict(Counter(v['label'] for v in labels.values())),
                failures=labels,
                stat_final_percentiles={q: float(np.percentile(stat_fin, int(q)))
                                        for q in ('10', '50', '90')})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--batch', type=int, default=256)
    ap.add_argument('--horizon', type=int, default=25)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--trace_iters', type=int, default=50)
    ap.add_argument('--retries', action='store_true', help='also run the retry sweep')
    ap.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    ap.add_argument('--dtype', default='float32', choices=['float32', 'float64'])
    ap.add_argument('--out', default='results/diagnosis.json')
    args = ap.parse_args(argv)

    import torch
    from dgsqp_torch.harness.bench_setup import build_bench_batch, build_bench_solver
    from dgsqp_torch.solvers.dgsqp import CONV_ABS, DGSQP, STATUS_MSG

    dtype = getattr(torch, args.dtype)
    sc, solver = build_bench_solver(horizon=args.horizon, dtype=dtype, device=args.device)
    batch = build_bench_batch(sc, solver, args.batch, seed=args.seed)

    print(f'# solving batch {args.batch} on {args.device}', file=sys.stderr)
    res = solver.solve_batch_chunked(*batch, chunk_iters=8)
    status = res.status.cpu().numpy()
    counts = {STATUS_MSG[int(s)]: int((status == s).sum()) for s in np.unique(status)}
    fail = np.where(status != CONV_ABS)[0]
    print(f'# {fail.size}/{args.batch} non-conv_abs games ({counts})', file=sys.stderr)
    report = {'batch': args.batch, 'device': args.device, 'dtype': args.dtype,
              'status_counts': counts}
    if fail.size:
        pad, _, trace = trace_failures(solver, batch, fail, args.trace_iters)
        print(f'# traced {fail.size} failures (padded to {pad.size}) for '
              f'{args.trace_iters} iterations', file=sys.stderr)
        p = solver.params
        report.update(classify_failures(fail, trace, status, p.p_tol, p.d_tol, STATUS_MSG))
        print(f"# failure classes: {report['failure_classes']}; terminal stationarity "
              f"p10/p50/p90 {report['stat_final_percentiles']}", file=sys.stderr)

        if args.retries:
            from dataclasses import replace
            retry_cfgs = {
                'reg1e-2': replace(p, reg=1e-2),
                'reg1e-1': replace(p, reg=1e-1),
                'merit_stat': replace(p, merit_function='stat'),  # stat_l1 is the default
                'eigh': replace(p, conv_method='eigh'),
                'iters150_budget500': replace(p, sqp_iters=150, qp_solves_limit=500),
            }
            rows = torch.as_tensor(pad, device=batch[0].device)
            conversions = {}
            for name, cfg in retry_cfgs.items():
                rslv = DGSQP(sc.joint_model, sc.costs, sc.agent_constraints,
                             sc.shared_constraints, sc.bounds, cfg, print_method=None,
                             dtype=dtype, device=args.device)
                r2 = rslv.solve_batch_chunked(*(a[rows] for a in batch), chunk_iters=8)
                conversions[name] = int((r2.status.cpu().numpy()[:fail.size]
                                         == CONV_ABS).sum())
                print(f'# retry {name}: {conversions[name]}/{fail.size} converted',
                      file=sys.stderr)
            report['retry_conversions'] = conversions

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    print(json.dumps({k: v for k, v in report.items() if k != 'failures'}))


if __name__ == '__main__':
    main()
