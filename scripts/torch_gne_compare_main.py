#!/usr/bin/env python3
"""Cross-solver / cross-formulation GNE agreement of two studies of the PyTorch/CUDA port.

The counterpart of ``scripts/gne_compare_main.py``: loads two ``MCResults`` pickles
written by ``scripts/torch_monte_carlo_main.py`` on the same scenario and seed and
reports the normalized-MSE distribution, the equilibrium-match rate (the >= 95%
agreement criterion) and where the two disagree (``dgsqp_torch.harness.analysis.
gne_compare``).  It reads only the pickles, on the CPU.

Usage (two agents; three for the merge, with one scale per input channel):
    python scripts/torch_gne_compare_main.py results/chicane_dgsqp.pkl \\
        results/chicane_mcp.pkl --N 25 --num_ua 2 2 --scale 2.1 0.436 2.1 0.436
    python scripts/torch_gne_compare_main.py results/merge_dgsqp.pkl \\
        results/merge_mcp.pkl --N 20 --num_ua 2 2 2 --scale 2.1 0.436 2.1 0.436 2.1 0.436
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import argparse
import json
import pickle

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('pkl_a')
    ap.add_argument('pkl_b')
    ap.add_argument('--N', type=int, required=True)
    ap.add_argument('--num_ua', type=int, nargs='+', default=[2, 2])
    ap.add_argument('--layout_a', default='agent_flat', choices=['agent_flat', 'stage'])
    ap.add_argument('--layout_b', default='agent_flat', choices=['agent_flat', 'stage'],
                    help="'stage' for an ALGAMES study (its inputs are stage-major)")
    ap.add_argument('--scale', type=float, nargs='+', default=None,
                    help='per-channel input normalization, one value per input channel '
                         '(e.g. 2.1 0.436 per agent)')
    ap.add_argument('--match_tol', type=float, default=0.1)
    ap.add_argument('--success', default='abs', choices=['abs', 'any'])
    # cross-formulation comparison (exact vs progress-augmented): select the shared
    # input channels, e.g. --num_ua_b 3 3 --keep_cols_b 0 1 3 4 drops the arc-speed
    # channel of a progress-augmented run
    ap.add_argument('--num_ua_b', type=int, nargs='+', default=None)
    ap.add_argument('--keep_cols_a', type=int, nargs='+', default=None)
    ap.add_argument('--keep_cols_b', type=int, nargs='+', default=None)
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    channels = len(args.keep_cols_a) if args.keep_cols_a else sum(args.num_ua)
    if args.scale is not None and len(args.scale) != channels:
        ap.error(f'--scale takes one value per input channel: {channels} here, '
                 f'{len(args.scale)} given')

    from dgsqp_torch.harness.analysis import gne_compare

    with open(args.pkl_a, 'rb') as f:
        res_a = pickle.load(f)
    with open(args.pkl_b, 'rb') as f:
        res_b = pickle.load(f)

    if res_a.x0.shape != res_b.x0.shape:
        print('NOTE: different state layouts (cross-formulation comparison): samples '
              'aligned by index/seed', file=sys.stderr)
    elif not np.allclose(res_a.x0, res_b.x0, atol=1e-9):
        print('WARNING: the two runs have different initial conditions: the comparison '
              'is sample-aligned by index only', file=sys.stderr)

    rep = gne_compare(res_a, res_b, N=args.N, num_ua=args.num_ua,
                      layout_a=args.layout_a, layout_b=args.layout_b,
                      input_scale=args.scale, match_tol=args.match_tol,
                      success=args.success, num_ua_b=args.num_ua_b,
                      keep_cols_a=args.keep_cols_a, keep_cols_b=args.keep_cols_b)
    rep['solver_a'] = res_a.solver
    rep['solver_b'] = res_b.solver
    txt = json.dumps(rep, indent=2)
    print(txt)
    if args.out:
        Path(args.out).write_text(txt)


if __name__ == '__main__':
    main()
