#!/usr/bin/env python3
"""Merge two oracle Monte-Carlo runs of the port into one adjudication pickle.

The counterpart of ``scripts/merge_oracles.py``, on the pickles that
``scripts/torch_monte_carlo_main.py`` writes (``MCResults`` of ``dgsqp_torch``): on the
same samples, the primary (usually the MCP oracle) where it converged, the secondary
(usually ALGAMES) elsewhere.

Usage:
    python scripts/torch_merge_oracles.py primary.pkl secondary.pkl merged.pkl
"""
import pickle
import sys
from dataclasses import replace
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from dgsqp_torch.harness.mc_study import MCResults  # noqa: F401  (unpickling)
from dgsqp_torch.solvers.dgsqp import CONV_ABS, CONV_REL


def merge(a, b, success: str = 'abs'):
    """``a`` where it converged, else ``b`` where it converged, else ``a``."""
    ok = (CONV_ABS,) if success == 'abs' else (CONV_ABS, CONV_REL)
    assert a.num_samples == b.num_samples
    assert np.allclose(a.x0, b.x0, atol=1e-6), 'oracle runs sampled different ICs'
    pa, pb = getattr(a, 'provenance', None), getattr(b, 'provenance', None)
    if pa and pb:
        # the runs must share precision and seed, not only their initial conditions: a
        # float32/float64 merge would blend two KKT accuracies
        for k in ('dtype', 'seed'):
            assert pa.get(k) == pb.get(k), \
                f'oracle provenance mismatch on {k!r}: {pa.get(k)} vs {pb.get(k)}'
    use_a = np.isin(a.statuses, ok)
    take_b = ~use_a & np.isin(b.statuses, ok)
    statuses = np.where(use_a, a.statuses, np.where(take_b, b.statuses, a.statuses))
    u_sol = np.where(use_a[:, None], a.u_sol, np.where(take_b[:, None], b.u_sol, a.u_sol))
    merged = replace(a, solver=f'{a.solver}+{b.solver}', statuses=statuses, u_sol=u_sol)
    n_a, n_b = int(use_a.sum()), int(take_b.sum())
    print(f'merged: {n_a} from {a.solver}, {n_b} from {b.solver}, '
          f'coverage {(n_a + n_b)}/{a.num_samples}', file=sys.stderr)
    return merged


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3:
        sys.exit('usage: python scripts/torch_merge_oracles.py primary.pkl secondary.pkl '
                 'merged.pkl')
    with open(argv[0], 'rb') as f:
        a = pickle.load(f)
    with open(argv[1], 'rb') as f:
        b = pickle.load(f)
    with open(argv[2], 'wb') as f:
        pickle.dump(merge(a, b), f)


if __name__ == '__main__':
    main()
