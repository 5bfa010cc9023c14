#!/usr/bin/env python3
"""A/B harness for the MCP baseline's globalization knobs on the chicane suite, on the
port.

The counterpart of ``scripts/mcp_tune.py``: the same sampled batch (chicane duel, seed
0) through each ``PATHMCP`` configuration, one line a configuration with its
convergence count, statuses, iterations and the residuals of the games it did not
solve.  The environment picks the batch and the configurations as in the JAX script:
``B`` (32), ``N`` (15), ``TOL`` (1e-3), ``CONFIGS`` (comma-separated names, default
all), ``IBR_WS=1`` (refine the warm start with one IBR sweep); ``DGSQP_DEVICE``
(``cuda``) and ``DGSQP_X64`` (``1``: float64) choose where and in what it runs.

Usage:
    CONFIGS=default,hybrid python3 scripts/torch_mcp_tune.py
"""
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

CONFIGS = {
    'default': {},
    'plain-fb': dict(fb_lambda=1.0),
    'lam0.8': dict(fb_lambda=0.8),
    'lam0.6': dict(fb_lambda=0.6),
    'mem16': dict(nonmono_memory=16),
    'mem3': dict(nonmono_memory=3),
    'no-restart': dict(max_restarts=0),
    'stall12': dict(stall_its=12),
    'restarts8': dict(max_restarts=8, stall_its=4),
    'pert0.1': dict(pert0=0.1),
    'iters400': dict(max_iters=400),
    'combo1': dict(fb_lambda=0.8, nonmono_memory=16, pert0=0.1),
    'combo2': dict(fb_lambda=0.8, pert0=0.1, max_restarts=8, max_iters=400),
    'combo3': dict(fb_lambda=0.8, nonmono_memory=16),
    'combo4': dict(fb_lambda=0.8, pert0=0.1),
    'eps-off': dict(eps0=1e-9),
    'eps1e-1': dict(eps0=1e-1),
    'eps3e-1': dict(eps0=3e-1),
    'eps1e0': dict(eps0=1.0),
    'eps1e-1-slow': dict(eps0=1e-1, eps_decay=0.9),
    'eps1e0-slow': dict(eps0=1.0, eps_decay=0.9, eps_frac=0.2),
    'eps1e0-plainfb': dict(eps0=1.0, eps_decay=0.9, eps_frac=0.2, fb_lambda=1.0),
    'patient': dict(stall_its=50, max_restarts=2, max_iters=500),
    'patient-eps': dict(stall_its=50, max_restarts=2, max_iters=500, eps0=1.0,
                        eps_decay=0.9, eps_frac=0.2),
    'patient-tol2': dict(stall_its=50, max_restarts=2, max_iters=500),
    'josephy': dict(method='josephy'),
    'josephy-stall12': dict(method='josephy', stall_its=12),
    'josephy-g2': dict(method='josephy', jos_gamma=2.0),
    'josephy-g1.2': dict(method='josephy', jos_gamma=1.2),
    'josephy-stall10': dict(method='josephy', stall_its=10, max_restarts=6),
    'fbnewton': dict(method='fbnewton'),
    'hybrid': dict(method='hybrid'),
    'hybrid-g1.5': dict(method='hybrid', jos_gamma=1.5),
    'hybrid-stall10': dict(method='hybrid', stall_its=10, max_restarts=6),
}


def summary_line(name, res, solved_code):
    """One configuration's line: convergence, statuses, iterations, failed residuals."""
    st, iters = res.status.cpu().numpy(), res.iters.cpu().numpy()
    resid = res.res.double().cpu().numpy()
    conv = int((st == solved_code).sum())
    fail = resid[st != solved_code]
    fail_p = (f'fail res p10/p50/p90 = {np.percentile(fail, 10):.2e}/'
              f'{np.percentile(fail, 50):.2e}/{np.percentile(fail, 90):.2e}'
              if fail.size else 'all solved')
    counts = dict(zip(*[a.tolist() for a in np.unique(st, return_counts=True)]))
    return (f'{name:12s} conv {conv}/{st.size}  statuses {counts}  '
            f'iters p50={np.median(iters):.0f} max={iters.max()}  {fail_p}')


def main():
    import torch
    from dgsqp_torch.harness.samplers import sample_duel_initial_conditions
    from dgsqp_torch.harness.scenarios import build_chicane_scenario
    from dgsqp_torch.solvers.mcp import PATHMCP, SOLVED
    from dgsqp_torch.solvers.solver_types import PATHMCPParams

    device = os.environ.get('DGSQP_DEVICE', 'cuda')
    dtype = torch.float64 if os.environ.get('DGSQP_X64', '1') == '1' else torch.float32
    B = int(os.environ.get('B', 32))
    N = int(os.environ.get('N', 15))
    tol = float(os.environ.get('TOL', 1e-3))
    sc = build_chicane_scenario(N=N, theta_deg=45.0)
    configs = CONFIGS
    sel = os.environ.get('CONFIGS')
    if sel:
        configs = {k: v for k, v in configs.items() if k in sel.split(',')}

    batch = None
    for name, kw in configs.items():
        solver = PATHMCP(sc.joint_model, sc.costs, sc.agent_constraints,
                         sc.shared_constraints, sc.bounds,
                         PATHMCPParams(N=sc.N, dt=sc.dt, tol=tol, **kw), print_method=None,
                         dtype=dtype, device=device)
        if batch is None:
            x0_h, u_ws, _, _ = sample_duel_initial_conditions(sc, B, seed=0, dtype=dtype,
                                                              device=device)
            u0 = solver.problem.stage_to_u(torch.as_tensor(u_ws, dtype=dtype, device=device))
            x0 = torch.as_tensor(x0_h, dtype=dtype, device=device)
            up = torch.zeros(B, sc.joint_model.n_u, dtype=dtype, device=device)
            if os.environ.get('IBR_WS', '0') == '1':
                from dgsqp_torch.solvers.ibr import IBR
                from dgsqp_torch.solvers.solver_types import IBRParams
                ibr = IBR(sc.joint_model, sc.costs, sc.agent_constraints,
                          sc.shared_constraints, sc.bounds,
                          IBRParams(N=sc.N, dt=sc.dt, ibr_iters=1, p_tol=1e-3, d_tol=1e-3),
                          print_method=None, dtype=dtype, device=device)
                u0 = ibr._solve_core(u0, x0, up).u
            batch = (u0, solver.problem.dual_warm_start(u0, x0, up), x0, up)
        print(summary_line(name, solver.solve_batch(*batch), SOLVED), flush=True)


if __name__ == '__main__':
    main()
