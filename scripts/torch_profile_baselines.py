#!/usr/bin/env python3
"""Where an iteration of each baseline's solve goes, on the card.

Times the pieces of a few iterations of each baseline at the sizes ``chip_smoke.py``
runs them, with a device synchronization around every timed call:

* the MCP oracle (``PATHMCP``, ``method='hybrid'``, 3 iterations a phase) on the 128
  chicane games (N=25) of the equilibrium-match study in float64: ``evaluate`` with the
  Hessian, the Josephy QP (``solve_qp``), the residual/merit grid (``merit_terms``);
* IBR best-response SQP steps (agent 0, 3 steps) on the 256-game float32 bench batch
  and on its first 64 games: the forward-over-reverse Hessian, the convexification, the
  QP, the line search;
* ALGAMES (2 outer iterations) on the first 16 games in float64: the Newton system (the
  basis pushes), the Newton solve, the line search;
* ``torch.linalg.eigh`` at the convexification's shapes.

Run from the repo root on a machine with the card:

    python3 scripts/torch_profile_baselines.py [--out build/profile_baselines.json]

Prints one JSON object (seconds per call and call counts per piece) and writes it to
``--out`` when given.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import argparse
import json
import time


class Timers:
    """Wall time per named call with a device synchronization around it; a call made
    inside another timed call of the same name is not counted twice."""

    def __init__(self):
        self.t = {}
        self.depth = {}

    def wrap(self, owner, name, label=None):
        import torch
        fn = getattr(owner, name)
        label = label or name

        def timed(*a, **k):
            if self.depth.get(label):
                return fn(*a, **k)
            self.depth[label] = 1
            torch.cuda.synchronize()
            t0 = time.time()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                e = self.t.setdefault(label, [0.0, 0])
                e[0] += time.time() - t0
                e[1] += 1
                self.depth[label] = 0
        setattr(owner, name, timed)
        return fn

    def report(self):
        out = {k: {'s_per_call': v[0] / v[1], 'calls': v[1]} for k, v in self.t.items()}
        self.t = {}
        return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    import torch
    from chip_smoke import gpu_name_and_limit
    if not torch.cuda.is_available():
        print('torch_profile_baselines: needs the card', file=sys.stderr)
        sys.exit(2)
    from dgsqp_torch.harness import mc_study
    from dgsqp_torch.harness.bench_setup import build_bench_batch, build_bench_solver
    from dgsqp_torch.harness.scenarios import (build_chicane_scenario,
                                               joint_constraints_for_algames)
    from dgsqp_torch.harness.warm_start import seed_virtual_rate_prev
    from dgsqp_torch.ops import linalg
    from dgsqp_torch.solvers import algames, game_problem, ibr, mcp
    from dgsqp_torch.solvers.solver_types import ALGAMESParams, IBRParams, PATHMCPParams

    torch.backends.cuda.matmul.allow_tf32 = False
    linalg.build_kernels()
    card = gpu_name_and_limit()
    sc = build_chicane_scenario(N=25, theta_deg=45.0)
    f64, cuda = torch.float64, 'cuda'
    T = Timers()
    report = {'card': card}

    # --- the MCP oracle at the study's 128 games
    x0, u_ws, _, _ = mc_study._sample(sc, 128, 0, f64, cuda)
    x0 = torch.as_tensor(x0, dtype=f64, device=cuda)
    u_ws = torch.as_tensor(u_ws, dtype=f64, device=cuda)
    solver = mcp.PATHMCP(sc.joint_model, sc.costs, sc.agent_constraints,
                         sc.shared_constraints, sc.bounds,
                         PATHMCPParams(N=sc.N, dt=sc.dt, tol=1e-3, method='hybrid',
                                       max_iters=3, max_restarts=4),
                         print_method=None, dtype=f64)
    u0 = solver.problem.stage_to_u(u_ws)
    up = seed_virtual_rate_prev(torch.zeros(128, sc.joint_model.n_u, dtype=f64, device=cuda),
                                u_ws[:, 0, :], sc.joint_model)
    l0 = mc_study._dual_warm_start(solver, u0, x0, up)
    solver.solve_batch(u0[:16], l0[:16], x0[:16], up[:16], max_iters=1)      # warm-up
    restore = [(game_problem.GameProblem, 'evaluate', T.wrap(game_problem.GameProblem, 'evaluate')),
               (game_problem.GameProblem, 'merit_terms',
                T.wrap(game_problem.GameProblem, 'merit_terms')),
               (mcp, 'solve_qp', T.wrap(mcp, 'solve_qp')),
               (mcp.PATHMCP, '_jos_body', T.wrap(mcp.PATHMCP, '_jos_body', 'josephy_iteration')),
               (mcp.PATHMCP, '_fb_body', T.wrap(mcp.PATHMCP, '_fb_body', 'fb_iteration'))]
    solver.solve_batch(u0, l0, x0, up)
    report['mcp_128_f64'] = T.report()
    for owner, name, fn in restore:
        setattr(owner, name, fn)

    # --- IBR best-response steps on the bench batch, f32
    _, sol = build_bench_solver(horizon=25, scenario=sc, dtype=torch.float32, device=cuda)
    b_u0, _, b_x0, b_up = build_bench_batch(sc, sol, 256, seed=0)
    br = ibr.IBR(sc.joint_model, sc.costs, sc.agent_constraints, sc.shared_constraints,
                 sc.bounds, IBRParams(N=sc.N, dt=sc.dt, ibr_iters=1, p_tol=1e-3, d_tol=1e-3),
                 print_method=None, dtype=torch.float32)
    restore = [(ibr, '_jac_fwd', T.wrap(ibr, '_jac_fwd', 'hessian_push')),
               (ibr, 'regularized_convexification', T.wrap(ibr, 'regularized_convexification')),
               (ibr, 'solve_qp', T.wrap(ibr, 'solve_qp')),
               (ibr, 'backtrack', T.wrap(ibr, 'backtrack', 'line_search')),
               (ibr.IBR, '_br_step', T.wrap(ibr.IBR, '_br_step', 'br_step'))]
    for games in (256, 64):
        l_a = torch.zeros(games, int(br.br_idxs[0].numel()), device=cuda)
        u = b_u0[:games]
        br._br_step(0, u, l_a, b_x0[:games], b_up[:games], None)             # warm-up
        T.report()
        for _ in range(3):
            u, l_a, _ = br._br_step(0, u, l_a, b_x0[:games], b_up[:games], None)
        report[f'ibr_step_{games}_f32'] = T.report()
    for owner, name, fn in restore:
        setattr(owner, name, fn)

    # --- ALGAMES outer iterations on 16 games, f64
    al = algames.ALGAMES(sc.joint_model, sc.costs, joint_constraints_for_algames(sc),
                         sc.bounds, ALGAMESParams(N=sc.N, dt=sc.dt, outer_iters=2,
                                                  newton_iters=50, line_search_iters=50,
                                                  ineq_tol=1e-3, eq_tol=1e-3, opt_tol=1e-3,
                                                  beta=0.01, tau=0.5, q_reg=1e-3,
                                                  u_reg=1e-3),
                         print_method=None, dtype=f64)
    g = min(16, x0.shape[0])
    qs = [x0[:g]]
    for k in range(sc.N):
        qs.append(sc.joint_model.fd(qs[-1], u_ws[:g, k]))
    q_ws = torch.stack(qs, dim=1)
    upz = torch.zeros(g, sc.joint_model.n_u, dtype=f64, device=cuda)
    restore = [(algames.ALGAMES, '_newton_system', T.wrap(algames.ALGAMES, '_newton_system')),
               (algames.ALGAMES, '_line_search', T.wrap(algames.ALGAMES, '_line_search')),
               (torch.linalg, 'solve_ex', T.wrap(torch.linalg, 'solve_ex', 'newton_solve')),
               (algames.ALGAMES, '_outer_body', T.wrap(algames.ALGAMES, '_outer_body',
                                                       'outer_iteration'))]
    al.solve_batch_chunked(q_ws, u_ws[:g], x0[:g], upz)
    report['algames_16_f64'] = T.report()
    for owner, name, fn in restore:
        setattr(owner, name, fn)

    # --- eigh at the convexification's shapes
    for B, n, dt in ((128, 100, f64), (256, 50, torch.float32), (256, 100, torch.float32)):
        X = torch.randn(B, n, n, dtype=dt, device=cuda)
        A = X + X.transpose(-1, -2)
        torch.linalg.eigh(A)
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(5):
            torch.linalg.eigh(A)
        torch.cuda.synchronize()
        report[f'eigh_{B}x{n}_{str(dt).split(".")[-1]}_s'] = (time.time() - t0) / 5

    txt = json.dumps(report)
    print(txt)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(txt)


if __name__ == '__main__':
    main()
