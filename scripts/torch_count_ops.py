#!/usr/bin/env python3
"""Count the tensor operations one game-derivative call dispatches, on the CPU.

Every tensor operation the port dispatches on the card is at least one kernel launch,
and the study paths are bound by the host's time to issue them, so the count of a call
says what its host cost scales with.  This script builds a scenario at the study's
width, runs ``GameProblem.evaluate`` (with and without the Hessian), ``merit_terms`` and
``evaluate_dp`` once each on a small batch in float64 on the CPU, and counts the
operations PyTorch dispatches (``TorchDispatchMode``).  For the dynamic bicycles it
counts the fused step (``dgsqp_torch.ops.dynamics.dyn_step``) as one operation, as its
kernel is one launch on the card, or with ``--plain-step`` differentiates the model's
own ``fd_plain`` through ``torch.func`` instead.  Counts only: no time is measured.

Usage:
    python scripts/torch_count_ops.py --scenario dynamic [--plain-step]
    python scripts/torch_count_ops.py --scenario chicane
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--scenario', default='dynamic', choices=['dynamic', 'chicane'])
    ap.add_argument('--N', type=int, default=None, help='15 (dynamic) or 25 (chicane)')
    ap.add_argument('--batch', type=int, default=4)
    ap.add_argument('--plain-step', action='store_true',
                    help='differentiate the dynamic bicycles\' fd_plain, not the fused step')
    args = ap.parse_args(argv)

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    import dgsqp_torch.ops.dynamics as ops_dynamics
    from dgsqp_torch.harness.scenarios import build_chicane_scenario, build_dynamic_duel
    from dgsqp_torch.solvers.game_problem import GameProblem

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n, self.inside_step = 0, 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += not self.inside_step
            return func(*args, **(kwargs or {}))

    counter = Count()
    plain = ops_dynamics.dyn_step_plain

    def one_operation(*a, **k):
        counter.inside_step += 1
        try:
            return plain(*a, **k)
        finally:
            counter.inside_step -= 1
            counter.n += 1
    ops_dynamics.dyn_step_plain = one_operation

    torch.set_num_threads(1)
    dynamic = args.scenario == 'dynamic'
    N = args.N or (15 if dynamic else 25)
    sc = build_dynamic_duel(N=N) if dynamic else build_chicane_scenario(N=N)
    if args.plain_step:
        for m in sc.joint_model.dynamics_models:
            m.fd = m.fd_plain
    gp = GameProblem(sc.joint_model, sc.costs, sc.agent_constraints, sc.shared_constraints,
                     sc.bounds, sc.N, dtype=torch.float64, device='cpu')
    B, f64 = args.batch, torch.float64
    u = torch.full((B, gp.n_dec), 0.1, dtype=f64)
    x0 = torch.zeros(B, sc.joint_model.n_q, dtype=f64)
    v, s = (2, 6) if dynamic else (2, 4)
    for a in range(2):
        x0[:, a * (sc.joint_model.n_q // 2) + v] = 1.5
        x0[:, a * (sc.joint_model.n_q // 2) + s] = 0.5 + a
    up = torch.zeros(B, sc.joint_model.n_u, dtype=f64)
    lam = torch.full((B, gp.n_c_total), 0.1, dtype=f64)
    calls = {'evaluate': lambda: gp.evaluate(u, lam, x0, up),
             'evaluate_first_derivatives': lambda: gp.evaluate(u, lam, x0, up, hessian=False),
             'merit_terms': lambda: gp.merit_terms(u, lam, x0, up),
             'rollout': lambda: gp.rollout(u, x0),
             'evaluate_dp': lambda: gp.evaluate_dp(u, lam, x0, up)}
    counts = {}
    for name, fn in calls.items():
        counter.n = 0
        with counter:
            fn()
        counts[name] = counter.n
    print(json.dumps({'scenario': sc.name, 'batch': B, 'n_dec': gp.n_dec,
                      'step': 'fd_plain through torch.func' if args.plain_step
                      else 'fused (one operation)', 'dispatched_operations': counts}))


if __name__ == '__main__':
    main()
