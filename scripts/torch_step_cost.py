#!/usr/bin/env python3
"""What the dynamic bicycles' fused step saves: one game ``evaluate`` with its Hessian,
on one NVIDIA GPU, through the fused step (``dgsqp_torch.ops.dynamics.fd_step``, the
``dyn_step.cu`` kernel) and through the models' own ``fd_plain`` differentiated by
``torch.func`` in its place.

The problem is the exact dynamic duel's study (two dynamic bicycles on
``L_track_barc``, N=15, DGSQP v2 with the study's parameters, float32) on its first
``--batch`` games of the seed-0 draw at the warm start.  The fused call is timed as the
median of three after one warm-up; the plain-step call once, after the fused ones.
Each time is host wall time around work that ends in ``torch.cuda.synchronize()``.
The two gradients are compared.

Usage (from the repository root, on the machine with the card):

    python3 scripts/torch_step_cost.py [--batch 64] [--out build/step_cost.json]

Prints one JSON object; with ``--out PATH`` also writes it there.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--batch', type=int, default=64)
    ap.add_argument('--out', default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit('torch_step_cost: needs an NVIDIA GPU')
    from chip_smoke import dynamic_solver, rel_err, study_batch
    from dgsqp_torch.harness.dynamic_study import sample_dynamic_duel_initial_conditions
    from dgsqp_torch.harness.scenarios import build_dynamic_duel
    from dgsqp_torch.ops.dynamics import dyn_step

    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    sc = build_dynamic_duel(N=15)
    sol = dynamic_solver(sc, torch.float32, 'cuda')
    u0, l0, x0, up = study_batch(sc, sol, args.batch, sample_dynamic_duel_initial_conditions)

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sol.problem.evaluate(u0, l0, x0, up)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    timed()
    n0 = dyn_step.launches
    fused = [timed() for _ in range(3)]
    dyn_launches = (dyn_step.launches - n0) // 3
    for m in sc.joint_model.dynamics_models:
        m.fd = m.fd_plain
    plain_s, plain_out = timed()
    result = {'card': card, 'scenario': sc.name, 'batch': args.batch, 'dtype': 'float32',
              'evaluate_hessian_fused_s': statistics.median(t for t, _ in fused),
              'fused_dyn_step_launches': dyn_launches,
              'evaluate_hessian_plain_step_s': plain_s,
              'rel_diff_plain_vs_fused': {k: rel_err(a.double(), b.double()) for k, a, b in
                                          zip('Q q G g'.split(), plain_out[:4],
                                              fused[-1][1][:4])}}
    line = json.dumps(result)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
        with open(args.out, 'w') as f:
            f.write(line + '\n')


if __name__ == '__main__':
    main()
