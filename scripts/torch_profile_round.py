#!/usr/bin/env python3
"""Where one round of the port's main path spends its time, on one NVIDIA GPU.

Builds the bench problem (chicane duel, N=25, batch 256, seed 0, float32, DGSQP v1) with
``dgsqp_torch`` and times, with host clocks around work that ends in a
``torch.cuda.synchronize()``:

* each piece of a round at the full batch: ``evaluate`` (Q, q, G, g by
  forward-over-reverse AD), the convexified QP (Newton-Schulz + ``solve_qp``, with the
  Cholesky kernels), a 20-trial line search (``merit_terms`` on batch x 20), and the
  first-derivative ``evaluate`` that ``finalize`` runs;
* whole rounds of the flat machine from the initial carry;
* under ``torch.profiler``, two rounds: device-busy time (the sum of CUDA kernel time)
  against wall time, the number of CUDA kernel launches, and the kernels that take
  the most device time.

Usage (from the repository root, on the machine with the card):

    python3 scripts/torch_profile_round.py [--batch 256] [--rounds 6]

Prints one JSON object; with ``--out PATH`` also writes it there.
"""
import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--batch', type=int, default=256)
    ap.add_argument('--horizon', type=int, default=25)
    ap.add_argument('--rounds', type=int, default=6)
    ap.add_argument('--out', default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit('torch_profile_round: needs an NVIDIA GPU')
    from torch.profiler import ProfilerActivity, profile
    from dgsqp_torch.harness.bench_setup import build_bench_batch, build_bench_solver

    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    sc, sol = build_bench_solver(horizon=args.horizon, dtype=torch.float32, device='cuda')
    u0, l0, x0, up = build_bench_batch(sc, sol, args.batch, seed=0)

    def timed(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps

    W = sol.params.line_search_iters
    Q, q, G, g, _ = sol.problem.evaluate(u0, l0, x0, up)
    rep = lambda v: v.repeat_interleave(W, 0)
    pieces = {
        'evaluate_hessian_s': timed(lambda: sol.problem.evaluate(u0, l0, x0, up)),
        'qp_s': timed(lambda: sol._qp(Q, q, G, g)),
        'line_search_merit_x%d_s' % W: timed(
            lambda: sol.problem.merit_terms(rep(u0), rep(l0), rep(x0), rep(up))),
        'evaluate_first_derivatives_s': timed(
            lambda: sol.problem.evaluate(u0, None, x0, up, hessian=False)),
    }

    from dgsqp_torch.ops import linalg
    linalg.cholesky.launches = linalg.cho_solve.launches = 0
    sol._qp(Q, q, G, g)
    qp_launches = {'chol': linalg.cholesky.launches, 'cho_solve': linalg.cho_solve.launches}

    c = sol.init_flat_carry(u0, l0)
    rounds = []
    for _ in range(args.rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c = sol._round(c, x0, up)
        torch.cuda.synchronize()
        rounds.append(time.perf_counter() - t0)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            c = sol._round(c, x0, up)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]

    result = {
        'card': card, 'batch': args.batch, 'horizon': args.horizon,
        'pieces': pieces, 'kernel_launches_per_qp': qp_launches, 'round_s': rounds,
        'profiled_rounds': 2, 'profiled_wall_s': wall,
        'device_busy_s': busy_us * 1e-6,
        'device_idle_share': 1.0 - busy_us * 1e-6 / wall,
        'cuda_kernel_launches': len(events),
        'top_kernels_device_s': [[name, us * 1e-6] for name, us in top],
    }
    line = json.dumps(result)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
        with open(args.out, 'w') as f:
            f.write(line + '\n')


if __name__ == '__main__':
    main()
