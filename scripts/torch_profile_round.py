#!/usr/bin/env python3
"""Where one round of the port's main path spends its time, on one NVIDIA GPU.

Builds the bench problem (chicane duel, N=25, batch 256, seed 0, float32, DGSQP v1 or,
with ``--solver v2``, DGSQP v2; with ``--solver approx`` the approximate MPCC duel,
n=150, solved by ``DGSQPV2FrenetApprox`` in its ``'exact'`` mode) with ``dgsqp_torch``
and times, with host clocks around work that ends in a ``torch.cuda.synchronize()``:

* each piece of a round at the full batch: ``evaluate`` (Q, q, G, g by
  forward-over-reverse AD), the convexified QP (Newton-Schulz + ``solve_qp``, with the
  Cholesky kernels), a line search of all trials (``merit_terms`` on batch x 20 for v1,
  batch x 50 for v2, batch x 10 for approx), and the first-derivative ``evaluate``
  (``finalize`` of v1; the full-step trial of a v2 m-step);
* ``evaluate`` and ``evaluate_dp`` (the stage-wise derivatives), each with and without
  the Hessian: the time of a call and the CUDA launches of one (``torch.profiler``);
* whole rounds from the initial carry (v1: the flat machine; v2: with the number of
  games for which the round ran the full-step trial and the line search, since a v2
  round runs them only for the games that take an m-step);
* under ``torch.profiler``, two rounds: device-busy time (the sum of CUDA kernel time)
  against wall time, the number of CUDA kernel launches, and the kernels that take
  the most device time.

Usage (from the repository root, on the machine with the card):

    python3 scripts/torch_profile_round.py [--solver v1|v2|approx] [--batch 256] [--rounds 6]
    DGSQP_BENCH_HESS=dp python3 scripts/torch_profile_round.py   # rounds on evaluate_dp

The rounds take their game derivatives as ``DGSQP_BENCH_HESS`` says (``ad``, the
default, or ``dp``; ``build_bench_solver``).

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
    ap.add_argument('--solver', default='v1', choices=['v1', 'v2', 'approx'])
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
    v2 = args.solver in ('v2', 'approx')
    sc, sol = build_bench_solver(horizon=args.horizon, solver_name=args.solver,
                                 dtype=torch.float32, device='cuda')
    u0, l0, x0, up = build_bench_batch(sc, sol, args.batch, seed=0)

    def launches_of(fn):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)

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
    if v2:
        c = sol._init_carry(u0, l0, x0, up)
        round_fn = sol._make_body(x0, up)
        qp = lambda: sol._qp(0.5 * (Q + Q.transpose(-1, -2)), q, G, g, c.reg)
    else:
        c = sol.init_flat_carry(u0, l0)
        round_fn = lambda carry: sol._round(carry, x0, up)
        qp = lambda: sol._qp(Q, q, G, g)
    pieces = {
        'evaluate_hessian_s': timed(lambda: sol.problem.evaluate(u0, l0, x0, up)),
        'qp_s': timed(qp),
        'line_search_merit_x%d_s' % W: timed(
            lambda: sol.problem.merit_terms(rep(u0), rep(l0), rep(x0), rep(up))),
        'evaluate_first_derivatives_s': timed(
            lambda: sol.problem.evaluate(u0, None, x0, up, hessian=False)),
    }
    # the two ways to the game derivatives, with and without the Hessian: time per call
    # and the CUDA launches of one call
    derivs = {
        'evaluate_hessian': lambda: sol.problem.evaluate(u0, l0, x0, up),
        'evaluate_dp_hessian': lambda: sol.problem.evaluate_dp(u0, l0, x0, up),
        'evaluate_first_derivatives': lambda: sol.problem.evaluate(u0, None, x0, up,
                                                                   hessian=False),
        'evaluate_dp_first_derivatives': lambda: sol.problem.evaluate_dp(u0, None, x0, up,
                                                                         hessian=False),
    }
    evaluate_modes = {name: {'s': timed(fn), 'cuda_launches': launches_of(fn)}
                      for name, fn in derivs.items()}

    from dgsqp_torch.ops import linalg
    for wrapper in (linalg.cholesky, linalg.cho_solve):
        wrapper.launches, wrapper.launches_by_n = 0, {}
    qp()
    qp_launches = {'chol': linalg.cholesky.launches, 'cho_solve': linalg.cho_solve.launches,
                   'by_n': {'chol': dict(linalg.cholesky.launches_by_n),
                            'cho_solve': dict(linalg.cho_solve.launches_by_n)}}

    # games for which a v2 round ran the full-step trial and the line search
    rows = {'_eval_lite': 0, '_line_search': 0}
    if v2:
        def counted(name, n_games):
            inner = getattr(sol, name)

            def wrapper(*a, **kw):
                rows[name] += n_games(a)
                return inner(*a, **kw)
            setattr(sol, name, wrapper)
        counted('_eval_lite', lambda a: int(a[0].shape[0]))
        counted('_line_search', lambda a: int(a[0].sum()))

    rounds, round_rows = [], []
    for _ in range(args.rounds):
        rows.update(_eval_lite=0, _line_search=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c = round_fn(c)
        torch.cuda.synchronize()
        rounds.append(time.perf_counter() - t0)
        round_rows.append({'full_step_trial_games': rows['_eval_lite'],
                           'line_search_games': rows['_line_search']})

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            c = round_fn(c)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]

    result = {
        'card': card, 'solver': args.solver, 'batch': args.batch, 'horizon': args.horizon,
        'hessian_mode': sol.params.hessian_mode, 'pieces': pieces,
        'evaluate_modes': evaluate_modes, 'kernel_launches_per_qp': qp_launches,
        'round_s': rounds,
        'round_games': round_rows if v2 else None,
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
