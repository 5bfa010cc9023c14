#!/usr/bin/env python3
"""Batch scaling of the flat round's hot operations on one NVIDIA GPU, the counterpart
of ``scripts/profile_scaling.py`` on the port.

For each batch size it builds the bench problem (``build_bench_solver``: the chicane
duel, DGSQP v1, float32; the same ``DGSQP_BENCH_*`` knobs) on the seed-0 draw (the PID
warm start, zero previous inputs, duals at 0.1) and times, per call: ``evaluate`` with
the Hessian, the convexification (eigendecomposition and Newton-Schulz), ``solve_qp``
capped at 25 and at 12 interior-point iterations, a merit grid of 20 trial steps, and
one whole round of the flat machine.  The device time of a call comes from CUDA events
around ``--reps`` calls: captured into a CUDA graph and replayed where the operation
allows it (no host synchronisation inside), so that the host's dispatch is paid once;
else an eager loop (``graph: false``, the host's dispatch included).

Usage (from the repository root; on the card by default):

    python3 scripts/torch_profile_batch_scaling.py [--batches 128,512,2048] [--reps 8]
    python3 scripts/torch_profile_batch_scaling.py --device cpu --batches 4 --horizon 5 --reps 1

``BATCHES``, ``REPS`` and ``N`` in the environment set the defaults, as in the JAX
script.  Prints a line per operation and one JSON object last; with ``--out`` also
writes the object there.
"""
import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def host_syncs(fn) -> bool:
    """Whether one call of ``fn`` waits on the device (a capture would then fail)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        fn()
        return False
    except RuntimeError:
        return True
    finally:
        torch.cuda.set_sync_debug_mode('default')
        torch.cuda.synchronize()


def time_call(fn, reps: int, device) -> dict:
    """ms a call of ``fn`` over ``reps`` calls, and whether they ran as a CUDA graph."""
    import torch
    fn()
    if device.type != 'cuda':
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return dict(ms=(time.perf_counter() - t0) * 1e3 / reps, graph=False)
    graph = None
    if not host_syncs(fn):
        try:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(reps):
                    fn()
            graph.replay()
        except RuntimeError:
            graph = None
        torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    if graph is not None:
        graph.replay()
    else:
        for _ in range(reps):
            fn()
    end.record()
    end.synchronize()
    return dict(ms=start.elapsed_time(end) / reps, graph=graph is not None)


def profile_batch(sol, sc, B: int, reps: int):
    """{operation: {'ms', 'us_per_game', 'graph'}} at batch size B."""
    import torch
    from dgsqp_torch.harness.samplers import sample_duel_initial_conditions
    from dgsqp_torch.solvers.qp import solve_qp
    from dgsqp_torch.utils.math import regularized_convexification
    dt, dev = sol.dtype, torch.device(sol.device)
    x0, u_ws, _, _ = sample_duel_initial_conditions(sc, B, seed=0, dtype=dt, device=dev)
    u0 = sol.problem.stage_to_u(torch.as_tensor(u_ws, dtype=dt, device=dev))
    x0 = torch.as_tensor(x0, dtype=dt, device=dev)
    up = torch.zeros(B, sc.joint_model.n_u, dtype=dt, device=dev)
    l0 = torch.full((B, sol.n_c), 0.1, dtype=dt, device=dev)
    Q, q, G, g, _ = sol.problem.evaluate(u0, l0, x0, up)
    Qh = regularized_convexification(Q, 1e-3)
    alphas = torch.linspace(0.1, 1.0, 20, dtype=dt, device=dev)
    rep = lambda v: v.repeat_interleave(alphas.numel(), 0)
    carry = sol.init_flat_carry(u0, l0)
    ops = {
        'evaluate(+Q)': lambda: sol.problem.evaluate(u0, l0, x0, up),
        'conv eigh': lambda: regularized_convexification(Q, 1e-3),
        'conv ns': lambda: regularized_convexification(Q, 1e-3, method='ns'),
        'qp it25': lambda: solve_qp(Qh, q, G, -g, tol=3e-7, max_iters=25),
        'qp it12': lambda: solve_qp(Qh, q, G, -g, tol=3e-7, max_iters=12),
        'merit grid 20': lambda: sol.problem.merit_terms(
            rep(u0) + alphas.repeat(B)[:, None] * 0.01, rep(l0), rep(x0), rep(up)),
        'flat round': lambda: sol._round(carry, x0, up),
    }
    out = {}
    for name, fn in ops.items():
        t = time_call(fn, reps, dev)
        out[name] = dict(t, us_per_game=t['ms'] * 1e3 / B)
        print(f'B={B:5d} {name:16s} {t["ms"]:9.3f} ms/call ({out[name]["us_per_game"]:8.2f} '
              f'us/game, {"graph" if t["graph"] else "eager"})', flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--batches', default=os.environ.get('BATCHES', '128,512,2048'))
    ap.add_argument('--reps', type=int, default=int(os.environ.get('REPS', 8)))
    ap.add_argument('--horizon', type=int, default=int(os.environ.get('N', 25)))
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    import torch
    card = 'cpu'
    if torch.device(args.device).type == 'cuda':
        if not torch.cuda.is_available():
            sys.exit('torch_profile_batch_scaling: no card; pass --device cpu for the CPU')
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                               '--format=csv,noheader'], capture_output=True, text=True,
                              timeout=60).stdout.strip()
    from dgsqp_torch.harness.bench_setup import build_bench_solver
    sc, sol = build_bench_solver(horizon=args.horizon, dtype=torch.float32,
                                 device=args.device)
    batches = [int(b) for b in args.batches.split(',')]
    result = dict(card=card, horizon=args.horizon, reps=args.reps, batches=batches,
                  ops={str(B): profile_batch(sol, sc, B, args.reps) for B in batches})
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
        with open(args.out, 'w') as f:
            f.write(line + '\n')
    print(line)


if __name__ == '__main__':
    main()
