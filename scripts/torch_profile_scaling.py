#!/usr/bin/env python3
"""Weak scaling of the sharded bench solve over ranks, the counterpart of
``scripts/profile_scaling_multihost.py``.

The batch a rank holds is fixed (``--per_rank`` games of the bench problem, the same
games on every rank), so each tier measures what changes with the rank count:

  a) one rank, no mesh;
  b) k ranks from one launch (``spawn_ranks``), compaction across the ranks;
  c) k processes started apart and joined by ``init_distributed`` on 127.0.0.1, each
     pinned to its own cores with ``taskset`` where the host has it (the fixed layout,
     as across hosts).

Every rank solves with DGSQP v1 at the bench's parameters (``build_bench_solver``,
float32) through ``solve_batch_chunked(chunk_iters=--chunk)``.  A tier's rate is its
games over the slowest rank's solve time (after a warm-up chunk).  ``--device`` names
the device a rank: ``cuda`` gives each rank a card of its own (k cards), ``cuda:0``
puts every rank on card 0, ``cpu`` runs on the CPU.

Usage: python3 scripts/torch_profile_scaling.py [--ranks 2 4] [--per_rank 64] [--N 25]
       [--device cuda:0] [--out results/scaling.json]
       python scripts/torch_profile_scaling.py --device cpu --ranks 2 --per_rank 4 --N 5
"""
import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument('--ranks', type=int, nargs='+', default=[2, 4])
    ap.add_argument('--per_rank', type=int, default=64)
    ap.add_argument('--N', type=int, default=25)
    ap.add_argument('--chunk', type=int, default=4)
    ap.add_argument('--device', default='cuda:0')
    ap.add_argument('--timeout', type=float, default=1200.0)
    ap.add_argument('--out', default=None)
    ap.add_argument('--worker', action='store_true',
                    help='one process of tier c (joined from the environment)')
    return ap


def solve(mesh, per_rank, N, chunk, device):
    """This rank's block (the bench batch of ``per_rank`` games) solved after a warm-up
    chunk; returns host values."""
    import torch
    from dgsqp_torch.harness.bench_setup import build_bench_batch, build_bench_solver
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device if mesh is None else mesh.device)
    sync = torch.cuda.synchronize if dev.type == 'cuda' else (lambda: None)
    sc, sol = build_bench_solver(horizon=N, dtype=torch.float32, device=str(dev))
    block = build_bench_batch(sc, sol, per_rank, seed=0)
    sol.solve_batch_chunked(*(a[:min(16, per_rank)] for a in block), chunk_iters=chunk,
                            max_chunks=1)
    sync()
    t0 = time.time()
    res = sol.solve_batch_chunked(*block, chunk_iters=chunk, mesh=mesh)
    sync()
    seconds = time.time() - t0
    return dict(rank=0 if mesh is None else mesh.rank, seconds=seconds,
                games=int(res.status.shape[0]),
                status=''.join(str(int(s)) for s in res.status.cpu()),
                buckets=[h['batch'] for h in sol.last_chunk_history],
                backend=None if mesh is None else mesh.backend)


def _spawned(mesh, per_rank, N, chunk):
    return solve(mesh, per_rank, N, chunk, None)


def tier(name, ranks, results, wall):
    seconds = max(r['seconds'] for r in results)
    games = results[0]['games']
    return dict(tier=name, ranks=ranks, games=games, solve_s=seconds,
                solves_per_s=games / seconds, rank_solve_s=[r['seconds'] for r in results],
                spawn_to_join_s=wall, buckets=results[0]['buckets'],
                backend=results[0]['backend'], status_string=results[0]['status'])


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def apart(args, k, devices):
    """Tier c: k processes of this script joined by init_distributed, pinned to their
    own cores where ``taskset`` exists."""
    port = _free_port()
    cores = sorted(os.sched_getaffinity(0))
    share = max(1, len(cores) // k)
    procs = []
    for r in range(k):
        env = dict(os.environ, DGSQP_COORDINATOR=f'127.0.0.1:{port}',
                   DGSQP_NUM_PROCESSES=str(k), DGSQP_PROCESS_ID=str(r),
                   DGSQP_DEVICE=str(devices[r]))
        pin = []
        if shutil.which('taskset') and len(cores) >= k:
            mine = cores[r * share:(r + 1) * share]
            pin = ['taskset', '-c', ','.join(str(c) for c in mine)]
        cmd = pin + [sys.executable, str(Path(__file__).resolve()), '--worker',
                     '--per_rank', str(args.per_rank), '--N', str(args.N),
                     '--chunk', str(args.chunk)]
        procs.append(subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                      text=True))
    out = []
    try:
        for p in procs:
            stdout, _ = p.communicate(timeout=args.timeout)
            if p.returncode != 0:
                raise RuntimeError(f'a tier-c process exited with code {p.returncode}')
            out.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    return out, bool(shutil.which('taskset'))


def worker(args):
    import torch
    from dgsqp_torch.parallel.mesh import games_mesh, init_distributed, leave
    torch.set_num_threads(1)
    if not init_distributed(timeout_s=args.timeout):
        raise SystemExit('--worker runs as a process joined by init_distributed')
    try:
        print(json.dumps(solve(games_mesh(), args.per_rank, args.N, args.chunk, None)),
              flush=True)
    finally:
        leave()


def card():
    try:
        return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                               '--format=csv,noheader'], capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None):
    args = parser().parse_args(argv)
    if args.worker:
        worker(args)
        return
    import torch
    from dgsqp_torch.parallel.mesh import resolve_devices, spawn_ranks
    torch.set_num_threads(1)
    rows = []
    t0 = time.time()
    rows.append(tier('a_one_rank', 1, [solve(None, args.per_rank, args.N, args.chunk,
                                             args.device)], time.time() - t0))
    for k in args.ranks:
        spec = args.device if args.device in ('cuda', 'cpu') else [args.device] * k
        devices = [str(d) for d in resolve_devices(spec, k)]
        t0 = time.time()
        res = spawn_ranks(_spawned, k, args.per_rank, args.N, args.chunk,
                          devices=devices, timeout_s=args.timeout)
        rows.append(tier('b_spawned', k, res, time.time() - t0))
        rows[-1]['devices'] = devices
        t0 = time.time()
        res, pinned = apart(args, k, devices)
        rows.append(tier('c_init_distributed', k, res, time.time() - t0))
        rows[-1].update(devices=devices, pinned_with_taskset=pinned)
    base = rows[0]['solves_per_s']
    for r in rows:
        r['efficiency'] = r['solves_per_s'] / (r['ranks'] * base)
        r['statuses_as_one_rank'] = r['status_string'] == rows[0]['status_string'] * r['ranks']
    out = dict(script='scripts/torch_profile_scaling.py', per_rank=args.per_rank, N=args.N,
               chunk_iters=args.chunk, device=args.device, card=card(),
               cpu_count=os.cpu_count(), torch_version=torch.__version__, tiers=rows)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1) + '\n')
    print(json.dumps(out))


if __name__ == '__main__':
    main()
