#!/usr/bin/env python3
"""Where the bench's games part between layouts of the same solve.

Solves the bench batch (``build_bench_solver`` / ``build_bench_batch``: the chicane
duel, DGSQP v1's flat machine, float32, seed 0) with ``solve_batch_chunked(chunk_iters=
4)`` in several layouts:

* ``fixed``: the whole batch at one width (``compact=False``, the bench's default);
* ``compacted``: straggler compaction in one process (``compact=True``);
* ``sharded``: two ranks (``spawn_ranks``; two processes share one card over gloo),
  each starting from its block of the batch, compacting across the ranks;
* ``blocks``: each of the ``sharded`` run's starting blocks solved alone in one process
  at the fixed layout (the ranks' widths before their first compaction).

Every round of each solve records the iterate ``u`` of each game still running (rows
matched to the games by their initial states; a pad slot of a compacted bucket repeats
another game and is left out) and the round's batch width.  For each pair of layouts it
reports the games whose final statuses differ, with the first round where each one's
iterate differs (by any bit) and the widths of both layouts there, and the first round
where any game's iterate differs.

Usage (from the repository root; on the card by default):

    python3 scripts/torch_bench_parting.py [--layouts fixed,compacted,sharded,blocks]
    python3 scripts/torch_bench_parting.py --device cpu --batch 8 --horizon 5

Prints one JSON object; with ``--out`` also writes it there.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LAYOUTS = ('fixed', 'compacted', 'sharded', 'blocks')
RANKS = 2
RANK_TIMEOUT_S = 900.0


def _bench(horizon: int, batch: int, device):
    import torch
    from dgsqp_torch.harness.bench_setup import build_bench_batch, build_bench_solver
    sc, sol = build_bench_solver(horizon=horizon, dtype=torch.float32, device=device)
    return sol, build_bench_batch(sc, sol, batch, seed=0)


def recorded_solve(sol, batch, x0_full, **solve_kw):
    """Solve ``batch`` and return (status, rounds): ``rounds[r]`` maps each game
    running into round r (its index in ``x0_full``) to (its ``u`` after the round, the
    round's width)."""
    import numpy as np
    from dgsqp_torch.solvers.dgsqp import RUNNING
    game_of = {row.tobytes(): g for g, row in enumerate(np.asarray(x0_full))}
    rounds = []
    inner = sol._round

    def recording_round(c, x0, up, P=None):
        out = inner(c, x0, up, P)
        running = (c.status == RUNNING).cpu().numpy()
        rows, u = x0.cpu().numpy(), out.u.cpu().numpy()
        width = int(c.status.shape[0])
        rec = {}
        for j in np.where(running)[0]:
            # a pad slot repeats an earlier slot's game: the first slot is the game
            rec.setdefault(game_of[rows[j].tobytes()], (u[j], width))
        rounds.append(rec)
        return out

    sol._round = recording_round
    try:
        res = sol.solve_batch_chunked(*batch, **solve_kw)
    finally:
        del sol._round
    return res.status.cpu().numpy(), rounds


def sharded_rank(mesh, horizon, batch_size, chunk):
    """One rank of the ``sharded`` layout: its block, compaction across the ranks."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sol, batch = _bench(horizon, batch_size, str(mesh.device))
    lo, hi = mesh.block(batch_size)
    return recorded_solve(sol, [a[lo:hi] for a in batch], batch[2].cpu(),
                          chunk_iters=chunk, mesh=mesh)


def merge(parts):
    """Merge the per-round records of several solves of disjoint (or padded) rows; the
    first part holding a game keeps it."""
    rounds = []
    for r in range(max(len(p) for p in parts)):
        rec = {}
        for p in parts:
            for g, v in (p[r] if r < len(p) else {}).items():
                rec.setdefault(g, v)
        rounds.append(rec)
    return rounds


def run_layout(name, sol, batch, args):
    import numpy as np
    import torch
    x0_full = batch[2].cpu()
    kw = dict(chunk_iters=args.chunk)
    if name == 'fixed':
        return recorded_solve(sol, batch, x0_full, compact=False, **kw)
    if name == 'compacted':
        return recorded_solve(sol, batch, x0_full, compact=True, **kw)
    b = args.batch // RANKS
    if name == 'blocks':
        outs = [recorded_solve(sol, [a[r * b:(r + 1) * b] for a in batch], x0_full,
                               compact=False, **kw) for r in range(RANKS)]
        return np.concatenate([o[0] for o in outs]), merge([o[1] for o in outs])
    from dgsqp_torch.parallel.mesh import spawn_ranks
    dev = torch.device(args.device)
    devices = 'cpu' if dev.type == 'cpu' else [f'cuda:{dev.index or 0}'] * RANKS
    outs = spawn_ranks(sharded_rank, RANKS, args.horizon, args.batch, args.chunk,
                       devices=devices, timeout_s=RANK_TIMEOUT_S)
    return outs[0][0], merge([o[1] for o in outs])


def first_parting(a_rounds, b_rounds, game):
    """The first round whose records of ``game`` differ (or that only one run has)."""
    import numpy as np
    for r in range(max(len(a_rounds), len(b_rounds))):
        a = a_rounds[r].get(game) if r < len(a_rounds) else None
        b = b_rounds[r].get(game) if r < len(b_rounds) else None
        if a is None and b is None:
            continue
        if a is None or b is None or not np.array_equal(a[0], b[0]):
            return r
    return None


def compare(a, b, batch: int) -> dict:
    """Where the games of runs a and b part (each (status, rounds))."""
    import numpy as np
    from dgsqp_torch.solvers.dgsqp import STATUS_MSG
    (st_a, ra), (st_b, rb) = a, b

    def width(rounds, r, g):
        return rounds[r][g][1] if r is not None and r < len(rounds) and g in rounds[r] \
            else None

    first = {g: first_parting(ra, rb, g) for g in range(batch)}
    parted = [r for r in first.values() if r is not None]
    flips = []
    for g in np.where(st_a != st_b)[0]:
        r = first[int(g)]
        diff = None
        if width(ra, r, g) is not None and width(rb, r, g) is not None:
            diff = float(np.abs(ra[r][g][0].astype(np.float64) - rb[r][g][0]).max())
        flips.append(dict(game=int(g), a=STATUS_MSG[int(st_a[g])],
                          b=STATUS_MSG[int(st_b[g])], first_u_round=r,
                          u_max_abs_diff_there=diff, width_a=width(ra, r, g),
                          width_b=width(rb, r, g)))
    return dict(agree=int((st_a == st_b).sum()), games_parted=len(parted),
                first_round_any_game_parts=min(parted) if parted else None,
                games_parted_by_round={int(r): parted.count(r) for r in sorted(set(parted))},
                flips=flips)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--batch', type=int, default=256)
    ap.add_argument('--horizon', type=int, default=25)
    ap.add_argument('--chunk', type=int, default=4)
    ap.add_argument('--layouts', default='fixed,compacted,sharded,blocks')
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    layouts = args.layouts.split(',')
    if not set(layouts) <= set(LAYOUTS):
        ap.error(f'layouts are among {LAYOUTS}')

    import torch
    if torch.device(args.device).type == 'cuda':
        if not torch.cuda.is_available():
            sys.exit('torch_bench_parting: no card; pass --device cpu for the CPU')
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    sol, batch = _bench(args.horizon, args.batch, args.device)
    runs, seconds = {}, {}
    for name in layouts:
        t0 = time.time()
        runs[name] = run_layout(name, sol, batch, args)
        seconds[name] = time.time() - t0
    out = {
        'device': str(sol.device), 'batch': args.batch, 'horizon': args.horizon,
        'chunk_iters': args.chunk, 'seconds': seconds,
        'status_string': {k: ''.join(str(int(s)) for s in v[0]) for k, v in runs.items()},
        'rounds': {k: len(v[1]) for k, v in runs.items()},
        'widths': {k: sorted({w for rec in v[1] for _, w in rec.values()}, reverse=True)
                   for k, v in runs.items()},
        'pairs': {f'{a}:{b}': compare(runs[a], runs[b], args.batch)
                  for i, a in enumerate(layouts) for b in layouts[i + 1:]},
    }
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
        with open(args.out, 'w') as f:
            f.write(line + '\n')
    print(line)


if __name__ == '__main__':
    main()
