#!/usr/bin/env python3
"""The port's bench: batched two-agent chicane game solves per second on one NVIDIA
GPU, the counterpart of the repo-root ``bench.py`` (``dgsqp_torch/harness/bench.py``).

Usage (from the repository root, on the machine with the card):

    python3 scripts/torch_bench.py
    DGSQP_BENCH_SOLVER=v2 DGSQP_BENCH_REPS=1 python3 scripts/torch_bench.py

Env knobs, as in ``bench.py``: ``DGSQP_BENCH_BATCH`` (256), ``DGSQP_BENCH_N`` (25),
``DGSQP_BENCH_SOLVER`` (v1|v2|approx, default v1), ``DGSQP_BENCH_CHUNK`` (4),
``DGSQP_BENCH_COMPACT`` (1 or 0; on for approx, off otherwise), ``DGSQP_BENCH_REPS``
(2, best of), ``DGSQP_BENCH_RETRY_SIGMAS`` (a comma list of perturbed restarts of the
failures, inside the timed window), ``DGSQP_BENCH_OUT`` (a file for the line with the
per-game ``status`` and ``iters``), and every solver knob ``build_bench_solver`` reads
(``DGSQP_BENCH_HESS``, ``_CONV``, ...).  ``DGSQP_BENCH_EXEC`` may only be ``chunked``.

It runs on ``cuda``; without a card it exits non-zero, unless ``DGSQP_BENCH_DEVICE=cpu``
asks for the CPU.  ``#`` telemetry goes to stderr (the chunks, the status histogram and
the status string, one digit a game); the last line of stdout is one JSON object.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import numpy as np
    import torch
    device = os.environ.get('DGSQP_BENCH_DEVICE', 'cuda')
    if torch.device(device).type == 'cuda':
        if not torch.cuda.is_available():
            print('torch_bench: torch.cuda.is_available() is False; run it on the card, '
                  'or set DGSQP_BENCH_DEVICE=cpu to run on the CPU', file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    from dgsqp_torch.harness.bench import WARMUP_GAMES, BenchConfig, run_bench
    config = BenchConfig.from_env()
    print(f'# device={device} dtype=float32 solver={config.solver_name} '
          f'batch={config.batch} N={config.horizon} chunk={config.chunk} '
          f'compact={config.compaction()} reps={config.reps}', file=sys.stderr, flush=True)
    run = run_bench(config, device=device)
    line = run.line
    print(f'# warm-up ({min(config.batch, WARMUP_GAMES)} games, one chunk, the kernels built): '
          f'{run.warmup_s:.2f}s | timed solves: '
          + ', '.join(f'{s:.2f}s' for s in run.rep_s), file=sys.stderr)
    ch = run.chunk_history
    print(f'# chunks: {len(ch)} | running-after-chunk: {[c["running"] for c in ch]} | '
          f'batch: {[c["batch"] for c in ch]} | chunk-walls: {[c["wall_s"] for c in ch]}',
          file=sys.stderr)
    iters = run.result.iters.cpu().numpy()
    print(f'# solve time: {min(run.rep_s):.2f}s for {line["batch"]} games | conv_abs '
          f'{line["convergence_rate"] * 100:.1f}% (incl rel '
          f'{line["convergence_rate_incl_rel"] * 100:.1f}%) | iters '
          f'p50={np.median(iters):.0f} max={iters.max()}', file=sys.stderr)
    print(f'# status counts: {line["status_counts"]}', file=sys.stderr)
    print('# status string: ' + ''.join(str(int(s)) for s in run.result.status.cpu()),
          file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
