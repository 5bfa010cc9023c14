"""The comparison's readings on many seeds in one process (the kernels built once):

    python3 benchmark/readings.py --workload <cell> --seeds 11 12 13 --seconds 1 \
        [--tf32 1] [--out readings.jsonl]

Each seed is one run of the cell as ``run.py`` makes it, with a window of ``--seconds``
(one request at least), and prints its numbers, limits and ``correct``, and the readings
of the control of the answer and round checks on the same window: the reference in
bfloat16 in the program's place.  ``--tf32 1`` runs the QP check's control: the program
with its float32 products in TF32.  The check has to find each control not correct.
Not a part of the benchmark's runs.
"""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--seconds', type=float, default=1.0)
    ap.add_argument('--tf32', type=int, choices=(0, 1), default=0)
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    import torch
    import perf_harness
    torch.set_num_threads(1)      # as in run.py
    if not torch.cuda.is_available():
        print('no CUDA card', file=sys.stderr)
        return 3
    from dgsqp_torch.ops import linalg
    linalg.BUILD_DIR = BENCH.parent / 'build' / 'kernels'
    for seed in args.seeds:
        t0 = time.perf_counter()
        line = perf_harness.run(args.workload, seed, args.seconds, False, t_start=t0,
                                tf32=bool(args.tf32), also_control=not args.tf32)
        info = line['info']
        rec = dict(workload=args.workload, seed=seed, tf32=bool(args.tf32),
                   correct=line['correct'], readings=info['readings'],
                   bf16=info['control_readings'], finished=info['finished'],
                   requests=info['requests'], check_s=info['check_s'],
                   seconds=time.perf_counter() - t0,
                   rate=line['metrics']['game_iters_per_s']['value'])
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(json.dumps(rec) + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
