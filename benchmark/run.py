"""Entry of the benchmark of ``dgsqp_torch``:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as the last line of standard output (one JSON object) and each number
the check compared, beside its limit, as the last lines of standard error.  Exits with
a non-zero code, and prints no result, without a CUDA card (or with fewer than the cell
asks for), without the program, or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# every build and kernel cache of the program lives at a fixed path inside the checkout
BUILD = ROOT / 'build'
os.environ['TORCH_EXTENSIONS_DIR'] = str(BUILD / 'torch_extensions')
os.environ['TRITON_CACHE_DIR'] = str(BUILD / 'triton')
os.environ['USE_FLAX'] = '0'
sys.path[:0] = [str(BENCH), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import perf_harness
    cell = perf_harness.load_cell(args.workload)['cell']
    import torch
    # one process with one host thread: the program's host work is one dispatching
    # thread, and the sampler's small tensors gain nothing from more
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell['chips']):
        print(f'no CUDA card for {args.workload} (needs {cell["chips"]})', file=sys.stderr)
        return 3
    from dgsqp_torch.ops import linalg
    linalg.BUILD_DIR = BUILD / 'kernels'
    line = perf_harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                            t_start=T_START)
    loaded = sorted({m.split('.')[0] for m in sys.modules} & set(perf_harness.FORBIDDEN))
    if loaded:
        print(f'forbidden modules loaded: {loaded}', file=sys.stderr)
        return 4
    for name, c in line['checks'].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == '__main__':
    sys.exit(main())
