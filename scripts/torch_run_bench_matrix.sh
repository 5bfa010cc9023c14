#!/bin/bash
# Solver-mode bench matrix on the card: the counterpart of
# scripts/run_bench_matrix_r5.sh on the port's bench (scripts/torch_bench.py): v1 / v2 /
# approx, one JSON artifact each with both success columns (the solver's own
# status-based rate and the reference-absolute residual test), the tolerance fields and
# the per-game statuses.  Run one after another: the timings share the card otherwise.
# Usage: bash scripts/torch_run_bench_matrix.sh [out_dir]
set -e
cd "$(dirname "$0")/.."
OUT=${1:-results/torch}
mkdir -p "$OUT" logs

for S in v1 v2 approx; do
  echo "=== bench solver=$S ==="
  DGSQP_BENCH_SOLVER=$S DGSQP_BENCH_REPS=3 \
  DGSQP_BENCH_OUT=$OUT/bench_${S}.json \
  timeout 3000 python3 scripts/torch_bench.py 2>&1 | tee logs/torch_bench_${S}.log | tail -4
done
echo BENCH_MATRIX_DONE
