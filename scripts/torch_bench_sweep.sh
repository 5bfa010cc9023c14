#!/bin/bash
# One-shot bench sweep on the card: the counterpart of scripts/bench_sweep.sh on the
# port's bench (scripts/torch_bench.py): stagnation-escape and chunk-size knobs.
# Usage: bash scripts/torch_bench_sweep.sh [out_file]
# Each line of the output: the env config followed by scripts/torch_bench.py's JSON.
set -u
cd "$(dirname "$0")/.."
OUT=${1:-results/torch_bench_sweep.jsonl}
mkdir -p "$(dirname "$OUT")"

run() {
  local desc="$1"; shift
  echo "# $desc" >&2
  local json
  json=$(env "$@" timeout 900 python3 scripts/torch_bench.py 2>>"$OUT.stderr" | tail -n 1)
  echo "{\"config\": \"$desc\", \"bench\": ${json:-null}}" | tee -a "$OUT"
}

# stall15 is the committed default; "r1-config" reproduces the round-1 configuration
run "r1-config (stall off)" DGSQP_BENCH_CHUNK=8  DGSQP_BENCH_STALL=0
run "default (stall15)"     DGSQP_BENCH_CHUNK=8
run "stall15+qpws"          DGSQP_BENCH_CHUNK=8  DGSQP_BENCH_QP_WS=1
run "stall15+dp"            DGSQP_BENCH_CHUNK=8  DGSQP_BENCH_HESS=dp
run "stall15+qpws+dp"       DGSQP_BENCH_CHUNK=8  DGSQP_BENCH_QP_WS=1 DGSQP_BENCH_HESS=dp
run "stall15+qpws chunk16"  DGSQP_BENCH_CHUNK=16 DGSQP_BENCH_QP_WS=1
run "stall15+qpws qp15"     DGSQP_BENCH_CHUNK=8  DGSQP_BENCH_QP_WS=1 DGSQP_BENCH_QP_ITERS=15
run "stall15+box"           DGSQP_BENCH_CHUNK=8  DGSQP_BENCH_BOX=1
run "stall15+qpws+box"      DGSQP_BENCH_CHUNK=8  DGSQP_BENCH_QP_WS=1 DGSQP_BENCH_BOX=1
run "stall15+qpws+dp+box"   DGSQP_BENCH_CHUNK=8  DGSQP_BENCH_QP_WS=1 DGSQP_BENCH_HESS=dp DGSQP_BENCH_BOX=1
# Gondzio correctors
run "stall15+corr2"         DGSQP_BENCH_CHUNK=8  DGSQP_BENCH_CORR=2
run "stall15+qpws+corr2"    DGSQP_BENCH_CHUNK=8  DGSQP_BENCH_QP_WS=1 DGSQP_BENCH_CORR=2

# pick the best config: highest solves/s among configs whose conv_abs is within
# 1 point of the best conv_abs (quality first, then speed)
python3 - "$OUT" <<'PY'
import json, sys
rows = [json.loads(l) for l in open(sys.argv[1]) if l.strip()]
rows = [r for r in rows if r.get('bench')]
if rows:
    best_conv = max(r['bench']['convergence_rate'] for r in rows)
    ok = [r for r in rows if r['bench']['convergence_rate'] >= best_conv - 0.01]
    win = max(ok, key=lambda r: r['bench']['value'])
    print(f"# best config: {win['config']} -> {win['bench']['value']} solves/s "
          f"(conv_abs {win['bench']['convergence_rate']:.1%}) on "
          f"{win['bench']['device']}, {win['bench']['power_limit_w']} W")
PY
