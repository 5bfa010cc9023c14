#!/usr/bin/env bash
# Globalization ablation on the port (the counterpart of scripts/run_ablation_study.sh):
# merit function x decrease condition x NMS for DGSQP v2, and DGSQP v1 with the 'stat'
# merit, on the chicane.  Every configuration writes its own output
# (scripts/torch_monte_carlo_main.py names it by the options off their defaults).
# Usage: scripts/torch_run_ablation_study.sh [OUT] [N_SAMPLES] [more options...]
set -e
cd "$(dirname "$0")/.."
OUT=${1:-results/ablation}
N_SAMPLES=${2:-100}
shift $(( $# < 2 ? $# : 2 ))
for MF in stat_l1 sum_obj_l1; do
  for MD in armijo max; do
    python3 scripts/torch_monte_carlo_main.py --scenario chicane --solver dgsqp_v2 \
      --merit_function $MF --merit_decrease_condition $MD --n "$N_SAMPLES" --out "$OUT" "$@"
  done
done
python3 scripts/torch_monte_carlo_main.py --scenario chicane --solver dgsqp_v2 --no_nms \
  --n "$N_SAMPLES" --out "$OUT" "$@"
python3 scripts/torch_monte_carlo_main.py --scenario chicane --solver dgsqp \
  --merit_function stat --n "$N_SAMPLES" --out "$OUT" "$@"
