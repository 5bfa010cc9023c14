#!/bin/bash
# Full Monte-Carlo study sweep on the port: the counterpart of scripts/run_studies.sh,
# line for line on scripts/torch_monte_carlo_main.py.  Each configuration is one
# batched solve on the card.
# Usage: bash scripts/torch_run_studies.sh [OUT] [N_SAMPLES] [extra options of the
# study script, e.g. --device cpu --dtype float64]
set -e
cd "$(dirname "$0")/.."
export PYTHONPATH="$PWD${PYTHONPATH:+:$PYTHONPATH}"
OUT=${1:-results}
N_SAMPLES=${2:-200}
shift $(( $# < 2 ? $# : 2 ))

for N in 15 20 25; do
  python3 scripts/torch_monte_carlo_main.py --scenario chicane --solver dgsqp    --N $N --n $N_SAMPLES --out $OUT "$@"
  python3 scripts/torch_monte_carlo_main.py --scenario chicane --solver dgsqp_v2 --N $N --n $N_SAMPLES --out $OUT "$@"
  python3 scripts/torch_monte_carlo_main.py --scenario curve   --solver dgsqp_v2 --N $N --n $N_SAMPLES --out $OUT "$@"
done
python3 scripts/torch_monte_carlo_main.py --scenario merge  --solver dgsqp --n $N_SAMPLES --out $OUT "$@"
python3 scripts/torch_monte_carlo_main.py --scenario agents --agents 3 --solver dgsqp --n $N_SAMPLES --out $OUT "$@"
python3 scripts/torch_monte_carlo_main.py --scenario agents --agents 4 --solver dgsqp --n $N_SAMPLES --out $OUT "$@"
# approximate-game formulation (MPCC) via the frenet-approx solver
python3 scripts/torch_monte_carlo_main.py --scenario chicane --formulation approximate --n $N_SAMPLES --out $OUT "$@"
# exact dynamic-bicycle study (the journal's dynamic study).  The JAX loop runs cost
# settings 0-3, but the JAX build_dynamic_duel knows only 0 and 1 (it raises on 2), so
# under set -e the JAX sweep stops there; the port's script accepts 0 and 1
for CS in 0 1; do
  python3 scripts/torch_monte_carlo_main.py --scenario dynamic --cost_setting $CS --n $N_SAMPLES --out $OUT "$@"
done
# cross-solver oracles on the same chicane samples (equilibrium agreement)
python3 scripts/torch_monte_carlo_main.py --scenario chicane --solver algames --n $N_SAMPLES --out $OUT "$@"
python3 scripts/torch_monte_carlo_main.py --scenario chicane --solver mcp --N 15 --n $N_SAMPLES --out $OUT "$@"
# then: python3 scripts/torch_gne_compare_main.py --N 15 $OUT/<dgsqp pickle> $OUT/<mcp pickle>
# (the equilibrium-match analysis)
