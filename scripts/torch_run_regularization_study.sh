#!/usr/bin/env bash
# Regularization sweep of DGSQP v2 on the approximate kinematic game, on the port: the
# counterpart of scripts/run_regularization_study.sh (reg_init x reg_decay grid,
# eval_type in {once, always}, M samples a cell, each cell one batched solve on the
# card).  Aggregated at the end by scripts/torch_analyze_regularization.py.
set -e
cd "$(dirname "$0")/.."
export PYTHONPATH="$PWD${PYTHONPATH:+:$PYTHONPATH}"

OUT_DIR=${OUT_DIR:-results/regularization_study_$(date +%Y-%m-%d_%H-%M-%S)}
M=${M:-100}
N=${N:-25}

for eval_type in once always; do
    for reg in 1 10 100 1000; do
        for decay in 0.5 0.65 0.8 0.95 1.0; do
            python3 scripts/torch_monte_carlo_main.py \
                --scenario chicane --formulation approximate --solver dgsqp_v2 \
                --n "$M" --N "$N" \
                --merit_function stat_l1 --merit_decrease_condition armijo \
                --reg_init "$reg" --reg_decay "$decay" --eval_type "$eval_type" \
                --out "$OUT_DIR" --skip_existing "$@"
        done
    done
    # unregularized baseline (reg 0, no decay)
    python3 scripts/torch_monte_carlo_main.py \
        --scenario chicane --formulation approximate --solver dgsqp_v2 \
        --n "$M" --N "$N" \
        --merit_function stat_l1 --merit_decrease_condition armijo \
        --reg_init 0 --reg_decay 1.0 --eval_type "$eval_type" \
        --out "$OUT_DIR" --skip_existing "$@"
done

python3 scripts/torch_analyze_regularization.py "$OUT_DIR"
