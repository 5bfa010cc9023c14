#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``dgsqp_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with the card:

    python3 chip_smoke.py

Phases, each printing one line on stdout:

1. ``build``: compiles the CUDA kernels from ``dgsqp_torch/ops/csrc`` with ``nvcc`` and
   prints the card's name and power limit (``nvidia-smi``).
2. ``kernels``: holds each kernel against its plain PyTorch version on the card, in
   float32 and float64, at every shape of the paths below (the bench problem's n = 100
   with its 64-row polish, the agents study's n = 36 with its 48-row polish), at the
   shapes that reach the other branches of the kernels (an odd size, n = 150,
   right-hand-side counts on each side of the switch between the two ``cho_solve``
   kernels and off the tile width), the approximate duel's n = 150 with its 96-row
   polish, IBR's best response's n = 50 with its 48-row polish, the merge's n = 120
   with its 80-row polish (float64 there), ``diagnose_path``'s 128 traced games at
   n = 100 and 64, and on a batch with one matrix that is not
   positive definite; and times the kernel (device time from a replayed CUDA graph, and
   the time per call of a loop of eager calls), the plain version and the library call
   that computes the same function.
3. ``parity``: one round of ``evaluate`` + convexified QP on 16 games of the seed-0
   bench batch, the port on the card in float32 against the port on the CPU in float64.
4. ``main_path``: the bench problem (two-agent chicane duel, N=25, theta=45 deg, batch
   256, seed 0, float32, DGSQP v1) solved through the port's bench entry
   (``dgsqp_torch/harness/bench.py``: ``solve_batch_chunked(chunk_iters=4,
   compact=False)`` after a warm-up of one chunk on 16 games, one timed solve, the
   bench's fields), with the kernels' launch counts; its per-game statuses counted
   against the JAX package's float32 CPU run of the same batch and solve
   (``dgsqp_torch/harness/data/bench_reference_f32.json``), at least
   ``BENCH_MIN_AGREE`` games alike.  Right after it ``bench_cli`` starts
   ``scripts/torch_bench.py`` in a process of its own (the bench's defaults at one timed
   solve: ``main_path``'s batch); joined before the merge's child starts, its last line
   must carry the bench's fields for the 256 games on the card, and each game
   ``main_path``'s status.
5. ``v2_path``: the same batch solved by DGSQP v2 (``build_bench_solver(solver_name=
   'v2')``) with ``solve_batch_chunked(chunk_iters=4)``, compaction on, after the same
   warm-up, with the launch counts, the m-step counts and the chunks' bucket sizes.
6. ``mc_study``: ``run_mc_study`` on the agents scenario (M=3, N=6, n=36 decisions), 16
   samples, seed 0, DGSQP v2, float32, with the launch counts and ``analyze_results``.
7. ``approx_parity``: as ``parity``, on 16 games of the approximate duel's bench batch
   (``build_bench_solver(solver_name='approx')``: progress-augmented bicycles, N=25,
   n=150 decisions, ``approximation_eval='exact'``), DGSQP v2's symmetrised Hessian and
   QP with its regularisation.
8. ``approx_path``: that batch (256 games, seed 0, float32) solved by
   ``DGSQPV2FrenetApprox`` with ``solve_batch_chunked(chunk_iters=4)``, compaction on,
   after the same warm-up, with the launch counts, m-step counts and buckets.
9. ``oracle_path``: the equilibrium-match study of the chicane (theta=45 deg, N=25,
   n=100, m=525) in float64, seed 0, 128 games: ``run_mc_study`` with DGSQP v1's study
   defaults and with the PATH-role MCP oracle (``PATHMCP``, ``method='hybrid'``,
   tol 1e-3, 200 iterations, 4 restarts), then ``gne_compare`` of the two (input scale
   2.1/0.436 per agent, match tolerance 0.1, conv_abs only), beside the JAX package's
   record of the same games (``docs/match_dgsqp_mcp_chicane_N25_r5.json``); the games
   whose status equals the JAX package's current CPU float64 run
   (``dgsqp_torch/harness/data/oracle_statuses_f64.json``) are counted, not held.
10. ``ibr_ws``: one batched IBR sweep (``IBRParams(ibr_iters=1, p_tol=d_tol=1e-3)``, the
   study's ``ibr_ws`` warm start) on the 256-game float32 bench batch: both kernels at
   the best response's n = 50 (and its polish's 48 rows).
11. ``algames_path``: ``run_mc_study_algames`` on the same chicane in float64 (n_y = 1000
   decisions a game) on the first 8 of the ``oracle_path``'s games, compared with its
   DGSQP by ``gne_compare``.  It and ``oracle_path`` run one after the other in a
   process of their own (``chip_smoke.py --oracle-paths``), started with the merge's and
   joined after it; their lines are printed when it ends.
12. ``merge_path``: the equilibrium-match study of the merge (three kinematic unicycles,
   N=20, n = 120 decisions) in float64, seed 0, 128 games: ``run_mc_study`` with DGSQP
   v1's study defaults, the MCP oracle as in ``oracle_path``, then ``gne_compare``
   (input scale 2.1/0.436 per agent, match tolerance 0.1, conv_abs only), beside the
   JAX package's record
   (``docs/match_dgsqp_mcp_merge_N20.json``); both kernels must launch at n = 120 and
   at the polish's 80 rows.  It runs in a process of its own (``chip_smoke.py
   --merge-path``, started by this one), beside ``oracle_path``, ``ibr_ws`` and
   ``algames_path``: every path is host-bound on one CPU core with the card mostly
   idle, so the paths share the card and take a core each; its line is printed when it
   ends.
13. ``dp_parity``: the stage-wise game derivatives (``evaluate_dp``) against
   ``evaluate``, both with the Hessian in float32 on the card, on the bench batch (256
   games at the warm start) and on the merge's 128 games: relative differences of Q, q,
   G and g, the median time of a call of each and the CUDA launches of one.
14. ``dynamic_parity``: as ``parity``, on 16 games of the exact dynamic duel (two
   dynamic bicycles on ``L_track_barc``, N=15, n = 60, DGSQP v2's study parameters) and
   of the approximate dynamic duel (progress-augmented dynamic bicycles,
   ``DGSQPV2FrenetApprox``, n = 90): the dynamic bicycle's step and its derivatives run
   in ``dyn_step.cu`` on the card and in its plain version on the CPU.  The card's
   float32 is held to ``DERIV_RTOL``/``STEP_RTOL`` against the CPU's float32 in every
   quantity, and against the CPU's float64 in all but the approximate duel's gradient
   and step (``APPROX_F32_FREE``: its lag cost moves them in float32 on any device;
   they are reported).
15. ``dynamic_path`` and ``f1_path``: the exact dynamic duel's study in the JAX
   record's configuration (``--scenario dynamic --n 64 --N 15 --solver dgsqp_v2``,
   ``run_mc_study``, float32, seed 0) beside the TPU float32 record, and the F1 study
   (``run_f1_study(N=15, num_samples=64, seed=0)`` with ``f1_solver_params(15,
   sqp_iters=150, approximation_eval='exact')``, float32; the repo's first F1 row).
   They run one after the other in a process of their own (``chip_smoke.py
   --dynamic-paths``), started with the merge's and joined after it; their lines are
   printed when it ends.  Both kernels must launch at the paths' sizes (n = 60 and the
   polish's 48 rows; n = 90 and 64), and ``dyn_step`` in both.

16. ``race_path``: the closed-loop two-car race (``RaceStack(RaceConfig())``:
   ``L_track_barc`` with its recorded raceline, CA-LTV-MPC trackers and a DGSQP game
   planner at N=20, 50 control steps, float64) in a third process (``chip_smoke.py
   --race-path``, also runnable alone): its states over the first ``RACE_HELD_STEPS``
   steps within ``RACE_ATOL`` of the JAX package's record
   (``dgsqp_torch/harness/data/race_reference_f64.json``) and the same game events
   (``held_game_log``); the cars advance and stay on the track, a game converges, no
   more tracker QPs fail than in the record; its steps/s, ms a step by part, launches
   (both kernels at the planner's n = 80, ``dyn_step`` at one and 20 points) and the
   device's idle share over two profiled steps.

17. ``nested_parity``: DGSQP v1's nested machine (``_make_body``) in three
   configurations of the bench's parameters (the monotone Armijo line search of
   ``DGSQP_BENCH_NMLS=0``, the nested watchdog, damped BFGS): one iteration on the first
   16 bench games, the card in float32 against the CPU in float64 (the iterate within
   ``STEP_RTOL``); and the host ``solve`` with game parameters of a parameterised
   integrator game, card against CPU in float64.  It runs while the children below
   finish.
18. ``nested_path`` and ``diagnose_path``, in a fourth process (``chip_smoke.py
   --nested-paths STATUSES``, started right after ``main_path`` with its per-game
   statuses; alone, without them, it solves the main path's batch first): the bench
   batch (256 games, float32) on the nested machine in the ``DGSQP_BENCH_NMLS=0``
   configuration through the nested ``solve_batch_chunked(chunk_iters=8)``, held
   against the JAX package's float32 record of the same games
   (``dgsqp_torch/harness/data/nested_reference_f32.json``, per-game agreement
   reported); then ``scripts/torch_diagnose_failures.py``'s flow on the main path's
   non-conv_abs games (padded to a power of two), traced for ``DIAG_TRACE_ITERS``
   iterations through v1's nested body and classified, beside the TPU record
   ``docs/diagnosis_r2.json`` (reported, not held).  Its log is
   ``build/chip_smoke_nested.jsonl``; both kernels must launch at n = 100 and 64.

19. ``sharded_path``, in a fifth process (``chip_smoke.py --sharded-path STATUSES``,
   started right after ``main_path`` beside the nested child when the machine has
   ``SHARDED_MIN_CORES`` cores, else after the other children; alone, it solves the
   main path's batch first): the main path's batch and solver (256 games, N=25, n=100,
   float32, DGSQP v1) over ``max(2, device_count)`` ranks (``spawn_ranks``: two ranks
   share the one card over ``gloo``), solved with ``solve_batch_chunked(chunk_iters=4)``
   and compaction across the ranks; held: no game running, both kernels launched on
   every rank at n = 100 and 64, every bucket a multiple of the world size, conv_abs and
   conv_abs + conv_rel at ``main_path``'s limits, ``SHARDED_MIN_AGREE`` games with
   ``main_path``'s status; then ``scripts/torch_monte_carlo_main.py`` on ``mc_study``'s
   scenario and sizes, on one device and with ``--devices``: the run on ranks writes the
   outputs the one device writes, under the same names, with the same per-game
   statuses.  Its log is
   ``build/chip_smoke_sharded.jsonl``.

``kernels`` also holds ``dyn_step.cu`` (the dynamic bicycle's step with its Jacobian and
second derivatives, all three orders) against its plain version at the paths' points,
and at the race's (one point at the model's and at the plant's step, 20 points at order
1), and both linear-algebra kernels at the race's batch of one.

The launch counts are set to 0 just before each path and read just after; each path
that runs the kernels fails if one was not launched in it.  Then one JSON line of
per-kernel numbers (``launches`` is the count of ``v2_path`` for the linear-algebra
kernels and of ``dynamic_path`` for ``dyn_step``, ``launches_by_path`` has every path,
``race_path`` and ``sharded_path`` (summed over its ranks) among them),
and last ``{"ok": true, "device": ...}``.  Every line also goes to
``build/chip_smoke.jsonl`` (the kernels line alone is longer than a caller may see of
the output's tail).
Any failed check raises and the script exits non-zero; without a card it exits
non-zero before printing any result.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and dense arithmetic outside the
# tensor cores (float32 67 TFLOP/s, float64 34 TFLOP/s)
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {'float32': 67e12, 'float64': 34e12}
# kernel vs plain version on inputs of condition number COND: the two repeat the same
# arithmetic up to fused multiply-adds, so they differ by a few COND * eps
COND = 100.0
KERNEL_RTOL = {'float32': 1e-4, 'float64': 1e-10}
# float32 on the card against float64 on the CPU, same inputs: derivatives carry f32
# rounding through a 25-step rollout (~1e-6 relative); the QP step is solved to a 3e-7
# tolerance after Ruiz scaling, so its relative error is ~1e-3
DERIV_RTOL = 1e-4
STEP_RTOL = 2e-2
CONV_ABS_MIN, CONV_ANY_MIN = 0.45, 0.70
# main_path's per-game statuses against the JAX package's float32 run of the same batch
# and solve on the CPU (the record tests/test_torch_bench.py writes: 145 conv_abs / 65
# conv_rel / 46 stalled); in float32 a rounding flip moves a game between conv_abs,
# conv_rel and stalled, so the limit is 95% of the games (as SHARDED_MIN_AGREE), not
# drawn to the port's own count (247 on the card)
BENCH_RECORD = Path(__file__).resolve().parent / 'dgsqp_torch' / 'harness' / 'data' / \
    'bench_reference_f32.json'
BENCH_MIN_AGREE = 243
# bench_cli: scripts/torch_bench.py on main_path's batch, one timed solve.  A 16-game
# bench draws other games than main_path's first 16 (the sampler draws max(2B, 8)
# candidates a round), and the card's float32 rounding depends on the batch width (those
# first 16 solved 16 wide end game 6 conv_rel, main_path stalled), so the CLI solves
# main_path's batch at its width
BENCH_CLI_GAMES = 256
BENCH_CLI_TIMEOUT_S = 600
# DGSQP v2 on the same batch: the JAX package's float32 record is 0.555 conv_abs with no
# conv_rel exit, so both limits are 0.45
V2_CONV_ABS_MIN, V2_CONV_ANY_MIN = 0.45, 0.45
# the approximate duel: the JAX package's float32 record of its seed-0 batch is 0.094
# conv_abs and 0.961 conv_abs + conv_rel (float32 stationarity plateaus near the O(1e3)
# gradient scale's rounding, so most games exit conv_rel); conv_abs is reported against
# its limit, conv_abs + conv_rel fails below its own
APPROX_CONV_ABS_LIMIT, APPROX_CONV_ANY_MIN = 0.03, 0.85
APPROX_N_DEC = 150
# the sizes both kernels must launch at on that path: the interior-point normal matrix
# (n = 150) and the polish's Schur complement (max(48, 150 // 2 + 14) = 89 rows, padded
# to 96)
APPROX_KERNEL_NS = (150, 96)
WARMUP_GAMES = 16
# the agents study of the mc_study phase: the bench's operating point for the exact game
# (small constant regularization) with a short budget
MC_AGENTS, MC_HORIZON, MC_SAMPLES = 3, 6, 16
MC_PARAMS = dict(sqp_iters=30, p_tol=1e-3, d_tol=1e-3, reg=1e-3, reg_decay=1.0,
                 nms_frequency=5, nms_memory_size=5, stall_its=10, line_search_iters=20)
# the equilibrium-match study: its games, the options of its comparison and the JAX
# package's float64 record of the same games (DGSQP 78 conv_abs, MCP 68, both 63, all
# 63 matched); the limits leave room for rounding flips on ill-posed QPs and sit far
# above what a broken solver reaches (records: 0.609 and 0.531 conv_abs)
ORACLE_GAMES, ORACLE_SEED = 128, 0
ORACLE_COMPARE = dict(N=25, num_ua=[2, 2], input_scale=[2.1, 0.436, 2.1, 0.436],
                      match_tol=0.1, success='abs')
ORACLE_RECORD = dict(converged_a=78, converged_b=68, both_converged=63, match=63,
                     nmse_max=2.926231472253517e-05)
ORACLE_MATCH_MIN, ORACLE_MCP_CONV_MIN, ORACLE_DGSQP_CONV_MIN = 0.95, 0.40, 0.50
# the JAX package's per-game statuses of the same games on the CPU in float64 (DGSQP and
# the MCP; written by tests/test_torch_tooling.py --write-record)
ORACLE_STATUS_RECORD = Path(__file__).resolve().parent / 'dgsqp_torch' / 'harness' / \
    'data' / 'oracle_statuses_f64.json'
# the IBR sweep of the study's warm start: the best response's decisions and polish rows
IBR_KERNEL_NS = (50, 48)
# the merge's equilibrium-match study: three unicycles, N=20, n = 3 x 2 x 20 = 120
# decisions, float64, the games of the JAX package's record (seed 0, 128 games; its
# comparison scaled the inputs by 2.1 / 0.436 per agent, as for every suite of that
# record); the record (the r3 solver, conv incl. rel) has every game converged and
# matched
MERGE_GAMES, MERGE_SEED, MERGE_N = 128, 0, 20
MERGE_COMPARE = dict(N=MERGE_N, num_ua=[2, 2, 2], input_scale=[2.1, 0.436] * 3,
                     match_tol=0.1, success='abs')
MERGE_RECORD = dict(converged_a=128, converged_b=128, both_converged=128, match=128,
                    nmse_median=4.258178923336239e-05, nmse_max=0.05744580368899047)
MERGE_MATCH_MIN, MERGE_DGSQP_CONV_MIN, MERGE_MCP_CONV_MIN = 0.95, 0.85, 0.85
# the decisions and the polish's rows (max(48, 120 // 2 + 14) = 74, padded to 80) the
# kernels must launch at on the merge
MERGE_KERNEL_NS = (120, 80)
# evaluate_dp against evaluate, both float32 on the card on the same inputs: each
# carries float32 rounding through the 25-step rollout (~1e-6 relative, as DERIV_RTOL
# says), summed in another order, so the two differ by about as much
DP_RTOL = 1e-4
DP_GAMES = 256
# the dynamic duel's study (the JAX record's r5 command): N = 15, n = 2 x 2 x 15 = 60
# decisions and the polish's max(48, 60 // 2 + 14) = 48 rows; the TPU float32 record
# (results/r5/dynamic_duel_N15_c0_dgsqp_v2_exact_n64_s0.json) converges 0.656 (18
# conv_abs + 24 conv_rel of 64); the limit sits below it by the other paths' kind of
# margin and far above a broken solver (~0); the record is a first draft, so the limit
# is not drawn to the port's own count
DYN_GAMES, DYN_N = 64, 15
DYN_CONV_ANY_MIN = 0.45
DYN_KERNEL_NS = (60, 48)
DYN_RECORD = dict(conv_abs_tol=18, conv_rel_tol=24, qp_fail=1, max_it=21, mean_iters=179.05,
                  max_iters=288, feas_violation_max=0.0649, success_rate=0.65625)
# the F1 study (the r5 command: --n 64 --N 15 --solvers dgsqp): two progress-augmented
# dynamic bicycles, n = 2 x 3 x 15 = 90 and the polish's max(48, 45 + 14) = 59 rows,
# padded to 64; there is no record to hold it to
F1_GAMES, F1_N = 64, 15
F1_KERNEL_NS = (90, 64)
# dynamic_parity: the approximate dynamic duel's gradient and step, held to the CPU in
# float32 but not to float64: its lag cost (weight 1000 on the lag error, a difference
# of ~5 m positions) on a 150-sub-step float32 rollout moves q by ~2.5e-3 and the
# ill-conditioned QP step by ~0.3 of their largest entries, the same on the CPU and with
# torch.func's derivatives in place of the fused step's, and the JAX package's own
# float32 by ~5e-3 on q (tests/test_torch_f32_sensitivity.py)
APPROX_F32_FREE = ('q', 'du')
# dyn_step against its plain version, both in float32 on the same points: the two
# round ~40 fc evaluations differently (fused multiply-adds, the device's elementary
# functions), ~1e-6 of each quantity's largest entry
DYN_KERNEL_RTOL = {'float32': 1e-4, 'float64': 1e-10}

# ALGAMES on the first games of the oracle study (8: the first cut the time limit asked
# for; a Newton iteration is host-bound, so 16 games cost about 1.6x as long); its match
# with DGSQP is checked when at least ALGAMES_MIN_BOTH games converge in both
ALGAMES_GAMES, ALGAMES_MATCH_MIN, ALGAMES_MIN_BOTH = 8, 0.9, 4


# the closed-loop race (RaceStack(RaceConfig()): L_track_barc with its recorded
# raceline, mpc_N = game_N = 20, float64), held over its first RACE_HELD_STEPS control
# steps to the JAX package's record of the same race (float64, CPU); steps
# [RACE_PROFILED) run under the profiler for the device's idle share (and are left out
# of the per-step times)
RACE_RECORD = Path(__file__).resolve().parent / 'dgsqp_torch' / 'harness' / 'data' / \
    'race_reference_f64.json'
RACE_STEPS, RACE_HELD_STEPS, RACE_ATOL = 50, 10, 1e-6
RACE_PROFILED = (5, 7)
RACE_GAME_N = 20
# the planner's QP: n = game_N * 4 inputs, its polish 56 rows; B = 1
RACE_KERNEL_NS = (4 * RACE_GAME_N,)
RACE_CONVERGED = ('conv_abs_tol', 'conv_rel_tol')

# DGSQP v1's nested machine on the bench batch (256 games, N=25, float32, seed 0) in the
# bench's configuration with DGSQP_BENCH_NMLS=0 (monotone Armijo line search, cold QPs),
# through the nested solve_batch_chunked (chunks of 8 iterations, fixed layout), held
# against the JAX package's float32 run of the same configuration on the CPU (the
# record tests/test_torch_nested.py writes: 19 conv_abs / 220 conv_rel / 17 stalled);
# float32 plateaus near the tolerance, so most games exit conv_rel, and a rounding flip
# moves a game between conv_abs and conv_rel: the limits sit below the record's 0.074
# and 0.934, far above a broken solver, and are not drawn to the port's count
NESTED_RECORD = Path(__file__).resolve().parent / 'dgsqp_torch' / 'harness' / 'data' / \
    'nested_reference_f32.json'
NESTED_ENV = {'DGSQP_BENCH_NMLS': '0'}
NESTED_CHUNK = 8
NESTED_CONV_ABS_MIN, NESTED_CONV_ANY_MIN = 0.03, 0.85
# both kernels at the bench's n = 100 and the polish's 64 rows
NESTED_KERNEL_NS = (100, 64)
# nested_parity: one nested iteration of each machine on the first bench games, the
# card in float32 against the CPU in float64, the iterate within STEP_RTOL; and a host
# solve with game parameters of a parameterised integrator game, card against CPU, both
# float64 (the same iterations: rounding only)
NESTED_PARITY_GAMES = 16
NESTED_PARITY_CONFIGS = {
    'armijo': dict(nonmono_ls=False),
    'watchdog': dict(nonmono_ls=True, execution='nested'),
    'bfgs': dict(hessian_approximation='bfgs'),
}
PARAM_SOLVE_ATOL = 1e-8
# diagnose_path: the flow of scripts/torch_diagnose_failures.py at its defaults on the
# main_path's non-conv_abs games (padded to a power of two), traced through v1's nested
# body with the watchdog for DIAG_TRACE_ITERS iterations; the JAX package's TPU record
# (docs/diagnosis_r2.json, made at r2's parameters) is reported beside it, not held
DIAG_TRACE_ITERS = 50
DIAG_RECORD = dict(status_counts={'conv_abs_tol': 148, 'conv_rel_tol': 68, 'max_it': 26,
                                  'time_limit': 14},
                   failure_classes={'stalled': 76, 'infeasible': 32})

# sharded_path: the main path's batch and solver over max(2, device_count) ranks, a
# process a rank (two ranks share the one card over gloo), with compaction across ranks
# in chunks of SHARDED_CHUNK rounds; float32 rounding can flip a game between a
# compacted and an uncompacted run, so SHARDED_MIN_AGREE of the 256 games must end with
# main_path's status.  The study check runs scripts/torch_monte_carlo_main.py on
# mc_study's scenario and sizes (the script's own parameters otherwise) on one device
# and over the ranks, and holds the two runs' per-game statuses equal.
SHARDED_CHUNK = 4
SHARDED_MIN_AGREE = 243
SHARDED_TIMEOUT_S = 600
SHARDED_STUDY_ARGS = ['--scenario', 'agents', '--agents', str(MC_AGENTS), '--N',
                      str(MC_HORIZON), '--theta', '90', '--n', str(MC_SAMPLES),
                      '--solver', 'dgsqp_v2',
                      '--sqp_iters', '30', '--reg_init', '1e-3', '--reg_decay', '1.0',
                      '--nms_frequency', '5', '--nms_memory', '5']
# the ranks beside the parent and the nested child: the sharded child runs beside them
# when the machine has this many cores, else after the other children
SHARDED_MIN_CORES = 6

# every emitted line also goes to this file (the output's tail is all a caller may see)
LOG = Path(__file__).resolve().parent / 'build' / 'chip_smoke.jsonl'


def emit(obj):
    line = json.dumps(obj)
    print(line, flush=True)
    with open(LOG, 'a') as f:
        f.write(line + '\n')


def gpu_name_and_limit() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, launches: int = 20, reps: int = 10) -> float:
    """Device time of one launch of ``fn``: ``launches`` of them captured into a CUDA
    graph and replayed, so that the host's time to issue a launch (tens of microseconds
    through a Python wrapper, more than a fast kernel takes) is not in the number."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return time_ms(graph.replay, reps) / launches


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def spd_batch(B, n, dtype, device, gen, cond=COND):
    """Random SPD matrices U diag(s) U' with eigenvalues log-spaced in [1, cond]."""
    import torch
    X = torch.randn(B, n, n, generator=gen, device=device, dtype=torch.float64)
    U, _ = torch.linalg.qr(X)
    s = torch.logspace(0, torch.log10(torch.tensor(cond)).item(), n, dtype=torch.float64,
                       device=device)
    A = (U * s) @ U.transpose(-1, -2)
    return (0.5 * (A + A.transpose(-1, -2))).to(dtype).contiguous()


def phase_build():
    from dgsqp_torch.ops import linalg
    t0 = time.time()
    reports = linalg.build_kernels()
    seconds = time.time() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if 'registers' in ln or 'spill' in ln]
             for name, log in reports.items()}
    card = gpu_name_and_limit()
    print(card, flush=True)
    spills = {name: [ln for ln in lines if 'spill' in ln
                     and not ln.startswith('0 bytes stack frame, 0 bytes spill stores, '
                                           '0 bytes spill loads')]
              for name, lines in ptxas.items()}
    emit({'phase': 'build', 'seconds': round(seconds, 3), 'card': card, 'ptxas': ptxas,
          'spills_and_stack': spills})
    # the linear-algebra kernels hold their work in registers and shared memory; the
    # dynamics step keeps its hyper-dual state in local memory by design (its stack
    # frame and spills are reported above)
    spilled = [ln for name in ('chol', 'cho_solve') for ln in spills.get(name, [])]
    if spilled:
        raise AssertionError(f'ptxas reports register spills: {spilled}')
    return card


def bound(kind, B, n, k, dtype):
    """Least time for the function's work: both functions need only the lower triangle
    of their matrix input; chol writes all of L (its upper triangle as zero)."""
    it = 4 if dtype == 'float32' else 8
    tri = n * (n + 1) // 2
    if kind == 'chol':
        nbytes = B * (tri + n * n) * it
        flops = B * n ** 3 / 3
    else:
        nbytes = B * (tri + 2 * n * k) * it
        flops = 2 * B * n * n * k
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOP_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops else 'operations')


def check_non_pd(dtype, device, gen, B=8, n=100, bad=3):
    """A batch in which matrix ``bad`` is not positive definite: its factor and solution
    turn non-finite, nothing raises, and every other matrix matches the plain version."""
    import torch
    from dgsqp_torch.ops import linalg
    dname = str(dtype).split('.')[-1]
    A = spd_batch(B, n, dtype, device, gen)
    A[bad] = -A[bad]
    b = torch.randn(B, n, generator=gen, device=device, dtype=dtype)
    L, L_ref = linalg.cholesky(A), linalg.cholesky_plain(A)
    x, x_ref = linalg.cho_solve(L, b), linalg.cho_solve_plain(L_ref, b)
    good = [i for i in range(B) if i != bad]
    errs = {'chol': rel_err(L[good].double(), L_ref[good].double()),
            'cho_solve': rel_err(x[good].double(), x_ref[good].double())}
    if torch.isfinite(L[bad]).all() or torch.isfinite(x[bad]).all():
        raise AssertionError(f'non-PD matrix gave a finite factor or solution ({dname})')
    if not all(torch.isfinite(t[good]).all() for t in (L, x)) \
            or not all(e <= KERNEL_RTOL[dname] for e in errs.values()):
        raise AssertionError(f'a non-PD matrix disturbed its neighbours ({dname}): {errs}')
    return dict(kernel='non_pd', dtype=dname, B=B, n=n, bad=bad, rel_err=errs)


def phase_kernels(device='cuda', shapes=None, time_it=True):
    """Kernel against plain version at the main-path shapes; returns per-shape rows."""
    import torch
    from dgsqp_torch.ops import linalg
    gen = torch.Generator(device=device).manual_seed(0)
    shapes = shapes or {
        'chol': [(256, 100, 0), (256, 64, 0), (5, 37, 0), (64, 150, 0),
                 (16, 36, 0), (16, 48, 0), (256, 150, 0), (256, 96, 0), (256, 50, 0),
                 (256, 48, 0), (128, 120, 0), (128, 80, 0), (64, 60, 0), (64, 48, 0),
                 (64, 90, 0), (64, 64, 0), (1, 80, 0), (1, 56, 0), (128, 100, 0),
                 (128, 64, 0)],
        'cho_solve': [(256, 100, 1), (256, 100, 64), (256, 64, 1), (5, 37, 3), (256, 100, 8),
                      (256, 100, linalg.WARP_PATH_MAX_K), (256, 100, linalg.WARP_PATH_MAX_K + 1),
                      (256, 100, 33), (5, 37, 33), (64, 150, 1), (64, 150, 64),
                      (16, 36, 1), (16, 36, 36), (16, 36, 48), (16, 48, 1),
                      (256, 150, 1), (256, 150, 96), (256, 96, 1), (256, 50, 1),
                      (256, 50, 48), (256, 48, 1), (128, 120, 1), (128, 120, 80),
                      (128, 80, 1), (64, 60, 1), (64, 60, 48), (64, 48, 1), (64, 90, 1),
                      (64, 90, 64), (64, 64, 1), (1, 80, 1), (1, 80, 56), (1, 56, 1),
                      (128, 100, 1), (128, 100, 64), (128, 64, 1)]}
    rows = []
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split('.')[-1]
        for kind, shp in shapes.items():
            for B, n, k in shp:
                A = spd_batch(B, n, dtype, device, gen)
                if kind == 'chol':
                    out = linalg.cholesky(A)
                    ref = linalg.cholesky_plain(A)
                    if (torch.triu(out, 1) != 0).any():
                        raise AssertionError(f'chol {B}x{n} {dname}: upper triangle not zero')
                    kern = lambda: linalg.cholesky(A)
                    plain = lambda: linalg.cholesky_plain(A)
                    lib = lambda: torch.linalg.cholesky(A)
                else:
                    L = linalg.cholesky_plain(A)
                    b = torch.randn(B, n, k, generator=gen, device=device, dtype=dtype)
                    b = b[..., 0].contiguous() if k == 1 else b
                    out = linalg.cho_solve(L, b)
                    ref = linalg.cho_solve_plain(L, b)
                    b3 = b[..., None] if k == 1 else b
                    kern = lambda: linalg.cho_solve(L, b)
                    plain = lambda: linalg.cho_solve_plain(L, b)
                    lib = lambda: torch.cholesky_solve(b3, L)
                torch.cuda.synchronize() if device == 'cuda' else None
                err = rel_err(out.double(), ref.double())
                abs_err = float((out.double() - ref.double()).abs().max())
                if not (err <= KERNEL_RTOL[dname]) or not torch.isfinite(out).all():
                    raise AssertionError(f'{kind} B={B} n={n} k={k} {dname}: relative error '
                                         f'{err:.3e} > {KERNEL_RTOL[dname]:.0e}')
                row = dict(kernel=kind, dtype=dname, B=B, n=n, k=k, rel_err=err,
                           max_abs_err=abs_err, tol=KERNEL_RTOL[dname], cond=COND)
                if kind == 'cho_solve':
                    row['path'] = linalg.cho_solve_plan(n, k, A.element_size())[0]
                if time_it:
                    row['ms'] = graph_ms(kern)
                    row['eager_ms'] = time_ms(kern, 50)
                    row['plain_ms'] = time_ms(plain, 3)
                    row['library_ms'] = time_ms(lib, 20)
                    row['bound_ms'], row['bound_by'] = bound(kind, B, n, k, dname)
                rows.append(row)
        rows.append(check_non_pd(dtype, device, gen))
        rows += dyn_step_rows(dtype, device, time_it)
        rows += race_dyn_rows(dtype, device, time_it)
    from dgsqp_torch.ops.dynamics import dyn_step
    emit({'phase': 'kernels', 'kernels': ['chol', 'cho_solve', 'dyn_step'],
          'launches_in_this_phase': {'chol': linalg.cholesky.launches,
                                     'cho_solve': linalg.cho_solve.launches,
                                     'dyn_step': dyn_step.launches},
          'shapes': rows})
    return [r for r in rows if r['kernel'] != 'non_pd']


def dyn_models():
    """The dynamic bicycles of the two paths: the exact duel's (BARC car on
    ``L_track_barc``) and the F1 study's progress-augmented car on its segment."""
    from dgsqp_torch.harness.f1_study import build_f1_scenario
    from dgsqp_torch.harness.scenarios import build_dynamic_duel
    return {'combined': build_dynamic_duel(N=DYN_N).joint_model.dynamics_models[0],
            'progress': build_f1_scenario(N=F1_N).joint_model.dynamics_models[0]}


def dyn_points(model, P, dtype, device, seed=0):
    """P stage points of ``model``: moving, sliding and steering, on the track."""
    import torch
    gen = torch.Generator(device='cpu').manual_seed(seed)
    q = 0.3 * (2 * torch.rand(P, model.n_q, generator=gen, dtype=torch.float64) - 1)
    u = 0.3 * (2 * torch.rand(P, model.n_u, generator=gen, dtype=torch.float64) - 1)
    vx, s = (2, 6) if model.n_q == 8 else (0, 6)
    q[:, vx] += 1.5
    q[:, s] = model.track.track_length * torch.rand(P, generator=gen, dtype=torch.float64)
    if model.n_u == 3:
        u[:, 2] += 1.5
    return q.to(device, dtype), u.to(device, dtype)


def dyn_step_work(model, **step):
    """Arithmetic operations of one step at one point: the elements written by the
    pointwise operations of the model's own ``fd_plain`` (its fc evaluations and rk
    updates, an elementary function counted as one), counted on the CPU; ``step``
    overrides the step (``dt``, ``M``, ``method``) as ``dyn_step`` does."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if torch.Tag.pointwise in func.tags:
                outs = out if isinstance(out, (tuple, list)) else (out,)
                Count.n += sum(o.numel() for o in outs if isinstance(o, torch.Tensor))
            return out
    q, u = dyn_points(model, 1, torch.float64, 'cpu')
    with Count():
        model.fd_plain(q, u, **step)
    return Count.n


def dyn_bound(P, nq, nu, order, ops, dtype):
    """Least time for ``dyn_step``'s work: the points read and the outputs written once,
    and the step's ``ops`` operations a point (``dyn_step_work``) on the value and, by
    order, the L first and L (L + 1) / 2 distinct second derivatives of each, one
    operation per component."""
    it = 4 if dtype == 'float32' else 8
    L = nq + nu
    comps = 1 + (L if order >= 1 else 0) + (L * (L + 1) // 2 if order == 2 else 0)
    outs = 1 + (L if order >= 1 else 0) + (L * L if order == 2 else 0)
    nbytes = P * (L + nq * outs) * it
    flops = P * ops * comps
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOP_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops else 'operations')


def dyn_step_rows(dtype, device, time_it=True):
    """``dyn_step.cu`` against its plain version (``dyn_step_plain``, the same dtype on
    the card) at the paths' stage points: one stage of the 64 games' two cars (P = 128,
    the rollout's calls) and all 15 stages at once (P = 1920, ``evaluate_dp``'s call),
    orders 0, 1 and 2; each output's error relative to its largest entry."""
    import torch
    from dgsqp_torch.ops.dynamics import dyn_step, dyn_step_plain
    dname = str(dtype).split('.')[-1]
    rows = []
    for name, model in dyn_models().items():
        work = dyn_step_work(model)
        for P in (2 * DYN_GAMES, 2 * DYN_GAMES * DYN_N):
            q, u = dyn_points(model, P, dtype, device)
            ref = dyn_step_plain(model, q, u, 2)
            for order in (0, 1, 2):
                out = dyn_step(model, q, u, order)
                torch.cuda.synchronize()
                errs = [rel_err(o.double(), r.double()) for o, r in zip(out[:order + 1],
                                                                        ref[:order + 1])]
                err = max(errs)
                ok = all(bool(torch.isfinite(o).all()) for o in out[:order + 1])
                if not ok or not err <= DYN_KERNEL_RTOL[dname]:
                    raise AssertionError(f'dyn_step {name} P={P} order {order} {dname}: '
                                         f'relative error {err:.3e}')
                row = dict(kernel='dyn_step', model=name, dtype=dname, B=P, n=model.n_q,
                           k=order, rel_err=err, rel_err_f_J_H=errs,
                           max_abs_err=max(float((o.double() - r.double()).abs().max())
                                           for o, r in zip(out[:order + 1], ref[:order + 1])),
                           tol=DYN_KERNEL_RTOL[dname])
                if time_it:
                    kern = lambda: dyn_step(model, q, u, order)
                    row['ms'] = graph_ms(kern)
                    row['eager_ms'] = time_ms(kern, 20)
                    row['plain_ms'] = time_ms(lambda: dyn_step_plain(model, q, u, order), 2)
                    row['library_ms'] = None
                    row['step_ops'] = work
                    row['bound_ms'], row['bound_by'] = dyn_bound(P, model.n_q, model.n_u,
                                                                 order, work, dname)
                rows.append(row)
    return rows


def race_dyn_rows(dtype, device, time_it=True):
    """``dyn_step.cu`` against its plain version at the race's points: one car's step
    (P = 1, order 0) at the model's own step (the trackers' rollout) and at the plant's
    (``sim_dt`` 0.01 in max(8, M) rk4 sub-steps), and the linearization of one tracker's
    horizon (P = 20, order 1)."""
    import torch
    from dgsqp_torch.harness.race import RaceConfig, race_car_model
    from dgsqp_torch.ops.dynamics import dyn_step, dyn_step_plain
    from dgsqp_torch.tracks.track_lib import get_track
    dname = str(dtype).split('.')[-1]
    cfg = RaceConfig()
    model = race_car_model(get_track(cfg.track_name), cfg.control_dt)
    plant = dict(dt=cfg.sim_dt, M=max(8, model.M), method='rk4')
    rows = []
    for label, P, order, step in (('rollout', 1, 0, {}), ('plant', 1, 0, plant),
                                  ('linearization', cfg.mpc_N, 1, {})):
        q, u = dyn_points(model, P, dtype, device, seed=1)
        out = dyn_step(model, q, u, order, **step)
        ref = dyn_step_plain(model, q, u, order, **step)
        torch.cuda.synchronize()
        errs = [rel_err(o.double(), r.double()) for o, r in zip(out[:order + 1],
                                                                ref[:order + 1])]
        ok = all(bool(torch.isfinite(o).all()) for o in out[:order + 1])
        if not ok or not max(errs) <= DYN_KERNEL_RTOL[dname]:
            raise AssertionError(f'dyn_step race {label} P={P} order {order} {dname}: '
                                 f'relative error {max(errs):.3e}')
        row = dict(kernel='dyn_step', model='race_' + label, dtype=dname, B=P,
                   n=model.n_q, k=order, step={k: v for k, v in step.items()},
                   rel_err=max(errs), rel_err_f_J_H=errs,
                   max_abs_err=max(float((o.double() - r.double()).abs().max())
                                   for o, r in zip(out[:order + 1], ref[:order + 1])),
                   tol=DYN_KERNEL_RTOL[dname])
        if time_it:
            work = dyn_step_work(model, **step)
            kern = lambda: dyn_step(model, q, u, order, **step)
            row['ms'] = graph_ms(kern)
            row['eager_ms'] = time_ms(kern, 20)
            row['plain_ms'] = time_ms(lambda: dyn_step_plain(model, q, u, order, **step), 2)
            row['library_ms'] = None
            row['step_ops'] = work
            row['bound_ms'], row['bound_by'] = dyn_bound(P, model.n_q, model.n_u, order,
                                                         work, dname)
        rows.append(row)
    return rows


def _eval_and_step(sol, u0, l0, x0, up):
    """One evaluate + convexified QP step: v1's ``_qp(Q, q, G, g)`` on the game Hessian,
    or v2's symmetrised Hessian and ``_qp`` with the initial regularisation."""
    import torch
    from dgsqp_torch.solvers.dgsqp_v2 import DGSQPV2
    if isinstance(sol, DGSQPV2):
        out = sol._eval_full(u0, l0, x0, up, None)
        reg = torch.full((u0.shape[0],), sol.params.reg, dtype=sol.dtype, device=sol.device)
        return out, sol._qp(*out, reg)[0]
    out = sol.problem.evaluate(u0, l0, x0, up)[:4]
    return out, sol._qp(*out)[0]


def phase_parity(sc, sol_dev, sol_cpu, batch, n_games=16, phase='parity'):
    """One evaluate + convexified QP: the port on the card (f32) against the port on the
    CPU (f64) on the same inputs."""
    import torch
    u0, l0, x0, up = (a[:n_games] for a in batch)
    out_d, du_d = _eval_and_step(sol_dev, u0, l0, x0, up)
    args_c = [a.detach().to('cpu', torch.float64) for a in (u0, l0, x0, up)]
    out_c, du_c = _eval_and_step(sol_cpu, *args_c)
    diffs = {name: rel_err(a.to('cpu', torch.float64), b)
             for name, a, b in zip('Q q G g'.split(), out_d, out_c)}
    diffs['du'] = rel_err(du_d.to('cpu', torch.float64), du_c)
    line = {'phase': phase, 'scenario': sc.name, 'games': n_games, 'rel_diff': diffs,
            'tol': {'derivatives': DERIV_RTOL, 'du': STEP_RTOL},
            'why': 'f32 on the card vs f64 on the CPU: derivatives carry f32 rounding '
                   'through the rollout; the QP step is solved to 3e-7 after Ruiz scaling'}
    emit(line)
    bad = [k for k, v in diffs.items()
           if not v <= (STEP_RTOL if k == 'du' else DERIV_RTOL)]
    if bad:
        raise AssertionError(f'{phase} outside tolerance: {bad}')
    return diffs


def reset_launches():
    from dgsqp_torch.ops import linalg
    for wrapper in (linalg.cholesky, linalg.cho_solve):
        wrapper.launches = 0
        wrapper.launches_by_n = {}


def read_launches():
    from dgsqp_torch.ops import linalg
    return {'chol': linalg.cholesky.launches, 'cho_solve': linalg.cho_solve.launches}


def read_launches_by_n():
    from dgsqp_torch.ops import linalg
    return {'chol': dict(linalg.cholesky.launches_by_n),
            'cho_solve': dict(linalg.cho_solve.launches_by_n)}


def phase_bench_path(phase, solver_name, sol, batch, conv_min, conv_any_min, chunk=4,
                     metric='chicane_2agent_solves_per_s', n_dec=None, conv_abs_limit=None,
                     kernel_ns=(), extra=None, hold=None, compact=True):
    """Solve the bench batch through the bench entry (``run_bench``: a warm-up of one
    chunk on a few games, then one timed ``sol.solve_batch_chunked(chunk_iters=chunk,
    compact=compact)``), print the entry's line (``bench.py``'s fields) under the
    phase's ``metric`` with the phase's own fields, and check the result.  Every result
    must be finite; for v2 and the approximate game a game that diverged is exempt (it
    stops with whatever iterate it had).  ``conv_min`` fails the phase below it;
    ``n_dec``, where given, is the decision count the path must run at, and both kernels
    must have launched at every matrix size of ``kernel_ns``; ``extra(result)``, where
    given, adds its dict to the line; ``hold(status)``, where given, returns (fields for
    the line, problems)."""
    import numpy as np
    import torch
    from dgsqp_torch.harness.bench import BenchConfig, run_bench
    from dgsqp_torch.ops import linalg
    from dgsqp_torch.solvers.dgsqp import DIVERGED, RUNNING
    B = batch[0].shape[0]

    # count the batched QP solves (one per round) beside the kernels' launches, from 0
    # just before the timed solve
    qp_calls = [0]
    attr_sets = [0]
    inner_qp = sol._qp

    def counted_qp(*a, **k):
        qp_calls[0] += 1
        return inner_qp(*a, **k)

    def reset():
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        qp_calls[0] = 0
        attr_sets[0] = linalg.cholesky.attr_sets + linalg.cho_solve.attr_sets

    sol._qp = counted_qp
    try:
        run = run_bench(BenchConfig(batch=B, horizon=sol.N, solver_name=solver_name,
                                    chunk=chunk, compact=compact, reps=1),
                        solver=sol, batch=batch, before_solve=reset)
    finally:
        del sol._qp
    res = run.result
    launches = read_launches()
    launches_by_n = read_launches_by_n()

    status = res.status.cpu().numpy()
    iters = res.iters.cpu().numpy()
    conv = run.line['convergence_rate']
    conv_any = run.line['convergence_rate_incl_rel']
    chunks = run.chunk_history
    line = {
        'phase': phase,
        **run.line,
        'metric': metric,
        'solve_s': run.rep_s[0],
        'warmup_s': run.warmup_s,
        'iters_p50': float(np.median(iters)), 'iters_max': int(iters.max()),
        'n_dec': sol.n_dec, 'n_c': sol.n_c, 'dtype': str(sol.dtype),
        'chunks': len(chunks), 'running_after_chunk': [c['running'] for c in chunks],
        'chunk_batch': [c['batch'] for c in chunks],
        'chunk_wall_s': [c['wall_s'] for c in chunks],
        'launches': launches, 'launches_by_n': launches_by_n, 'qp_calls': qp_calls[0],
        'peak_device_mib': torch.cuda.max_memory_allocated() / 2 ** 20,
        'attr_sets_in_this_solve': (linalg.cholesky.attr_sets + linalg.cho_solve.attr_sets
                                    - attr_sets[0]),
        # one digit per game, in batch order: the game's status code
        'status_string': ''.join(str(int(s)) for s in status),
    }
    v2_family = solver_name in ('v2', 'approx')
    if v2_family:
        m_its = sol.last_m_iters.cpu().numpy()
        line['m_steps_p50'] = float(np.median(m_its))
        line['m_steps_max'] = int(m_its.max())
    if conv_abs_limit is not None:
        line['conv_abs_limit'] = conv_abs_limit
        line['conv_abs_at_or_above_limit'] = conv >= conv_abs_limit
    if extra is not None:
        line.update(extra(res))
    held_problems = []
    if hold is not None:
        fields, held_problems = hold(status)
        line.update(fields)
    emit(line)
    alive = torch.as_tensor((status != DIVERGED) | (not v2_family), device=res.u.device)
    finite = all(bool(torch.isfinite(t[alive]).all()) for t in (res.u, res.l, res.stat,
                                                                res.p_feas, res.comp))
    problems = list(held_problems)
    if not all(v > 0 for v in launches.values()):
        problems.append(f'a kernel was not launched on {phase}: {launches}')
    if (status == RUNNING).any():
        problems.append('games still running')
    if not finite:
        problems.append('non-finite results')
    if conv < conv_min or conv_any < conv_any_min:
        problems.append(f'convergence {conv:.3f}/{conv_any:.3f} below '
                        f'{conv_min}/{conv_any_min}')
    if n_dec is not None and sol.n_dec != n_dec:
        problems.append(f'the path ran at n = {sol.n_dec}, not {n_dec}')
    missing = [(name, n) for name in launches_by_n for n in kernel_ns
               if not launches_by_n[name].get(n)]
    if missing:
        problems.append(f'kernels not launched at these sizes: {missing}')
    if problems:
        raise AssertionError(f'{phase}: ' + '; '.join(problems))
    return line


def hold_bench_record(status):
    """``main_path``'s per-game statuses counted against the JAX package's float32 CPU
    run of the same batch and solve: (fields for the line, problems)."""
    import numpy as np
    from dgsqp_torch.solvers.dgsqp import STATUS_MSG
    rec = json.loads(BENCH_RECORD.read_text())
    ref = np.array(rec['status'])
    agree = int((status == ref).sum())
    fields = {'statuses_vs_jax_cpu_float32': agree, 'min_agree_with_record': BENCH_MIN_AGREE,
              'record_status_counts': rec['status_counts'],
              'games_unlike_record': {int(g): [STATUS_MSG[int(status[g])],
                                               STATUS_MSG[int(ref[g])]]
                                      for g in np.where(status != ref)[0]}}
    problems = [] if agree >= BENCH_MIN_AGREE else [
        f'{agree} games end as in the JAX float32 record, fewer than {BENCH_MIN_AGREE}']
    return fields, problems


BENCH_CLI_OUT = Path(__file__).resolve().parent / 'build' / 'bench_cli.json'


def bench_cli_env() -> dict:
    return {'DGSQP_BENCH_BATCH': str(BENCH_CLI_GAMES), 'DGSQP_BENCH_REPS': '1',
            'DGSQP_BENCH_OUT': str(BENCH_CLI_OUT)}


def start_bench_cli():
    """``scripts/torch_bench.py`` on ``main_path``'s batch, in a process of its own
    (host-bound on its core beside the phases that follow)."""
    here = Path(__file__).resolve().parent
    if BENCH_CLI_OUT.exists():
        BENCH_CLI_OUT.unlink()
    env = {k: v for k, v in os.environ.items() if not k.startswith('DGSQP_BENCH_')}
    env.update(bench_cli_env())
    proc = subprocess.Popen([sys.executable, str(here / 'scripts' / 'torch_bench.py')],
                            cwd=here, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, time.time()


def phase_bench_cli(cli, main_status: str):
    """``bench_cli``: the bench's CLI ran once; its last line is the bench's line for
    ``BENCH_CLI_GAMES`` games on the card, and each game ends as in ``main_path``."""
    from dgsqp_torch.harness.bench import LINE_KEYS
    proc, t0 = cli
    out, err = proc.communicate(timeout=BENCH_CLI_TIMEOUT_S)
    seconds = time.time() - t0
    lines = out.strip().splitlines()
    try:
        last = json.loads(lines[-1])
    except (IndexError, ValueError):
        last = None
    written = json.loads(BENCH_CLI_OUT.read_text()) if BENCH_CLI_OUT.exists() else {}
    status = ''.join(str(s) for s in written.get('status', []))
    want = main_status[:BENCH_CLI_GAMES]
    line = {'phase': 'bench_cli', 'command': 'python3 scripts/torch_bench.py',
            'env': bench_cli_env(), 'exit_code': proc.returncode, 'seconds': seconds,
            'last_line': last, 'status_string': status,
            'main_path_status_string': want,
            'agree_with_main_path': sum(a == b for a, b in zip(status, want)),
            'stderr_tail': [ln for ln in err.splitlines() if ln.startswith('#')][-6:]}
    emit(line)
    problems = []
    if proc.returncode != 0 or last is None:
        problems.append(f'exit code {proc.returncode}, last line {lines[-1:]}: '
                        f'{err[-2000:]}')
    else:
        if set(last) != set(LINE_KEYS):
            problems.append(f'its line has the fields {sorted(last)}')
        if (last.get('platform'), last.get('batch'), last.get('horizon')) != \
                ('gpu', BENCH_CLI_GAMES, 25):
            problems.append(f"platform/batch/horizon {last.get('platform')}/"
                            f"{last.get('batch')}/{last.get('horizon')}")
        if status != want:
            problems.append(f'statuses {status} against main_path\'s {want}')
    if problems:
        raise AssertionError('bench_cli: ' + '; '.join(problems))
    return line


def phase_mc_study():
    """The Monte-Carlo entry point at a small depth: the agents study with DGSQP v2."""
    import torch
    from dgsqp_torch.harness.mc_study import analyze_results, run_mc_study
    from dgsqp_torch.harness.scenarios import build_agents_scenario
    from dgsqp_torch.solvers.dgsqp import RUNNING
    from dgsqp_torch.solvers.dgsqp_v2 import DGSQPV2
    from dgsqp_torch.solvers.solver_types import DGSQPV2Params
    sc = build_agents_scenario(M=MC_AGENTS, N=MC_HORIZON)
    params = DGSQPV2Params(N=sc.N, dt=sc.dt, qp_tol=3e-7, **MC_PARAMS)
    reset_launches()
    t0 = time.time()
    res = run_mc_study(sc, solver_params=params, num_samples=MC_SAMPLES, seed=0,
                       solver_cls=DGSQPV2, dtype=torch.float32)
    seconds = time.time() - t0
    launches = read_launches()
    stats = analyze_results(res)
    n_dec = int(res.u_sol.shape[1])
    emit({'phase': 'mc_study', 'scenario': sc.name, 'n_dec': n_dec, 'seconds': seconds,
          'launches': launches, 'analyze_results': stats,
          'status_string': ''.join(str(int(s)) for s in res.statuses)})
    problems = []
    if n_dec != 2 * MC_AGENTS * MC_HORIZON:
        problems.append(f'the study ran at n = {n_dec}')
    if not all(v > 0 for v in launches.values()):
        problems.append(f'a kernel was not launched in the study: {launches}')
    if (res.statuses == RUNNING).any():
        problems.append('games still running')
    prov = res.provenance
    if prov['device_name'] != torch.cuda.get_device_name(0) or prov['platform'] != 'cuda':
        problems.append(f'provenance does not name the card: {prov}')
    if problems:
        raise AssertionError('mc_study: ' + '; '.join(problems))
    return launches


def _pcts(t):
    import numpy as np
    v = t.double().cpu().numpy()
    return {'p50': float(np.median(v)), 'p90': float(np.percentile(v, 90))}


def phase_oracle_path():
    """The DGSQP-vs-MCP equilibrium-match study at full width, float64 on the card."""
    import numpy as np
    import torch
    from dgsqp_torch.harness.analysis import gne_compare
    from dgsqp_torch.harness.mc_study import analyze_results, run_mc_study
    from dgsqp_torch.harness.scenarios import build_chicane_scenario
    from dgsqp_torch.solvers.mcp import PATHMCP
    from dgsqp_torch.solvers.solver_types import PATHMCPParams
    sc = build_chicane_scenario(N=25, theta_deg=45.0)
    reset_launches()
    t0 = time.time()
    dg = run_mc_study(sc, num_samples=ORACLE_GAMES, seed=ORACLE_SEED, dtype=torch.float64)
    dg_s = time.time() - t0
    mcp = PATHMCP(sc.joint_model, sc.costs, sc.agent_constraints, sc.shared_constraints,
                  sc.bounds, PATHMCPParams(N=sc.N, dt=sc.dt, tol=1e-3, method='hybrid',
                                           max_iters=200, max_restarts=4),
                  print_method=None, dtype=torch.float64)
    t0 = time.time()
    mc = run_mc_study(sc, num_samples=ORACLE_GAMES, seed=ORACLE_SEED, solver=mcp)
    mc_s = time.time() - t0
    launches, launches_by_n = read_launches(), read_launches_by_n()
    rep = gne_compare(dg, mc, **ORACLE_COMPARE)
    conv_dg = float(rep['converged_a'] / ORACLE_GAMES)
    conv_mc = float(rep['converged_b'] / ORACLE_GAMES)
    jax_cpu = json.loads(ORACLE_STATUS_RECORD.read_text())
    if (jax_cpu['games'], jax_cpu['seed']) != (ORACLE_GAMES, ORACLE_SEED):
        raise AssertionError('oracle_path: the status record is not of these games')
    as_jax = {}
    for name, res in (('dgsqp', dg), ('mcp', mc)):
        ref = np.array([int(ch) for ch in jax_cpu['status_string'][name]])
        as_jax[name] = {'games_as_record': int((res.statuses == ref).sum()),
                        'games_differing': np.flatnonzero(res.statuses != ref).tolist()}
    emit({'phase': 'oracle_path', 'scenario': sc.name, 'games': ORACLE_GAMES,
          'n_dec': mcp.n_dec, 'n_c': mcp.n_c, 'dtype': 'float64',
          'dgsqp': analyze_results(dg), 'mcp': analyze_results(mc),
          'dgsqp_seconds': dg_s, 'mcp_seconds': mc_s,
          'dgsqp_solve_s': dg.wall_time_s, 'mcp_solve_s': mc.wall_time_s,
          'mcp_iters_p50': float(np.median(mc.iters)), 'mcp_iters_max': int(mc.iters.max()),
          'dgsqp_conv_abs': conv_dg, 'mcp_conv_abs': conv_mc,
          'gne_compare': rep, 'record': ORACLE_RECORD,
          'statuses_vs_jax_cpu_float64': as_jax,
          'limits': {'match_rate_of_both': ORACLE_MATCH_MIN,
                     'mcp_conv_abs': ORACLE_MCP_CONV_MIN,
                     'dgsqp_conv_abs': ORACLE_DGSQP_CONV_MIN},
          'launches': launches, 'launches_by_n': launches_by_n,
          'status_string_dgsqp': ''.join(str(int(s)) for s in dg.statuses),
          'status_string_mcp': ''.join(str(int(s)) for s in mc.statuses)})
    problems = []
    if not np.array_equal(dg.x0, mc.x0):
        problems.append('the two studies sampled different games')
    if not all(v > 0 for v in launches.values()):
        problems.append(f'a kernel was not launched on oracle_path: {launches}')
    if (mc.statuses == 0).any() or (dg.statuses == 0).any():
        problems.append('games still running')
    if not np.isfinite(mc.u_sol).all() or not np.isfinite(dg.u_sol).all():
        problems.append('non-finite solutions')
    if rep['match_rate_of_both'] < ORACLE_MATCH_MIN:
        problems.append(f"match rate {rep['match_rate_of_both']:.3f} < {ORACLE_MATCH_MIN}")
    if conv_mc < ORACLE_MCP_CONV_MIN or conv_dg < ORACLE_DGSQP_CONV_MIN:
        problems.append(f'conv_abs MCP {conv_mc:.3f} / DGSQP {conv_dg:.3f} below '
                        f'{ORACLE_MCP_CONV_MIN} / {ORACLE_DGSQP_CONV_MIN}')
    if problems:
        raise AssertionError('oracle_path: ' + '; '.join(problems))
    return sc, dg, launches


def phase_ibr_ws(sc, batch):
    """One batched IBR sweep of the study's warm start on the bench batch (float32)."""
    import torch
    from dgsqp_torch.solvers.ibr import IBR
    from dgsqp_torch.solvers.solver_types import IBRParams
    u0, _, x0, up = batch
    ibr = IBR(sc.joint_model, sc.costs, sc.agent_constraints, sc.shared_constraints,
              sc.bounds, IBRParams(N=sc.N, dt=sc.dt, ibr_iters=1, p_tol=1e-3, d_tol=1e-3),
              print_method=None, dtype=u0.dtype, device=u0.device)
    reset_launches()
    t0 = time.time()
    res = ibr._solve_core(u0, x0, up)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches, launches_by_n = read_launches(), read_launches_by_n()
    kkt = {a: _pcts(k) for a, k in ibr.last_br_kkt.items()}
    its = {a: {'p50': float(it.double().median()), 'max': int(it.max())}
           for a, it in ibr.last_br_iters.items()}
    emit({'phase': 'ibr_ws', 'games': int(u0.shape[0]), 'dtype': str(u0.dtype),
          'n_br': [s1 - s0 for s0, s1 in ibr.ua_slices], 'seconds': seconds,
          'launches': launches, 'launches_by_n': launches_by_n, 'br_kkt': kkt,
          'br_sqp_iters': its, 'delta': _pcts(res.delta),
          'converged': int(res.converged.sum())})
    problems = []
    missing = [(name, n) for name in launches_by_n for n in IBR_KERNEL_NS
               if not launches_by_n[name].get(n)]
    if missing:
        problems.append(f'kernels not launched at these sizes: {missing}')
    if not bool(torch.isfinite(res.u).all()) or not bool(torch.isfinite(res.delta).all()) \
            or not all(bool(torch.isfinite(k).all()) for k in ibr.last_br_kkt.values()):
        problems.append('non-finite results')
    if problems:
        raise AssertionError('ibr_ws: ' + '; '.join(problems))
    return launches


def phase_algames_path(sc, dg):
    """``run_mc_study_algames`` on the first games of the oracle study's draw (the
    sampler draws in rounds sized by the sample count, so the study samples the oracle's
    128 and keeps the first ``ALGAMES_GAMES``), float64, against its DGSQP."""
    import dataclasses
    import numpy as np
    import torch
    from dgsqp_torch.harness import mc_study
    from dgsqp_torch.harness.analysis import gne_compare
    sample = mc_study._sample

    def oracle_head(scenario, num_samples, seed, dtype, device):
        return tuple(a[:num_samples] for a in sample(scenario, ORACLE_GAMES, seed, dtype,
                                                     device))

    mc_study._sample = oracle_head
    t0 = time.time()
    try:
        al = mc_study.run_mc_study_algames(sc, num_samples=ALGAMES_GAMES, seed=ORACLE_SEED,
                                           dtype=torch.float64)
    finally:
        mc_study._sample = sample
    seconds = time.time() - t0
    head = lambda a: a[:ALGAMES_GAMES]
    dg16 = dataclasses.replace(dg, num_samples=ALGAMES_GAMES, statuses=head(dg.statuses),
                               iters=head(dg.iters), qp_solves=head(dg.qp_solves),
                               p_feas=head(dg.p_feas), comp=head(dg.comp),
                               stat=head(dg.stat), u_sol=head(dg.u_sol), x0=head(dg.x0))
    rep = gne_compare(dg16, al, layout_b='stage', **ORACLE_COMPARE)
    emit({'phase': 'algames_path', 'games': ALGAMES_GAMES, 'dtype': 'float64',
          'n_y': sc.N * (sc.joint_model.n_q + sc.joint_model.n_u)
                 + sc.joint_model.n_a * sc.N * sc.joint_model.n_q,
          'seconds': seconds, 'solve_s': al.wall_time_s, 'warmup_s': al.compile_time_s,
          'statuses': ''.join(str(int(s)) for s in al.statuses),
          'outer_iters': al.iters.tolist(), 'newton_solves': al.qp_solves.tolist(),
          'stat': al.stat.tolist(), 'p_feas': al.p_feas.tolist(),
          'gne_compare_vs_dgsqp': rep})
    problems = []
    if not np.array_equal(al.x0, dg16.x0):
        problems.append('ALGAMES sampled other games than the oracle study')
    if not np.isfinite(al.u_sol).all() or not np.isfinite(al.stat).all():
        problems.append('non-finite results')
    if rep['both_converged'] >= ALGAMES_MIN_BOTH and \
            rep['match_rate_of_both'] < ALGAMES_MATCH_MIN:
        problems.append(f"match rate {rep['match_rate_of_both']:.3f} < {ALGAMES_MATCH_MIN}")
    if problems:
        raise AssertionError('algames_path: ' + '; '.join(problems))


def phase_merge_path(device='cuda'):
    """The merge's DGSQP-vs-MCP equilibrium-match study at full width, float64 on the
    card."""
    import numpy as np
    import torch
    from dgsqp_torch.harness.analysis import gne_compare
    from dgsqp_torch.harness.mc_study import analyze_results, run_mc_study
    from dgsqp_torch.harness.scenarios import build_merge_scenario
    from dgsqp_torch.solvers.mcp import PATHMCP
    from dgsqp_torch.solvers.solver_types import PATHMCPParams
    sc = build_merge_scenario(N=MERGE_N)
    reset_launches()
    t0 = time.time()
    dg = run_mc_study(sc, num_samples=MERGE_GAMES, seed=MERGE_SEED, dtype=torch.float64,
                      device=device)
    dg_s = time.time() - t0
    mcp = PATHMCP(sc.joint_model, sc.costs, sc.agent_constraints, sc.shared_constraints,
                  sc.bounds, PATHMCPParams(N=sc.N, dt=sc.dt, tol=1e-3, method='hybrid',
                                           max_iters=200, max_restarts=4),
                  print_method=None, dtype=torch.float64, device=device)
    t0 = time.time()
    mc = run_mc_study(sc, num_samples=MERGE_GAMES, seed=MERGE_SEED, solver=mcp)
    mc_s = time.time() - t0
    launches, launches_by_n = read_launches(), read_launches_by_n()
    rep = gne_compare(dg, mc, **MERGE_COMPARE)
    conv_dg = float(rep['converged_a'] / MERGE_GAMES)
    conv_mc = float(rep['converged_b'] / MERGE_GAMES)
    line = {'phase': 'merge_path', 'scenario': sc.name, 'horizon': sc.N,
            'n_dec': mcp.n_dec, 'n_c': mcp.n_c, 'dtype': 'float64', 'games': MERGE_GAMES,
            'dgsqp': analyze_results(dg), 'mcp': analyze_results(mc),
            'dgsqp_seconds': dg_s, 'mcp_seconds': mc_s,
            'dgsqp_solve_s': dg.wall_time_s, 'mcp_solve_s': mc.wall_time_s,
            'mcp_iters_p50': float(np.median(mc.iters)), 'mcp_iters_max': int(mc.iters.max()),
            'dgsqp_conv_abs': conv_dg, 'mcp_conv_abs': conv_mc,
            'both': rep['both_converged'], 'match': rep['match'],
            'match_rate_of_both': rep['match_rate_of_both'],
            'nmse_median': rep.get('nmse_median'), 'nmse_max': rep.get('nmse_max'),
            'gne_compare': rep, 'record': MERGE_RECORD,
            'record_counts': 'the r3 solver, conv incl. rel',
            'limits': {'match_rate_of_both': MERGE_MATCH_MIN,
                       'dgsqp_conv_abs': MERGE_DGSQP_CONV_MIN,
                       'mcp_conv_abs': MERGE_MCP_CONV_MIN},
            'launches': launches, 'launches_by_n': launches_by_n,
            'status_string_dgsqp': ''.join(str(int(s)) for s in dg.statuses),
            'status_string_mcp': ''.join(str(int(s)) for s in mc.statuses)}
    emit(line)
    problems = []
    if not np.array_equal(dg.x0, mc.x0):
        problems.append('the two studies sampled different games')
    if mcp.n_dec != 3 * 2 * MERGE_N:
        problems.append(f'the study ran at n = {mcp.n_dec}')
    missing = [(name, n) for name in launches_by_n for n in MERGE_KERNEL_NS
               if not launches_by_n[name].get(n)]
    if missing:
        problems.append(f'kernels not launched at these sizes: {missing}')
    if (mc.statuses == 0).any() or (dg.statuses == 0).any():
        problems.append('games still running')
    if not np.isfinite(mc.u_sol).all() or not np.isfinite(dg.u_sol).all():
        problems.append('non-finite solutions')
    if rep['match_rate_of_both'] < MERGE_MATCH_MIN:
        problems.append(f"match rate {rep['match_rate_of_both']:.3f} < {MERGE_MATCH_MIN}")
    if conv_mc < MERGE_MCP_CONV_MIN or conv_dg < MERGE_DGSQP_CONV_MIN:
        problems.append(f'conv_abs MCP {conv_mc:.3f} / DGSQP {conv_dg:.3f} below '
                        f'{MERGE_MCP_CONV_MIN} / {MERGE_DGSQP_CONV_MIN}')
    if problems:
        raise AssertionError('merge_path: ' + '; '.join(problems))
    return launches


MERGE_CHILD = '--merge-path'
ORACLE_CHILD = '--oracle-paths'
DYNAMIC_CHILD = '--dynamic-paths'
RACE_CHILD = '--race-path'
NESTED_CHILD = '--nested-paths'
SHARDED_CHILD = '--sharded-path'


def start_child(flag, *args):
    """Start a path (``merge_path``; ``dynamic_path`` then ``f1_path``) in a process of
    its own, beside the phases that follow: the paths are host-bound (one CPU core each,
    the card idle most of the time), so each runs on another core.  The child counts its
    own launches."""
    here = Path(__file__).resolve()
    return subprocess.Popen([sys.executable, str(here), flag, *args], cwd=here.parent,
                            stdout=subprocess.PIPE, text=True)


def finish_child(proc, phases, timeout=900, uncounted=()):
    """Wait for a child, emit its phases' lines here, fail if it failed; returns the
    launches of each phase but those of ``uncounted`` (phases that launch neither
    kernel carry no count)."""
    out, _ = proc.communicate(timeout=timeout)
    lines = {ln['phase']: ln for ln in (json.loads(x) for x in out.splitlines()
                                        if x.startswith('{')) if 'phase' in ln}
    for phase in phases:
        if phase in lines:
            emit(lines[phase])
    if proc.returncode != 0 or any(p not in lines for p in phases):
        raise AssertionError(f'{" and ".join(phases)} failed in its process '
                             f'(exit code {proc.returncode})')
    return {phase: lines[phase]['launches'] for phase in phases if phase not in uncounted}


def ms_and_launches(fn, reps=3):
    """Median wall time (ms) of ``fn`` with a synchronise after each call, and the
    CUDA kernels (and copies) one call issues, counted by ``torch.profiler``."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    fn()
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    launches = sum(1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    return float(np.median(times)) * 1e3, launches


def merge_dp_batch(games, device='cuda'):
    """The merge study's games (seed 0, warm start all zero, least-squares duals) and
    its game problem, in float32 on the card."""
    import torch
    from dgsqp_torch.harness.samplers import sample_merge_initial_conditions
    from dgsqp_torch.harness.scenarios import build_merge_scenario
    from dgsqp_torch.solvers.game_problem import GameProblem
    dtype = torch.float32
    sc = build_merge_scenario(N=MERGE_N)
    problem = GameProblem(sc.joint_model, sc.costs, sc.agent_constraints,
                          sc.shared_constraints, sc.bounds, sc.N, dtype=dtype, device=device)
    x0, u_ws, _, _ = sample_merge_initial_conditions(sc, games, seed=MERGE_SEED, dtype=dtype,
                                                     device=device)
    u0 = problem.stage_to_u(torch.as_tensor(u_ws, dtype=dtype, device=device))
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    up = torch.zeros(games, sc.joint_model.n_u, dtype=dtype, device=device)
    return problem, (u0, problem.dual_warm_start(u0, x0, up), x0, up)


def phase_dp_parity(cases):
    """``evaluate_dp`` against ``evaluate`` (both with the Hessian, float32, on the card,
    the same inputs) on each batch of ``cases``: relative differences of Q, q, G and g,
    the median time of a call and the CUDA launches of one."""
    rows, bad = {}, []
    for name, (problem, (u0, l0, x0, up)) in cases.items():
        ad = problem.evaluate(u0, l0, x0, up)[:4]
        dp = problem.evaluate_dp(u0, l0, x0, up)[:4]
        diffs = {k: rel_err(a.double(), b.double())
                 for k, a, b in zip('Q q G g'.split(), dp, ad)}
        finite = all(bool(t.isfinite().all()) for t in dp)
        ms_ad, n_ad = ms_and_launches(lambda: problem.evaluate(u0, l0, x0, up))
        ms_dp, n_dp = ms_and_launches(lambda: problem.evaluate_dp(u0, l0, x0, up))
        rows[name] = {'games': int(u0.shape[0]), 'n_dec': problem.n_dec,
                      'n_c': problem.n_c_total, 'dtype': str(u0.dtype), 'rel_diff': diffs,
                      'evaluate_ms': ms_ad, 'evaluate_dp_ms': ms_dp,
                      'evaluate_launches': n_ad, 'evaluate_dp_launches': n_dp}
        bad += [f'{name} {k} {v:.2e}' for k, v in diffs.items() if not v <= DP_RTOL]
        if not finite:
            bad.append(f'{name}: non-finite evaluate_dp')
    emit({'phase': 'dp_parity', 'batches': rows, 'tol': DP_RTOL,
          'why': 'both float32 on the card: each carries f32 rounding through the 25-step '
                 'rollout (~1e-6 relative), summed in another order'})
    if bad:
        raise AssertionError(f'dp_parity outside tolerance: {bad}')
    return rows


def dyn_launches():
    from dgsqp_torch.ops.dynamics import dyn_step
    return dyn_step.launches


def reset_dyn_launches():
    from dgsqp_torch.ops.dynamics import dyn_step
    dyn_step.launches = 0
    dyn_step.launches_by_order = {}
    dyn_step.launches_by_shape = {}


def dynamic_solver(sc, dtype, device, hessian_mode='ad'):
    """DGSQP v2 of the dynamic duel with the study script's parameters (its defaults,
    and the float32 QP tolerance of the other study paths)."""
    import torch
    from dgsqp_torch.solvers.dgsqp_v2 import DGSQPV2
    from dgsqp_torch.solvers.solver_types import DGSQPV2Params
    params = DGSQPV2Params(N=sc.N, dt=sc.dt, sqp_iters=50, p_tol=1e-3, d_tol=1e-3,
                           merit_function='stat_l1', merit_decrease_condition='armijo',
                           nms=True, qp_tol=3e-7 if dtype == torch.float32 else 1e-8,
                           hessian_mode=hessian_mode)
    return DGSQPV2(sc.joint_model, sc.costs, sc.agent_constraints, sc.shared_constraints,
                   sc.bounds, params, print_method=None, dtype=dtype, device=device)


def dynamic_approx_solver(sc, dtype, device):
    """``DGSQPV2FrenetApprox`` of the approximate dynamic duel with the study script's
    approximate-game parameters."""
    import torch
    from dgsqp_torch.solvers.dgsqp_v2_frenet import DGSQPV2FrenetApprox
    from dgsqp_torch.solvers.solver_types import DGSQPV2Params
    params = DGSQPV2Params(N=sc.N, dt=sc.dt, sqp_iters=150, p_tol=1e-3, d_tol=1e-3,
                           approximation_eval='exact', reg=1.0, reg_decay=1.0,
                           nms_frequency=1, nms_memory_size=10,
                           nms_initial_step_size_factor=0.0, conv_scaled_stat=True,
                           conv_method='eigh',
                           qp_tol=3e-7 if dtype == torch.float32 else 1e-8)
    return DGSQPV2FrenetApprox(sc.joint_model, sc.costs, sc.agent_constraints,
                               sc.shared_constraints, sc.bounds, params, print_method=None,
                               dtype=dtype, device=device)


def study_batch(sc, sol, games, sampler):
    """A study's games in the solver's dtype and device: sampled, warm-started and with
    the dual warm start, as ``run_mc_study`` prepares them."""
    import torch
    from dgsqp_torch.harness.mc_study import _dual_warm_start
    from dgsqp_torch.harness.warm_start import seed_virtual_rate_prev
    x0, u_ws, _, _ = sampler(sc, games, seed=0, dtype=sol.dtype, device=sol.device)
    u_ws = torch.as_tensor(u_ws, dtype=sol.dtype, device=sol.device)
    u0 = sol.problem.stage_to_u(u_ws)
    x0 = torch.as_tensor(x0, dtype=sol.dtype, device=sol.device)
    up = torch.zeros(games, sc.joint_model.n_u, dtype=sol.dtype, device=sol.device)
    up = seed_virtual_rate_prev(up, u_ws[:, 0, :], sc.joint_model)
    return u0, _dual_warm_start(sol, u0, x0, up), x0, up


def phase_dynamic_parity(n_games=16):
    """``dynamic_parity``: evaluate + QP step of the two dynamic duels on the same games,
    the card in float32 against the CPU in float32 (the kernel against its plain
    version) and against the CPU in float64, each quantity within ``DERIV_RTOL``
    (``STEP_RTOL`` for the step).  The approximate duel's gradient and step are not held
    to float64: its lag cost (weight 1000) on a float32 rollout moves q by ~2.5e-3 and
    the step by ~0.3 of their largest entries on any device, the JAX package's float32
    by ~5e-3 (``APPROX_F32_FREE``); they are reported."""
    import torch
    from dgsqp_torch.harness.dynamic_study import (sample_dynamic_duel_initial_conditions,
                                                   sample_dynamic_pa_initial_conditions)
    from dgsqp_torch.harness.scenarios import (build_dynamic_approximate_duel,
                                               build_dynamic_duel)
    out, bad = {}, []
    names = 'Q q G g du'.split()
    tol = lambda k: STEP_RTOL if k == 'du' else DERIV_RTOL
    for build, make, sampler, free in ((build_dynamic_duel, dynamic_solver,
                                        sample_dynamic_duel_initial_conditions, ()),
                                       (build_dynamic_approximate_duel, dynamic_approx_solver,
                                        sample_dynamic_pa_initial_conditions,
                                        APPROX_F32_FREE)):
        sc = build(N=DYN_N)
        sol = make(sc, torch.float32, 'cuda')
        batch = study_batch(sc, sol, n_games, sampler)
        runs = {}
        for dev, dtype in (('cuda', torch.float32), ('cpu', torch.float32),
                           ('cpu', torch.float64)):
            s = sol if dev == 'cuda' else make(sc, dtype, dev)
            args = [a.detach().to(dev, dtype) for a in batch]
            o, du = _eval_and_step(s, *args)
            runs[(dev, dtype)] = [t.to('cpu', torch.float64) for t in (*o[:4], du)]
        card = runs[('cuda', torch.float32)]
        plain = {k: rel_err(a, b) for k, a, b in zip(names, card, runs[('cpu', torch.float32)])}
        f64 = {k: rel_err(a, b) for k, a, b in zip(names, card, runs[('cpu', torch.float64)])}
        cpu32 = {k: rel_err(a, b) for k, a, b in zip(names, runs[('cpu', torch.float32)],
                                                      runs[('cpu', torch.float64)])}
        emit({'phase': 'dynamic_parity', 'scenario': sc.name, 'games': n_games,
              'rel_diff_cpu_float32': plain, 'rel_diff_cpu_float64': f64,
              'cpu_float32_vs_float64': cpu32,
              'tol': {'derivatives': DERIV_RTOL, 'du': STEP_RTOL},
              'not_held_to_float64': list(free),
              'why': 'f32 on the card vs the plain version on the CPU in f32 (every '
                     'quantity) and in f64 (all but the approximate duel\'s q and du, '
                     'moved by its lag cost on a f32 rollout on any device)'})
        bad += [f'{sc.name} {k} vs cpu f32 {plain[k]:.2e} > {tol(k):.0e}' for k in names
                if not plain[k] <= tol(k)]
        bad += [f'{sc.name} {k} vs cpu f64 {f64[k]:.2e} > {tol(k):.0e}' for k in names
                if k not in free and not f64[k] <= tol(k)]
        out[sc.name] = {'cpu_float32': plain, 'cpu_float64': f64}
    if bad:
        raise AssertionError(f'dynamic_parity outside tolerance: {bad}')
    return out


def phase_dynamic_path():
    """The exact dynamic duel's study in the record's configuration, float32."""
    import numpy as np
    import torch
    from dgsqp_torch.harness.mc_study import analyze_results, run_mc_study
    from dgsqp_torch.harness.scenarios import build_dynamic_duel
    sc = build_dynamic_duel(N=DYN_N)
    sol = dynamic_solver(sc, torch.float32, 'cuda')
    reset_launches()
    reset_dyn_launches()
    t0 = time.time()
    res = run_mc_study(sc, num_samples=DYN_GAMES, seed=0, solver=sol)
    seconds = time.time() - t0
    launches, launches_by_n = read_launches(), read_launches_by_n()
    launches['dyn_step'] = dyn_launches()
    stats = analyze_results(res)
    conv_any = stats['success_rate']
    emit({'phase': 'dynamic_path', 'scenario': sc.name, 'games': DYN_GAMES,
          'n_dec': sol.n_dec, 'n_c': sol.n_c, 'dtype': 'float32', 'seconds': seconds,
          'solve_s': res.wall_time_s, 'warmup_s': res.compile_time_s,
          'status_counts': stats['status_counts'], 'conv_any': conv_any,
          'mean_iters': stats['mean_iters'], 'max_iters': stats['max_iters'],
          'iters_mean_all': float(np.mean(res.iters)),
          'feas_violation_max': stats['feas_violation_max'],
          'solves_per_s': stats['solves_per_s'],
          'status_string': ''.join(str(int(s)) for s in res.statuses),
          'record': DYN_RECORD, 'limit_conv_any': DYN_CONV_ANY_MIN,
          'launches': launches, 'launches_by_n': launches_by_n})
    problems = []
    if sol.n_dec != 2 * 2 * DYN_N:
        problems.append(f'the study ran at n = {sol.n_dec}')
    if not all(np.isfinite(a).all() for a in (res.u_sol, res.stat, res.p_feas, res.comp)):
        problems.append('non-finite results')
    if (res.statuses == 0).any():
        problems.append('games still running')
    if conv_any < DYN_CONV_ANY_MIN:
        problems.append(f'conv_abs + conv_rel {conv_any:.3f} < {DYN_CONV_ANY_MIN}')
    missing = [(name, n) for name in launches_by_n for n in DYN_KERNEL_NS
               if not launches_by_n[name].get(n)]
    if missing:
        problems.append(f'kernels not launched at these sizes: {missing}')
    if not launches['dyn_step']:
        problems.append('dyn_step was not launched')
    if problems:
        raise AssertionError('dynamic_path: ' + '; '.join(problems))
    return launches


def phase_f1_path():
    """The F1 study in the r5 command's configuration, float32: the first F1 row."""
    import numpy as np
    import torch
    from dgsqp_torch.harness.f1_study import f1_solver_params, run_f1_study
    params = f1_solver_params(F1_N, sqp_iters=150, approximation_eval='exact', qp_tol=3e-7)
    reset_launches()
    reset_dyn_launches()
    t0 = time.time()
    out = run_f1_study(N=F1_N, num_samples=F1_GAMES, seed=0, params=params,
                       dtype=torch.float32, device='cuda')
    seconds = time.time() - t0
    launches, launches_by_n = read_launches(), read_launches_by_n()
    launches['dyn_step'] = dyn_launches()
    n_dec = int(out['u_sol'].shape[1])
    emit({'phase': 'f1_path', 'scenario': 'f1_austin', 'games': F1_GAMES, 'n_dec': n_dec,
          'dtype': 'float32', 'seconds': seconds, 'solve_s': out['wall_time_s'],
          'status_counts': out['status_counts'], 'converged': out['converged'],
          'success_rate': out['success_rate'], 'mean_iters': out['mean_iters'],
          'max_iters': out['max_iters'],
          'status_string': ''.join(str(int(s)) for s in out['statuses']),
          'launches': launches, 'launches_by_n': launches_by_n})
    problems = []
    if n_dec != 2 * 3 * F1_N:
        problems.append(f'the study ran at n = {n_dec}')
    if not np.isfinite(out['u_sol']).all():
        problems.append('non-finite u_sol')
    if out['converged'] < 1:
        problems.append('no game converged')
    missing = [(name, n) for name in launches_by_n for n in F1_KERNEL_NS
               if not launches_by_n[name].get(n)]
    if missing:
        problems.append(f'kernels not launched at these sizes: {missing}')
    if not launches['dyn_step']:
        problems.append('dyn_step was not launched')
    if problems:
        raise AssertionError('f1_path: ' + '; '.join(problems))
    return launches


def race_record():
    """The JAX package's record of the race (``tests/test_torch_race.py`` writes it)."""
    return json.loads(RACE_RECORD.read_text())


def race_state_vector(st, fields):
    out = []
    for name in fields:
        obj = st
        for part in name.split('.'):
            obj = getattr(obj, part)
        out.append(float(obj))
    return out


def held_game_log(log):
    """The events race_path holds: every game's step, look-ahead index and message, and
    the iteration count of a game that converged.  A game that diverges does so through
    QPs whose duals reach ~1e13, where a 1e-13 change of the iterate moves the next step
    by ~1e-2 (the same inputs give the same step to 1e-12): its iteration count is set by
    rounding, not by the implementation (ROADMAP.md section 3)."""
    return [dict(step=g['step'], idx=g['idx'], msg=g['msg'],
                 num_iters=g['num_iters'] if g['msg'] in RACE_CONVERGED else None)
            for g in log]


def phase_race_path():
    """The closed-loop race at full width on the card in float64, held to the JAX
    package's record over its first control steps, with its timings, launch counts and
    the device's idle share."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dgsqp_torch.harness.race import RaceConfig, RaceStack
    from dgsqp_torch.ops.dynamics import dyn_step
    rec = race_record()
    fields = rec['state_fields']
    cfg = RaceConfig()
    if cfg.n_steps != RACE_STEPS or rec['n_steps'] < RACE_STEPS or cfg.game_N != RACE_GAME_N:
        raise AssertionError('race_path: the record or RaceConfig() is not the race held')
    t0 = time.time()
    stack = RaceStack(cfg, device='cuda', dtype=torch.float64)
    setup_s = time.time() - t0
    flags = []
    for mpc in stack.trackers:
        def recorded(state, parameters=None, _step=mpc.step):
            out = _step(state, parameters)
            flags.append(bool(out['success']))
            return out
        mpc.step = recorded
    states = stack.initial_states()
    out_states, games, step_s = [], [], []
    prof_wall, busy_us, n_events = 0.0, 0.0, 0
    reset_launches()
    reset_dyn_launches()
    t_run = time.time()
    for k in range(RACE_STEPS):
        n_games = len(stack.game_log)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if RACE_PROFILED[0] <= k < RACE_PROFILED[1]:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                stack.run(initial_states=states, n_steps=1)
                torch.cuda.synchronize()
            prof_wall += time.perf_counter() - t0
            events = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            busy_us += sum(e.time_range.elapsed_us() for e in events)
            n_events += len(events)
        else:
            stack.run(initial_states=states, n_steps=1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        out_states.append([race_state_vector(st, fields) for st in states])
        for g in stack.game_log[n_games:]:
            games.append(dict(step=k, idx=int(g['idx']), msg=g['info']['msg'],
                              num_iters=int(g['info']['num_iters'])))
    run_s = time.time() - t_run
    launches = dict(read_launches(), dyn_step=dyn_step.launches)
    by_n = read_launches_by_n()
    by_shape = dict(dyn_step.launches_by_shape)

    ref_states = np.asarray(rec['states'][:RACE_STEPS])
    diff = np.abs(np.asarray(out_states) - ref_states).max(axis=(1, 2))
    held = RACE_HELD_STEPS
    ours, theirs = held_game_log(games), held_game_log(rec['game_log'])
    ours_held = [g for g in ours if g['step'] < held]
    theirs_held = [g for g in theirs if g['step'] < held]
    first_event_diff = next((min(a['step'], b['step']) for a, b in zip(ours, theirs)
                             if a != b), None)
    if first_event_diff is None and len(ours) != len(theirs):
        first_event_diff = (ours + theirs)[min(len(ours), len(theirs))]['step']
    flags_by_step = [flags[2 * k:2 * k + 2] for k in range(RACE_STEPS)]
    failed = sum(not f for fl in flags_by_step for f in fl)
    failed_rec = sum(not f for fl in rec['tracker_success'][:RACE_STEPS] for f in fl)
    s0 = [st[fields.index('p.s')] for st in out_states[0]]
    s1 = [st[fields.index('p.s')] for st in out_states[-1]]
    ey_max = float(np.abs(np.asarray(out_states)[:, :, fields.index('p.x_tran')]).max())
    timed = [k for k in range(RACE_STEPS) if not RACE_PROFILED[0] <= k < RACE_PROFILED[1]]
    game_steps = sorted({g['step'] for g in games})
    ms = lambda v: float(np.median(v)) * 1e3
    line = {
        'phase': 'race_path', 'track': cfg.track_name, 'mpc_N': cfg.mpc_N,
        'game_N': cfg.game_N, 'control_dt': cfg.control_dt, 'sim_dt': cfg.sim_dt,
        'steps': RACE_STEPS, 'dtype': 'float64', 'setup_s': setup_s, 'run_s': run_s,
        'steps_per_s': len(timed) / sum(step_s[k] for k in timed),
        'ms_per_step_median': ms([step_s[k] for k in timed]),
        'ms_trackers_median': ms([stack.timing['trackers'][k] for k in timed]),
        'ms_plant_median': ms([stack.timing['plant'][k] for k in timed]),
        'ms_planner_per_game_solve': [stack.timing['planner'][k] * 1e3 for k in game_steps],
        'ms_step_all': [t * 1e3 for t in step_s],
        'launches': launches, 'launches_by_n': by_n, 'dyn_step_launches_by_shape': by_shape,
        'launches_per_step': {k: v / RACE_STEPS for k, v in launches.items()},
        'profiled_steps': list(RACE_PROFILED), 'profiled_wall_s': prof_wall,
        'device_busy_s': busy_us * 1e-6, 'device_idle_share': 1.0 - busy_us * 1e-6 / prof_wall,
        'cuda_kernel_launches_profiled': n_events,
        'held_steps': held, 'atol': RACE_ATOL,
        'max_state_diff_held': float(diff[:held].max()),
        'max_state_diff_all': float(diff.max()), 'state_diff_by_step': diff.tolist(),
        'game_log': games, 'record_game_log': rec['game_log'],
        'first_event_diff_step': first_event_diff,
        'tracker_failed_qps': failed, 'record_tracker_failed_qps': failed_rec,
        'final_s': s1, 'max_abs_x_tran': ey_max,
        'half_width_plus_slack': stack.track.half_width + 0.3,
    }
    emit(line)
    problems = []
    if not np.isfinite(np.asarray(out_states)).all():
        problems.append('non-finite states')
    if not diff[:held].max() <= RACE_ATOL:
        problems.append(f'states differ from the record by {diff[:held].max():.3e} over '
                        f'the first {held} steps')
    if ours_held != theirs_held:
        problems.append(f'game log over the first {held} steps {ours_held} != record '
                        f'{theirs_held}')
    if not all(b > a for a, b in zip(s0, s1)):
        problems.append(f'a car did not advance: s {s0} -> {s1}')
    if ey_max > stack.track.half_width + 0.3:
        problems.append(f'a car left the track: |x_tran| {ey_max:.3f}')
    if not any(g['msg'] in RACE_CONVERGED for g in games):
        problems.append('no intervention converged')
    if failed > failed_rec:
        problems.append(f'{failed} tracker QPs failed, the record {failed_rec}')
    missing = [(name, n) for name in by_n for n in RACE_KERNEL_NS if not by_n[name].get(n)]
    if missing:
        problems.append(f'kernels not launched at these sizes: {missing}')
    for key in ('order0_P1', f'order1_P{cfg.mpc_N}'):
        if not by_shape.get(key):
            problems.append(f'dyn_step not launched at {key}')
    if problems:
        raise AssertionError('race_path: ' + '; '.join(problems))
    return launches


def bench_v1(sc, dtype, device, **overrides):
    """DGSQP v1 with the bench's parameters (``build_bench_solver``), ``overrides``
    replacing some: ``nonmono_ls=False`` is the ``DGSQP_BENCH_NMLS=0`` configuration."""
    import dataclasses
    from dgsqp_torch.harness.bench_setup import build_bench_solver
    from dgsqp_torch.solvers.dgsqp import DGSQP
    _, base = build_bench_solver(horizon=sc.N, scenario=sc, dtype=dtype, device=device)
    return DGSQP(sc.joint_model, sc.costs, sc.agent_constraints, sc.shared_constraints,
                 sc.bounds, dataclasses.replace(base.params, **overrides),
                 print_method=None, dtype=dtype, device=device)


def param_game_solver(device):
    """DGSQP v1 (default parameters: the nested machine) on a two-agent integrator game
    whose terminal costs take a game parameter P (``P * x_a``), float64."""
    import torch
    from dgsqp_torch.dynamics import DynamicsConfig, IntegratorModel, MultiAgentDynamicsModel
    from dgsqp_torch.solvers.dgsqp import DGSQP
    from dgsqp_torch.solvers.solver_types import DGSQPParams
    from dgsqp_torch.types import VehicleState
    N, dt = 5, 0.1
    joint = MultiAgentDynamicsModel(0.0, [IntegratorModel(0.0, DynamicsConfig(dt=dt)),
                                          IntegratorModel(0.0, DynamicsConfig(dt=dt))])

    def term(a):
        return lambda x, P: (0.5 * (x[..., a] - 1.0) ** 2 + 0.3 * x[..., 0] * x[..., 1]
                             + torch.tanh(2.0 * (x[..., a] - x[..., 1 - a])) + P * x[..., a])
    stage = lambda x, u, um: 0.5 * u[..., 0] ** 2
    ub, lb = VehicleState(), VehicleState()
    ub.v.v_long, ub.u.u_a = float('inf'), 5.0
    lb.v.v_long, lb.u.u_a = -float('inf'), -5.0
    return DGSQP(joint, [(stage, term(0)), (stage, term(1))], [None, None], None,
                 {'ub': [ub, ub.copy()], 'lb': [lb, lb.copy()]},
                 DGSQPParams(N=N, dt=dt, reg=1e-3, p_tol=1e-8, d_tol=1e-8),
                 print_method=None, dtype=torch.float64, device=device)


def phase_nested_parity(sc, batch):
    """``nested_parity``: one iteration of the nested machine (monotone Armijo, the
    watchdog, damped BFGS) on the first bench games, the card in float32 against the
    CPU in float64 (the iterate within ``STEP_RTOL``; the step, the duals and the
    counts are reported); and the host ``solve`` with game parameters on the card
    against the CPU (float64: the same message, iterations and QP solves, the solution
    within ``PARAM_SOLVE_ATOL``)."""
    import numpy as np
    import torch
    from dgsqp_torch.types import VehicleState
    args = [a[:NESTED_PARITY_GAMES] for a in batch]
    rows, bad = {}, []
    for name, over in NESTED_PARITY_CONFIGS.items():
        runs = {}
        for dev, dtype in (('cuda', torch.float32), ('cpu', torch.float64)):
            sol = bench_v1(sc, dtype, dev, **over)
            if sol._use_flat():
                raise AssertionError(f'nested_parity {name}: the flat machine was chosen')
            u0, l0, x0, up = (a.detach().to(dev, dtype) for a in args)
            t0 = time.time()
            c0 = sol._init_carry(u0, l0, x0, up)
            c1 = sol._make_body(x0, up)(c0)
            if dev == 'cuda':
                torch.cuda.synchronize()
            runs[dev] = (c0, c1, time.time() - t0)
        (d0, d1, d_s), (h0, h1, h_s) = runs['cuda'], runs['cpu']
        f64 = lambda t: t.to('cpu', torch.float64)
        diffs = {'u': rel_err(f64(d1.u), h1.u), 'du': rel_err(f64(d1.u - d0.u), h1.u - h0.u),
                 'l': rel_err(f64(d1.l), h1.l)}
        same = {f: int((getattr(d1, f).cpu() == getattr(h1, f)).sum())
                for f in ('status', 'it', 'qp_solves')}
        rows[name] = {'rel_diff': diffs, 'games_same': same, 'card_s': d_s, 'cpu_s': h_s,
                      'qp_solves_card': d1.qp_solves.tolist(),
                      'qp_solves_cpu': h1.qp_solves.tolist()}
        if not diffs['u'] <= STEP_RTOL or not torch.isfinite(d1.u).all():
            bad.append(f'{name}: iterate {diffs["u"]:.2e} > {STEP_RTOL:.0e}')
    rng = np.random.default_rng(5)
    u_ws = rng.normal(0.0, 1.0, (5, 2))
    infos = {}
    for dev in ('cuda', 'cpu'):
        sol = param_game_solver(dev)
        sol.set_warm_start(u_ws)
        infos[dev] = sol.solve([VehicleState(), VehicleState()], 0.3)
    ic, ih = infos['cuda'], infos['cpu']
    solve = {k: (ic[k], ih[k]) for k in ('msg', 'num_iters', 'qp_solves')}
    solve['u_abs_diff'] = float(np.abs(ic['u_sol'] - ih['u_sol']).max())
    solve['cost_abs_diff'] = float(np.abs(ic['cost'] - ih['cost']).max())
    emit({'phase': 'nested_parity', 'scenario': sc.name, 'games': NESTED_PARITY_GAMES,
          'configs': rows, 'param_solve': solve,
          'tol': {'iterate': STEP_RTOL, 'param_solve_u': PARAM_SOLVE_ATOL},
          'why': 'f32 on the card vs f64 on the CPU: one iteration\'s QP step is solved '
                 'to 3e-7 after Ruiz scaling; the parameterised solve is f64 on both'})
    if any(a != b for a, b in (solve[k] for k in ('msg', 'num_iters', 'qp_solves'))) \
            or not solve['u_abs_diff'] <= PARAM_SOLVE_ATOL \
            or ic['msg'] not in ('conv_abs_tol', 'conv_rel_tol'):
        bad.append(f'parameterised solve: {solve}')
    if bad:
        raise AssertionError(f'nested_parity: {bad}')
    return rows


def phase_nested_path():
    """``nested_path``: the bench batch on DGSQP v1's nested machine (the
    ``DGSQP_BENCH_NMLS=0`` configuration), float32, at full width, against the JAX
    package's float32 record of the same games."""
    import numpy as np
    import torch
    from dgsqp_torch.harness.bench_setup import build_bench_batch
    from dgsqp_torch.harness.scenarios import build_chicane_scenario
    from dgsqp_torch.solvers.dgsqp import STATUS_MSG
    rec = json.loads(NESTED_RECORD.read_text())
    if (rec['games'], rec['seed'], rec['chunk_iters'], rec['env'], rec['dtype'],
            rec['execution']) != (256, 0, NESTED_CHUNK, NESTED_ENV, 'float32', 'nested'):
        raise AssertionError('nested_path: the record is not of this configuration')
    sc = build_chicane_scenario(N=25, theta_deg=45.0)
    sol = bench_v1(sc, torch.float32, 'cuda', nonmono_ls=False)
    batch = build_bench_batch(sc, sol, rec['games'], seed=rec['seed'])

    def vs_record(res):
        host = lambda t: t.cpu().numpy()
        st, it, qp = host(res.status), host(res.iters), host(res.qp_solves)
        rs, ri, rq = (np.asarray(rec[k]) for k in ('status', 'iters', 'qp_solves'))
        flips = {}
        for a, b in zip(rs[st != rs], st[st != rs]):
            key = f'{STATUS_MSG[int(a)]}->{STATUS_MSG[int(b)]}'
            flips[key] = flips.get(key, 0) + 1
        return {'execution': 'nested', 'record': {k: rec[k] for k in (
                    'status_counts', 'command', 'package', 'device', 'dtype', 'seconds')},
                'record_iters_p50': float(np.median(ri)), 'record_iters_max': int(ri.max()),
                'record_qp_solves_p50': float(np.median(rq)),
                'qp_solves_p50': float(np.median(qp)), 'qp_solves_max': int(qp.max()),
                'games_status_as_record': int((st == rs).sum()),
                'games_iters_as_record': int((it == ri).sum()),
                'games_qp_solves_as_record': int((qp == rq).sum()),
                'status_flips_from_record': flips,
                'limits': {'conv_abs': NESTED_CONV_ABS_MIN, 'conv_any': NESTED_CONV_ANY_MIN}}
    line = phase_bench_path('nested_path', 'v1_nested', sol, batch, NESTED_CONV_ABS_MIN,
                            NESTED_CONV_ANY_MIN, chunk=NESTED_CHUNK, n_dec=100,
                            kernel_ns=NESTED_KERNEL_NS, extra=vs_record)
    return line['launches']


def phase_diagnose_path(main_status: str):
    """``diagnose_path``: ``scripts/torch_diagnose_failures.py``'s flow at its defaults
    on the main path's result (``main_status``, one status digit a game): its
    non-conv_abs games, padded to a power of two, traced through v1's nested body (the
    bench's parameters: the watchdog) for ``DIAG_TRACE_ITERS`` iterations and
    classified."""
    import numpy as np
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parent / 'scripts'))
    from torch_diagnose_failures import LABELS, classify_failures, trace_failures
    from dgsqp_torch.harness.bench_setup import build_bench_batch, build_bench_solver
    from dgsqp_torch.solvers.dgsqp import CONV_ABS, RUNNING, STATUS_MSG
    sc, sol = build_bench_solver(horizon=25, dtype=torch.float32, device='cuda')
    status = np.array([int(ch) for ch in main_status])
    batch = build_bench_batch(sc, sol, status.size, seed=0)
    fail = np.where(status != CONV_ABS)[0]
    reset_launches()
    t0 = time.time()
    pad, res, trace = trace_failures(sol, batch, fail, DIAG_TRACE_ITERS)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches, launches_by_n = read_launches(), read_launches_by_n()
    p = sol.params
    report = classify_failures(fail, trace, status, p.p_tol, p.d_tol, STATUS_MSG)
    # a game whose status is final repeats its row to the end of the trace
    not_repeated = []
    for i in range(fail.size):
        ended = np.flatnonzero(trace['status'][i] != RUNNING)
        if ended.size:
            t_end = ended[0]
            for k in ('status', 'it', 'p_feas', 'comp', 'stat', 'qp_solves'):
                if not (trace[k][i, t_end:] == trace[k][i, t_end]).all():
                    not_repeated.append((int(fail[i]), k))
            if (trace['du_norm'][i, t_end + 1:] != 0).any():
                not_repeated.append((int(fail[i]), 'du_norm'))
    end_status = trace['status'][:, -1]
    emit({'phase': 'diagnose_path', 'batch': int(status.size), 'traced': int(fail.size),
          'padded_to': int(pad.size), 'trace_iters': DIAG_TRACE_ITERS, 'dtype': 'float32',
          'seconds': seconds,
          'main_path_status_counts': {STATUS_MSG[int(s)]: int((status == s).sum())
                                      for s in np.unique(status)},
          'failure_classes': report['failure_classes'],
          'stat_final_percentiles': report['stat_final_percentiles'],
          'trace_end_status_counts': {STATUS_MSG[int(s)]: int((end_status == s).sum())
                                      for s in np.unique(end_status)},
          'record': DIAG_RECORD, 'record_note': 'docs/diagnosis_r2.json, the TPU at r2\'s '
                                                'parameters: reported, not held',
          'launches': launches, 'launches_by_n': launches_by_n,
          'labels': ''.join(report['failures'][int(g)]['label'][0] for g in fail),
          # the traced body makes the main path's decisions, so a traced game that ends
          # within the trace mostly ends with its main-path status (float32 flips aside)
          'games_trace_end_as_main_path': int((end_status == status[fail]).sum()),
          'rows_not_repeated': not_repeated[:20]})
    problems = []
    if pad.size & (pad.size - 1):
        problems.append(f'the traced batch of {pad.size} is not a power of two')
    if any(v['label'] not in LABELS for v in report['failures'].values()):
        problems.append('a failure has no label')
    if not_repeated:
        problems.append(f'final rows not repeated: {not_repeated[:5]}')
    if not all(v > 0 for v in launches.values()):
        problems.append(f'a kernel was not launched on diagnose_path: {launches}')
    if not all(np.isfinite(trace[k]).all() for k in ('p_feas', 'comp', 'stat')):
        problems.append('non-finite trace')
    if problems:
        raise AssertionError('diagnose_path: ' + '; '.join(problems))
    return launches


def main_path_statuses() -> str:
    """The main path's per-game statuses, for a child run alone: the bench batch solved
    as ``main_path`` solves it."""
    import torch
    from dgsqp_torch.harness.bench_setup import build_bench_batch, build_bench_solver
    sc, sol = build_bench_solver(horizon=25, dtype=torch.float32, device='cuda')
    res = sol.solve_batch_chunked(*build_bench_batch(sc, sol, 256, seed=0),
                                  chunk_iters=4, compact=False)
    return ''.join(str(int(s)) for s in res.status.cpu())


def nested_paths(main_status=None):
    """The child of ``--nested-paths``: ``nested_path``, then ``diagnose_path`` on the
    main path's statuses (run alone, it solves the main path's batch itself first)."""
    if main_status is None:
        main_status = main_path_statuses()
    phase_nested_path()
    phase_diagnose_path(main_status)


def sharded_ranks():
    """(ranks, devices): a rank a card, at least two; two ranks share the one card."""
    import torch
    k = max(2, torch.cuda.device_count())
    return k, (None if torch.cuda.device_count() >= k else ['cuda:0'] * k)


def sharded_rank(mesh, chunk):
    """One rank of ``sharded_path``: the bench batch and solver on this rank's device, a
    warm-up chunk on a few of its games, then its block solved with compaction across
    the ranks.  Returns host values."""
    import torch
    from dgsqp_torch.harness.bench_setup import build_bench_batch, build_bench_solver
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sc, sol = build_bench_solver(horizon=25, dtype=torch.float32, device=str(mesh.device))
    lo, hi = mesh.block(256)
    block = [a[lo:hi] for a in build_bench_batch(sc, sol, 256, seed=0)]
    t0 = time.time()
    sol.solve_batch_chunked(*(a[:WARMUP_GAMES] for a in block), chunk_iters=chunk,
                            max_chunks=1)
    torch.cuda.synchronize()
    warmup_s = time.time() - t0
    reset_launches()
    t0 = time.time()
    res = sol.solve_batch_chunked(*block, chunk_iters=chunk, mesh=mesh)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    finite = all(bool(torch.isfinite(t).all())
                 for t in (res.u, res.l, res.stat, res.p_feas, res.comp))
    return dict(rank=mesh.rank, device=str(mesh.device), devices=list(mesh.devices),
                backend=mesh.backend, world_size=mesh.size, n_dec=sol.n_dec,
                p_tol=sol.params.p_tol, d_tol=sol.params.d_tol, seconds=seconds,
                warmup_s=warmup_s, launches=read_launches(),
                launches_by_n=read_launches_by_n(), finite=finite,
                status=''.join(str(int(s)) for s in res.status.cpu()),
                history=sol.last_chunk_history)


def sharded_study(k, devices):
    """``scripts/torch_monte_carlo_main.py`` at ``SHARDED_STUDY_ARGS``, on one device
    (in this process) and then over k ranks: for each run its status string, the names
    of its outputs, its seconds and its provenance."""
    import importlib.util
    import pickle
    here = Path(__file__).resolve().parent
    path = here / 'scripts' / 'torch_monte_carlo_main.py'
    spec = importlib.util.spec_from_file_location('torch_monte_carlo_main', path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    runs = {}
    for name, extra in (('one_device', []),
                        ('ranks', ['--devices', str(k), '--device',
                                   'cuda' if devices is None else ','.join(devices),
                                   '--rank_timeout', str(SHARDED_TIMEOUT_S)])):
        target = here / 'build' / f'sharded_study_{name}'
        if target.exists():
            for f in target.iterdir():
                f.unlink()
        argv = SHARDED_STUDY_ARGS + ['--out', str(target)] + extra
        t0 = time.time()
        if name == 'one_device':
            script.run_study(argv)
        else:
            proc = subprocess.run([sys.executable, str(path), *argv], cwd=here,
                                  capture_output=True, text=True,
                                  timeout=SHARDED_TIMEOUT_S)
            if proc.returncode != 0:
                raise AssertionError(f'sharded_path: the study script failed:\n'
                                     f'{proc.stderr[-3000:]}')
        seconds = time.time() - t0
        names = sorted(f.name for f in target.iterdir())
        pkl = [n for n in names if n.endswith('.pkl')]
        if len(pkl) != 1:
            raise AssertionError(f'sharded_path: the study ({name}) wrote {names}')
        with open(target / pkl[0], 'rb') as f:
            res = pickle.load(f)
        runs[name] = dict(status_string=''.join(str(int(s)) for s in res.statuses),
                          outputs=names, seconds=seconds,
                          world_size=res.provenance.get('world_size'),
                          backend=res.provenance.get('backend'),
                          rank_devices=res.provenance.get('rank_devices'))
    return runs


def phase_sharded_path(main_status: str, concurrent: bool):
    """``sharded_path``: the main path's batch solved over ranks with compaction across
    them, held against ``main_path``'s statuses; then the study script on ranks."""
    import numpy as np
    from dgsqp_torch.parallel.mesh import spawn_ranks
    from dgsqp_torch.solvers.dgsqp import CONV_ABS, CONV_REL, RUNNING, STATUS_MSG
    k, devices = sharded_ranks()
    t0 = time.time()
    ranks = spawn_ranks(sharded_rank, k, SHARDED_CHUNK, devices=devices,
                        timeout_s=SHARDED_TIMEOUT_S)
    wall = time.time() - t0
    status = np.array([int(c) for c in ranks[0]['status']])
    main = np.array([int(c) for c in main_status])
    conv = float(np.isin(status, (CONV_ABS,)).mean())
    conv_any = float(np.isin(status, (CONV_ABS, CONV_REL)).mean())
    agree = int((status == main).sum())
    history = ranks[0]['history']
    buckets = [h['batch'] for h in history]
    solve_s = max(r['seconds'] for r in ranks)
    study = sharded_study(k, devices)
    launches = {name: sum(r['launches'][name] for r in ranks)
                for name in ranks[0]['launches']}
    line = {
        'phase': 'sharded_path', 'metric': 'chicane_2agent_solves_per_s',
        'value': len(status) / solve_s, 'unit': 'solves/s', 'solve_s': solve_s,
        'spawn_to_join_s': wall, 'warmup_s': max(r['warmup_s'] for r in ranks),
        'world_size': k, 'backend': ranks[0]['backend'],
        'rank_devices': ranks[0]['devices'], 'concurrent': concurrent,
        'cpu_count': os.cpu_count(), 'chunk_iters': SHARDED_CHUNK,
        'convergence_rate': conv, 'convergence_rate_incl_rel': conv_any,
        'limits': {'conv_abs': CONV_ABS_MIN, 'conv_any': CONV_ANY_MIN,
                   'agree_with_main_path': SHARDED_MIN_AGREE},
        'status_counts': {STATUS_MSG.get(int(s), str(s)): int((status == s).sum())
                          for s in np.unique(status)},
        'agree_with_main_path': agree, 'chunks': len(history), 'chunk_batch': buckets,
        'running_after_chunk': [h['running'] for h in history],
        'chunk_wall_s': [h['wall_s'] for h in history],
        'compact_bytes_by_rank': [[h.get('compact_bytes', 0) for h in r['history']]
                                  for r in ranks],
        'compact_s_rank0': [h['compact_s'] for h in history if 'compact_s' in h],
        'rank_solve_s': [r['seconds'] for r in ranks],
        'launches': launches, 'launches_by_rank': [r['launches'] for r in ranks],
        'launches_by_n_by_rank': [r['launches_by_n'] for r in ranks],
        'status_string': ranks[0]['status'],
        'study': study,
    }
    emit(line)
    problems = []
    if any(r['status'] != ranks[0]['status'] or [h['batch'] for h in r['history']] != buckets
           for r in ranks):
        problems.append('the ranks returned different results')
    if (status == RUNNING).any():
        problems.append('games still running')
    if not all(r['finite'] for r in ranks):
        problems.append('non-finite results')
    for r in ranks:
        by_n = r['launches_by_n']
        missing = [(name, n) for name in by_n for n in NESTED_KERNEL_NS
                   if not by_n[name].get(n)]
        if missing or not all(v > 0 for v in r['launches'].values()):
            problems.append(f"rank {r['rank']} did not launch {missing or r['launches']}")
    if any(b % k for b in buckets):
        problems.append(f'a bucket is not a multiple of {k}: {buckets}')
    if conv < CONV_ABS_MIN or conv_any < CONV_ANY_MIN:
        problems.append(f'convergence {conv:.3f}/{conv_any:.3f} below '
                        f'{CONV_ABS_MIN}/{CONV_ANY_MIN}')
    if agree < SHARDED_MIN_AGREE:
        problems.append(f'{agree} games as main_path, fewer than {SHARDED_MIN_AGREE}')
    one, on_ranks = study['one_device'], study['ranks']
    if on_ranks['outputs'] != one['outputs']:
        problems.append(f"the study on {k} ranks wrote {on_ranks['outputs']}, on one "
                        f"device {one['outputs']}")
    if on_ranks['status_string'] != one['status_string']:
        problems.append(f"the study on {k} ranks ({on_ranks['status_string']}) differs "
                        f"from one device ({one['status_string']})")
    if on_ranks['world_size'] != k:
        problems.append('the study on ranks does not name its ranks')
    if problems:
        raise AssertionError('sharded_path: ' + '; '.join(problems))
    return line


def sharded_path(main_status=None):
    """The child of ``--sharded-path``: ``sharded_path`` on the main path's statuses
    (run alone, it solves the main path's batch itself first)."""
    if main_status is None:
        main_status = main_path_statuses()
    phase_sharded_path(main_status, concurrent=os.cpu_count() >= SHARDED_MIN_CORES)


def kernel_summary(rows, launches_by_path):
    """The per-kernel line: numbers at the main shape (float32), all shapes beside."""
    meta = {
        'chol': dict(source='dgsqp_torch/ops/csrc/chol.cu',
                     replaces='dgsqp_tpu/ops/linalg_pallas.py:123 (chol_batch)',
                     main=(256, 100, 0), path='v2_path'),
        'cho_solve': dict(source='dgsqp_torch/ops/csrc/cho_solve.cu',
                          replaces='dgsqp_tpu/ops/linalg_pallas.py:243 (cho_solve_batch)',
                          main=(256, 100, 1), path='v2_path'),
        # no Pallas kernel: XLA compiles the JAX package's step and its derivatives
        'dyn_step': dict(source='dgsqp_torch/ops/csrc/dyn_step.cu',
                         replaces='dgsqp_tpu/dynamics/models.py:74 (DynamicsModel.fd with '
                                  'its jacfwd derivatives, compiled by XLA; no Pallas kernel)',
                         main=(2 * DYN_GAMES, 8, 2), path='dynamic_path'),
    }
    out = []
    for name, m in meta.items():
        main = next(r for r in rows if r['kernel'] == name and r['dtype'] == 'float32'
                    and (r['B'], r['n'], r['k']) == m['main'])
        out.append({'name': name, 'route': 'cuda', 'source': m['source'],
                    'replaces': m['replaces'],
                    'launches': launches_by_path[m['path']][name],
                    'launches_by_path': {k: v[name] for k, v in launches_by_path.items()
                                         if name in v},
                    'max_abs_err': main['max_abs_err'], 'ms': main['ms'],
                    'plain_ms': main['plain_ms'], 'bound_ms': main['bound_ms'],
                    'bound_by': main['bound_by'], 'library_ms': main['library_ms'],
                    'main_shape': list(m['main']),
                    'shapes': [r for r in rows if r['kernel'] == name]})
    return {'kernels': out}


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this script needs the card',
              file=sys.stderr)
        sys.exit(2)
    from dgsqp_torch.harness.bench_setup import build_bench_batch, build_bench_solver
    from dgsqp_torch.harness.scenarios import build_chicane_scenario

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    LOG.parent.mkdir(parents=True, exist_ok=True)
    LOG.write_text('')
    t_start = time.time()
    phase_build()
    rows = phase_kernels()

    sc = build_chicane_scenario(N=25, theta_deg=45.0)
    _, sol = build_bench_solver(horizon=25, scenario=sc, dtype=torch.float32, device='cuda')
    _, sol_cpu = build_bench_solver(horizon=25, scenario=sc, dtype=torch.float64,
                                    device='cpu')
    batch = build_bench_batch(sc, sol, 256, seed=0)
    phase_parity(sc, sol, sol_cpu, batch)
    launches = {}
    main_line = phase_bench_path('main_path', 'v1', sol, batch, CONV_ABS_MIN, CONV_ANY_MIN,
                                 compact=False, hold=hold_bench_record)
    launches['main_path'] = main_line['launches']
    cli = start_bench_cli()
    # the nested machine's paths run beside the rest, on the main path's statuses; the
    # sharded path too where the cores allow it (else after the other children)
    children = [start_child(NESTED_CHILD, main_line['status_string'])]
    sharded_now = os.cpu_count() >= SHARDED_MIN_CORES
    sharded_child = start_child(SHARDED_CHILD, main_line['status_string']) \
        if sharded_now else None
    try:
        _, sol_v2 = build_bench_solver(horizon=25, solver_name='v2', scenario=sc,
                                       dtype=torch.float32, device='cuda')
        launches['v2_path'] = phase_bench_path('v2_path', 'v2', sol_v2, batch,
                                               V2_CONV_ABS_MIN, V2_CONV_ANY_MIN)['launches']
        launches['mc_study'] = phase_mc_study()

        sc_ap, sol_ap = build_bench_solver(horizon=25, solver_name='approx',
                                           dtype=torch.float32, device='cuda')
        _, sol_ap_cpu = build_bench_solver(horizon=25, solver_name='approx', scenario=sc_ap,
                                           dtype=torch.float64, device='cpu')
        batch_ap = build_bench_batch(sc_ap, sol_ap, 256, seed=0)
        phase_parity(sc_ap, sol_ap, sol_ap_cpu, batch_ap, phase='approx_parity')
        launches['approx_path'] = phase_bench_path(
            'approx_path', 'approx', sol_ap, batch_ap, 0.0, APPROX_CONV_ANY_MIN,
            metric='approx_duel_solves_per_s', n_dec=APPROX_N_DEC,
            conv_abs_limit=APPROX_CONV_ABS_LIMIT, kernel_ns=APPROX_KERNEL_NS)['launches']

        phase_bench_cli(cli, main_line['status_string'])
        children += [start_child(MERGE_CHILD), start_child(DYNAMIC_CHILD),
                     start_child(RACE_CHILD), start_child(ORACLE_CHILD)]
        launches['ibr_ws'] = phase_ibr_ws(sc, batch)
        phase_nested_parity(sc, batch)
        launches.update(finish_child(children[4], ['oracle_path', 'algames_path'],
                                     uncounted=['algames_path']))
        launches.update(finish_child(children[1], ['merge_path']))
        launches.update(finish_child(children[2], ['dynamic_path', 'f1_path']))
        launches.update(finish_child(children[3], ['race_path']))
        launches.update(finish_child(children[0], ['nested_path', 'diagnose_path']))
        if sharded_child is None:
            sharded_child = start_child(SHARDED_CHILD, main_line['status_string'])
        launches.update(finish_child(sharded_child, ['sharded_path']))
    finally:
        for child in children + [sharded_child, cli[0]]:
            if child is not None and child.poll() is None:
                child.kill()
                child.wait()
    phase_dp_parity({'bench': (sol.problem, tuple(a[:DP_GAMES] for a in batch)),
                     'merge': merge_dp_batch(MERGE_GAMES)})
    phase_dynamic_parity()

    emit(kernel_summary(rows, launches))
    emit({'phase': 'total', 'seconds': time.time() - t_start})
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})


def child_process(log_name, phases):
    """The body of a child process: its lines go to stdout (the parent emits them into
    the log) and to a log of its own."""
    import torch
    global LOG
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    LOG = LOG.with_name(log_name)
    LOG.parent.mkdir(parents=True, exist_ok=True)
    LOG.write_text('')
    for phase in phases:
        phase()


if __name__ == '__main__':
    if sys.argv[1:] == [MERGE_CHILD]:
        child_process('chip_smoke_merge.jsonl', [phase_merge_path])
    elif sys.argv[1:] == [ORACLE_CHILD]:
        child_process('chip_smoke_oracle.jsonl',
                      [lambda: phase_algames_path(*phase_oracle_path()[:2])])
    elif sys.argv[1:] == [DYNAMIC_CHILD]:
        child_process('chip_smoke_dynamic.jsonl', [phase_dynamic_path, phase_f1_path])
    elif sys.argv[1:] == [RACE_CHILD]:
        child_process('chip_smoke_race.jsonl', [phase_race_path])
    elif sys.argv[1:2] == [NESTED_CHILD] and len(sys.argv) <= 3:
        child_process('chip_smoke_nested.jsonl',
                      [lambda: nested_paths(sys.argv[2] if len(sys.argv) == 3 else None)])
    elif sys.argv[1:2] == [SHARDED_CHILD] and len(sys.argv) <= 3:
        child_process('chip_smoke_sharded.jsonl',
                      [lambda: sharded_path(sys.argv[2] if len(sys.argv) == 3 else None)])
    else:
        main()
