#!/usr/bin/env python3
"""Monte-Carlo study dispatcher of the PyTorch/CUDA port (``dgsqp_torch``).

The counterpart of ``scripts/monte_carlo_main.py``: one argparse entry point
dispatching {scenario} x {solver} x {formulation}; each configuration is one batched
solve on one device.  ``--formulation approximate`` solves the kinematic duel's
approximate (MPCC) game with ``DGSQPV2FrenetApprox`` (with ``--solver mcp``, the MCP
oracle ``PATHMCPFrenetApprox``); ``--scenario duel`` is the exact formulation of the
same game.  ``--scenario dynamic`` is the dynamic-bicycle duel on ``L_track_barc``,
exact or (``--formulation approximate``) progress-augmented, with ``--cost_setting``.  ``--solver mcp`` is the PATH-role oracle in its oracle configuration (the
Josephy + FB hybrid; ``DGSQP_MCP_METHOD``, ``DGSQP_MCP_ITERS`` and
``DGSQP_MCP_RESTARTS`` override its method, iteration budget and restarts), ``--solver
algames`` the ALGAMES baseline; both run in float64 unless ``--dtype`` says otherwise.

Examples:
    python scripts/torch_monte_carlo_main.py --scenario chicane --solver dgsqp --n 200
    python scripts/torch_monte_carlo_main.py --scenario chicane --solver dgsqp_v2 --n 256
    python scripts/torch_monte_carlo_main.py --scenario agents --agents 3 --solver dgsqp_v2
    python scripts/torch_monte_carlo_main.py --scenario curve --device cpu --dtype float64 \\
        --n 8 --N 6
    python scripts/torch_monte_carlo_main.py --formulation approximate --n 256
    python scripts/torch_monte_carlo_main.py --scenario duel --solver dgsqp_v2
    python scripts/torch_monte_carlo_main.py --scenario chicane --solver mcp --n 128
    python scripts/torch_monte_carlo_main.py --scenario chicane --solver algames --n 16
    python scripts/torch_monte_carlo_main.py --scenario chicane --solver dgsqp --ibr_ws
    python scripts/torch_monte_carlo_main.py --scenario merge --solver dgsqp \\
        --dtype float64 --n 128
    python scripts/torch_monte_carlo_main.py --scenario dynamic --solver dgsqp_v2 --n 64 --N 15
    python scripts/torch_monte_carlo_main.py --scenario dynamic --formulation approximate \\
        --n 64 --N 15

The output's name holds the scenario, solver, formulation, n and seed, and a part for
each option that changes the result and is not at its default (``option_tag``); with
``--skip_existing`` a run whose output exists is skipped.  ``--scenario merge`` caps
the horizon at 20, as the JAX script does.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import argparse
import json
import os

# choices of scripts/monte_carlo_main.py
SCENARIOS = ['chicane', 'curve', 'merge', 'agents', 'dynamic', 'duel']
SOLVERS = ['dgsqp', 'dgsqp_v2', 'algames', 'mcp']
# the oracles' default dtype: the AL penalty climbs to 1e7 and the MCP certifies a
# 1e-3 residual of an ill-conditioned system, which float32 cannot carry
ORACLES = ('algames', 'mcp')


def option_tag(args, ap) -> str:
    """The part of a study's output name that its options make: the reg tag of the JAX
    script, then one part for each other option that changes the result and differs
    from its default (the dtype from the solver's own default, the oracle's budget from
    its environment defaults), so that no two such runs share a name and a run with
    the defaults keeps the JAX script's name."""
    approx = args.formulation == 'approximate'
    tag = '_ref' if args.reference_faithful else ''
    if args.reg_init is not None or args.reg_decay is not None:
        tag = f'_reg{args.reg_init if args.reg_init is not None else "d"}' \
              f'_decay{args.reg_decay if args.reg_decay is not None else "d"}'
        if approx:
            tag += f'_{args.eval_type}'
    elif approx and args.eval_type != 'exact':
        tag += f'_{args.eval_type}'
    for name, part in (('merit_function', 'mf'), ('merit_decrease_condition', 'md'),
                       ('sqp_iters', 'it'), ('p_tol', 'ptol'), ('d_tol', 'dtol'),
                       ('conv', 'conv'), ('nms_frequency', 'nmsf'), ('nms_memory', 'nmsm'),
                       ('delta0', 'delta0'), ('dgsqp_ws', 'dgsqpws')):
        value = getattr(args, name)
        if value != ap.get_default(name):
            tag += f'_{part}{value}'
    if args.no_nms:
        tag += '_nonms'
    if args.ibr_ws:
        tag += '_ibrws'
    if args.dtype not in (None, default_dtype(args.solver)):
        tag += f'_{args.dtype}'
    if args.solver == 'mcp':
        for env, part, default in (('DGSQP_MCP_METHOD', 'mcp', 'hybrid'),
                                   ('DGSQP_MCP_ITERS', 'mcpit', '200'),
                                   ('DGSQP_MCP_RESTARTS', 'mcprs', '4')):
            value = os.environ.get(env, default)
            if value != default:
                tag += f'_{part}{value}'
    return tag


def default_dtype(solver: str) -> str:
    return 'float64' if solver in ORACLES else 'float32'


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument('--scenario', default='chicane', choices=SCENARIOS,
                    help="'duel' = the comparison-study game (exact formulation: "
                         "build_exact_duel); with --formulation approximate every "
                         "scenario but 'dynamic' solves build_approximate_duel")
    ap.add_argument('--cost_setting', type=int, default=0, choices=[0, 1],
                    help='dynamic scenario: 0 = input + rate + competition weights '
                         '(1, 1, 1/5), 1 = (0.1, 0.1, 0/1)')
    ap.add_argument('--formulation', default='exact', choices=['exact', 'approximate'])
    ap.add_argument('--solver', default='dgsqp', choices=SOLVERS)
    ap.add_argument('--n', type=int, default=200, help='number of Monte-Carlo samples')
    ap.add_argument('--N', type=int, default=25, help='horizon length')
    ap.add_argument('--theta', type=float, default=45.0, help='track swept angle (deg)')
    ap.add_argument('--agents', type=int, default=3, help='agent count (agents scenario)')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--sqp_iters', type=int, default=50)
    ap.add_argument('--p_tol', type=float, default=1e-3)
    ap.add_argument('--d_tol', type=float, default=1e-3)
    ap.add_argument('--merit_function', default='stat_l1')
    ap.add_argument('--merit_decrease_condition', default='armijo')
    ap.add_argument('--eval_type', default='exact', choices=['always', 'once', 'exact'],
                    help="MPCC geometry cadence: 'once' re-linearises per SQP iteration, "
                         "'always' also at every merit/trial point, 'exact' "
                         "differentiates through the track splines")
    ap.add_argument('--conv', default=None, choices=['eigh', 'ns', 'none'],
                    help="Hessian convexification (DGSQP v1; the approximate game "
                         "defaults to 'eigh')")
    ap.add_argument('--no_nms', action='store_true')
    ap.add_argument('--reg_init', type=float, default=None)
    ap.add_argument('--reg_decay', type=float, default=None)
    ap.add_argument('--nms_frequency', type=int, default=None)
    ap.add_argument('--nms_memory', type=int, default=None)
    ap.add_argument('--delta0', type=float, default=None,
                    help='nms_initial_step_size_factor (0 = merit-check every step '
                         'incl. the first)')
    ap.add_argument('--dgsqp_ws', type=int, default=0,
                    help='warm-start the oracle solver from a K-iteration DGSQP prefix '
                         '(primal + duals); oracle certification stays its own')
    ap.add_argument('--ibr_ws', action='store_true',
                    help='refine the PID warm start with one batched IBR sweep')
    ap.add_argument('--reference_faithful', action='store_true',
                    help="approximate game only: the reference study's configuration "
                         "(no input-rate rows, frozen-P 'once' cadence, reg=1e2*0.95^k, "
                         "NMS frequency 10, delta0=20, 500 iterations, absolute "
                         "tolerances)")
    ap.add_argument('--out', default='results')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'; with --devices K, 'cuda' is CUDA "
                         "devices 0..K-1, or name one device a rank (cuda:0,cuda:0 "
                         "puts two ranks on one card)")
    ap.add_argument('--devices', type=int, default=None,
                    help='shard the study over K ranks, a process and a device each '
                         '(the output is the one device gives)')
    ap.add_argument('--rank_timeout', type=float, default=3600.0,
                    help='seconds before a sharded run that has not ended fails')
    ap.add_argument('--dtype', default=None, choices=['float32', 'float64'],
                    help='float64 for --solver mcp|algames, float32 otherwise')
    ap.add_argument('--skip_existing', action='store_true',
                    help='skip configs whose output pickle already exists')
    return ap


def build_scenario(args):
    """The scenario the options name."""
    from dgsqp_torch.harness.scenarios import (build_agents_scenario,
                                               build_approximate_duel,
                                               build_chicane_scenario,
                                               build_curve_scenario,
                                               build_dynamic_approximate_duel,
                                               build_dynamic_duel, build_exact_duel,
                                               build_merge_scenario)
    if args.scenario == 'dynamic' and args.formulation == 'approximate':
        return build_dynamic_approximate_duel(N=args.N, cost_setting=args.cost_setting,
                                              rate_constraints=not args.reference_faithful)
    if args.scenario == 'dynamic':
        return build_dynamic_duel(N=args.N, cost_setting=args.cost_setting)
    if args.formulation == 'approximate':
        return build_approximate_duel(N=args.N, rate_constraints=not args.reference_faithful)
    if args.scenario == 'duel':
        return build_exact_duel(N=args.N)
    if args.scenario == 'chicane':
        return build_chicane_scenario(N=args.N, theta_deg=args.theta)
    if args.scenario == 'curve':
        return build_curve_scenario(N=args.N, theta_deg=max(args.theta, 60.0))
    if args.scenario == 'merge':
        return build_merge_scenario(N=min(args.N, 20))
    return build_agents_scenario(M=args.agents, N=args.N, theta_deg=args.theta)


def output_path(args, ap, scenario) -> Path:
    """Where the study of these options writes its pickle (and its JSON beside)."""
    return Path(args.out) / (f'{scenario.name}_{args.solver}_{args.formulation}'
                             f'{option_tag(args, ap)}_n{args.n}_s{args.seed}.pkl')


def main(argv=None):
    """Run the study the options name: on one device; on ``--devices K`` ranks started
    here (``spawn_ranks``: K CUDA devices, or the K devices ``--device`` lists, e.g.
    ``cuda:0,cuda:0``, or ``cpu``); or, when ``DGSQP_COORDINATOR`` and
    ``DGSQP_NUM_PROCESSES`` are set, as one rank of processes started apart
    (``init_distributed``).  Rank 0 alone writes the output and prints its summary."""
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = parser()
    args = ap.parse_args(argv)
    from dgsqp_torch.parallel.mesh import games_mesh, init_distributed, leave, spawn_ranks

    if init_distributed():
        try:
            _report(run_study(argv, games_mesh(args.devices)))
        finally:
            leave()
    elif (args.devices or 1) > 1:
        # the ranks import this script by name to find their function
        here = str(Path(__file__).resolve().parent)
        if here not in sys.path:
            sys.path.insert(0, here)
        _report(spawn_ranks(_study_rank, args.devices, argv, devices=args.device,
                            timeout_s=args.rank_timeout)[0])
    else:
        _report(run_study(argv))


def _study_rank(mesh, argv):
    return run_study(argv, mesh)


def _report(stats):
    if stats is not None:
        print(json.dumps(stats, indent=2, default=str))


def run_study(argv, mesh=None):
    """The study of these options on this process's device (the rank's, with a
    ``mesh``); saves it and returns its summary, on rank 0 (``None`` on the others)."""
    ap = parser()
    args = ap.parse_args(argv)
    approx = args.formulation == 'approximate'
    device = args.device if mesh is None else str(mesh.device)
    n_devices = None if mesh is None else mesh.size

    import torch

    from dgsqp_torch.harness.mc_study import analyze_results, run_mc_study, save_results
    from dgsqp_torch.solvers.dgsqp_v2 import DGSQPV2
    from dgsqp_torch.solvers.dgsqp_v2_frenet import DGSQPV2FrenetApprox
    from dgsqp_torch.solvers.solver_types import DGSQPParams, DGSQPV2Params

    dtype = getattr(torch, args.dtype or default_dtype(args.solver))
    # the bench's rule (``build_bench_solver``): the parameters' default of 1e-8 is below
    # what a float32 QP can certify, and a QP that misses it counts as failed
    qp_tol = 1e-8 if dtype == torch.float64 else 3e-7
    scenario = build_scenario(args)
    out_name = output_path(args, ap, scenario)
    if args.skip_existing and out_name.exists():
        print(f'skip (exists): {out_name}', file=sys.stderr)
        return

    def nms_overrides(params):
        if args.reg_init is not None:
            params.reg = args.reg_init
        if args.reg_decay is not None:
            params.reg_decay = args.reg_decay
        if args.nms_frequency is not None:
            params.nms_frequency = args.nms_frequency
        if args.nms_memory is not None:
            params.nms_memory_size = args.nms_memory
        if args.delta0 is not None:
            params.nms_initial_step_size_factor = args.delta0

    def mcp_params():
        from dgsqp_torch.solvers.solver_types import PATHMCPParams
        # the oracle configuration: the Josephy + FB hybrid (PATH's two regimes)
        return PATHMCPParams(N=scenario.N, dt=scenario.dt, tol=args.p_tol,
                             method=os.environ.get('DGSQP_MCP_METHOD', 'hybrid'),
                             max_iters=int(os.environ.get('DGSQP_MCP_ITERS', 200)),
                             max_restarts=int(os.environ.get('DGSQP_MCP_RESTARTS', 4)))

    if approx and args.solver == 'mcp':
        from dgsqp_torch.solvers.mcp import PATHMCPFrenetApprox
        mcp = PATHMCPFrenetApprox(scenario.joint_model, scenario.costs,
                                  scenario.agent_constraints, scenario.shared_constraints,
                                  scenario.bounds, mcp_params(), print_method=None,
                                  dtype=dtype, device=device)
        res = run_mc_study(scenario, num_samples=args.n, seed=args.seed, solver=mcp,
                           ibr_ws=args.ibr_ws, dgsqp_ws_iters=args.dgsqp_ws,
                           n_devices=n_devices)
    elif approx:
        if args.reference_faithful:
            # the reference study's own knobs: frozen-P cadence, heavy decaying proximal
            # regularisation, blind d-steps, absolute tolerances
            params = DGSQPV2Params(N=scenario.N, dt=scenario.dt,
                                   sqp_iters=max(args.sqp_iters, 500),
                                   p_tol=args.p_tol, d_tol=args.d_tol,
                                   merit_function=args.merit_function,
                                   merit_decrease_condition=args.merit_decrease_condition,
                                   approximation_eval=('once' if args.eval_type == 'exact'
                                                       else args.eval_type),
                                   reg=1e2, reg_decay=0.95, nms_frequency=10,
                                   nms_memory_size=10, nms_initial_step_size_factor=20.0,
                                   conv_scaled_stat=False, conv_method=args.conv or 'eigh',
                                   nms=not args.no_nms, qp_tol=qp_tol)
        else:
            # the measured MPCC operating point: every step merit-checked (frequency 1,
            # delta0 0), constant reg 1, gradient-scaled KKT tolerance
            params = DGSQPV2Params(N=scenario.N, dt=scenario.dt,
                                   sqp_iters=max(args.sqp_iters, 150), p_tol=args.p_tol,
                                   d_tol=args.d_tol, merit_function=args.merit_function,
                                   merit_decrease_condition=args.merit_decrease_condition,
                                   approximation_eval=args.eval_type,
                                   reg=1.0, reg_decay=1.0, nms_frequency=1,
                                   nms_memory_size=10, nms_initial_step_size_factor=0.0,
                                   conv_scaled_stat=True, conv_method=args.conv or 'eigh',
                                   nms=not args.no_nms, qp_tol=qp_tol)
        nms_overrides(params)
        solver = DGSQPV2FrenetApprox(scenario.joint_model, scenario.costs,
                                     scenario.agent_constraints,
                                     scenario.shared_constraints, scenario.bounds,
                                     params, print_method=None, dtype=dtype,
                                     device=device)
        res = run_mc_study(scenario, num_samples=args.n, seed=args.seed, solver=solver,
                           n_devices=n_devices)
    elif args.solver == 'dgsqp':
        params = DGSQPParams(N=scenario.N, dt=scenario.dt, reg=1e-3, nonmono_ls=True,
                             line_search_iters=50, sqp_iters=args.sqp_iters,
                             p_tol=args.p_tol, d_tol=args.d_tol, beta=0.01, tau=0.5,
                             merit_function=args.merit_function, qp_tol=qp_tol)
        if args.conv:
            params.conv_method = args.conv
        res = run_mc_study(scenario, solver_params=params, num_samples=args.n,
                           seed=args.seed, dtype=dtype, device=device,
                           ibr_ws=args.ibr_ws, n_devices=n_devices)
    elif args.solver == 'algames':
        from dgsqp_torch.harness.mc_study import run_mc_study_algames
        if mesh is not None:
            raise ValueError('the ALGAMES study runs on one device (as the JAX '
                             "script's): drop --devices")
        res = run_mc_study_algames(scenario, num_samples=args.n, seed=args.seed,
                                   dtype=dtype, device=device)
    elif args.solver == 'mcp':
        from dgsqp_torch.solvers.mcp import PATHMCP
        mcp = PATHMCP(scenario.joint_model, scenario.costs, scenario.agent_constraints,
                      scenario.shared_constraints, scenario.bounds, mcp_params(),
                      print_method=None, dtype=dtype, device=device)
        res = run_mc_study(scenario, num_samples=args.n, seed=args.seed, solver=mcp,
                           ibr_ws=args.ibr_ws, dgsqp_ws_iters=args.dgsqp_ws,
                           n_devices=n_devices)
    else:
        params = DGSQPV2Params(N=scenario.N, dt=scenario.dt, sqp_iters=args.sqp_iters,
                               p_tol=args.p_tol, d_tol=args.d_tol,
                               merit_function=args.merit_function,
                               merit_decrease_condition=args.merit_decrease_condition,
                               nms=not args.no_nms, qp_tol=qp_tol)
        nms_overrides(params)
        res = run_mc_study(scenario, solver_params=params, num_samples=args.n,
                           seed=args.seed, solver_cls=DGSQPV2, dtype=dtype,
                           device=device, ibr_ws=args.ibr_ws, n_devices=n_devices)

    if mesh is not None and mesh.rank != 0:
        return None
    save_results(res, out_name)
    return analyze_results(res)


if __name__ == '__main__':
    main()
