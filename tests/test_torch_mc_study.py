"""Port parity: the Monte-Carlo study harness, on the CPU in float64.

* ``run_mc_study`` on the agents scenario (M = 3, N = 6, 8 samples, seed 0) with DGSQP
  v2 gives the same ``statuses``, ``iters`` and ``qp_solves`` as the JAX package's, the
  same ``x0`` (1e-12) and, for converged games, ``u_sol`` within 1e-6; the counts of
  ``analyze_results`` are equal and its ``provenance`` names the device, dtype and
  PyTorch version.
* ``solve_with_retries`` with one ``perturb_sigma``, from the study's results with three
  games marked as failed, merges the same games (statuses and counts equal after the
  merge, ``u`` of converged games within 1e-6).
* ``analysis.summarize``, ``gne_compare``, ``success_locations`` and ``format_table``
  give the same output as the JAX package's on the same two ``MCResults`` (the study and
  the study after the retries), carried across field by field.
* ``scripts/torch_monte_carlo_main.py --device cpu`` writes its ``.pkl`` and ``.json``
  under a name that holds every option off its default, so that the option sets of
  ``scripts/run_ablation_study.sh`` write distinct outputs; a scenario that is not
  ported exits with code 2; multi-GPU sharding raises
  ``NotImplementedError`` (the IBR warm start and the baselines' studies are held
  against the JAX package in ``test_torch_baselines_study.py`` and
  ``test_torch_algames_study.py``).
"""
import dataclasses
import importlib.util
import json
import pathlib
import pickle

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dgsqp_tpu.harness import analysis as jax_analysis
from dgsqp_tpu.harness import mc_study as jax_mc
from dgsqp_tpu.harness.scenarios import build_agents_scenario as jax_agents
from dgsqp_tpu.solvers.dgsqp import SQPResult as JaxSQPResult
from dgsqp_tpu.solvers.dgsqp_v2 import DGSQPV2 as JaxDGSQPV2
from dgsqp_tpu.solvers.solver_types import DGSQPV2Params as JaxDGSQPV2Params
from dgsqp_torch import interop
from dgsqp_torch.harness import analysis, mc_study
from dgsqp_torch.harness.scenarios import build_agents_scenario
from dgsqp_torch.solvers.dgsqp import CONV_ABS, CONV_REL, STALLED, SQPResult
from dgsqp_torch.solvers.dgsqp_v2 import DGSQPV2
from dgsqp_torch.solvers.solver_types import DGSQPV2Params

from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
M, N, SAMPLES = 3, 6, 8
# the bench's operating point for the exact game (small constant regularization), with
# a short budget so that the study stays small
PARAMS = dict(sqp_iters=30, p_tol=1e-3, d_tol=1e-3, reg=1e-3, reg_decay=1.0,
              nms_frequency=5, nms_memory_size=5, stall_its=10, line_search_iters=10)


def _solver(cls, params_cls, sc, **kw):
    return cls(sc.joint_model, sc.costs, sc.agent_constraints, sc.shared_constraints,
               sc.bounds, params_cls(N=sc.N, dt=sc.dt, **PARAMS), print_method=None, **kw)


@pytest.fixture(scope='module')
def study():
    jsc, sc = jax_agents(M=M, N=N), build_agents_scenario(M=M, N=N)
    interop.load_track_tables(sc.track, np.asarray(jsc.track._kp),
                              np.asarray(jsc.track._cum_angle))
    jsolver = _solver(JaxDGSQPV2, JaxDGSQPV2Params, jsc)
    solver = _solver(DGSQPV2, DGSQPV2Params, sc, dtype=torch.float64, device='cpu')
    res_j = jax_mc.run_mc_study(jsc, num_samples=SAMPLES, seed=0, solver=jsolver,
                                n_devices=1)
    res_t = mc_study.run_mc_study(sc, num_samples=SAMPLES, seed=0, solver=solver)
    return jsc, sc, jsolver, solver, res_j, res_t


def _converged(statuses):
    return np.isin(statuses, (CONV_ABS, CONV_REL))


def test_study_matches_jax(study):
    *_, res_j, res_t = study
    assert (res_t.scenario, res_t.solver, res_t.num_samples) == \
        (res_j.scenario, res_j.solver, SAMPLES)
    for f in ('statuses', 'iters', 'qp_solves'):
        np.testing.assert_array_equal(getattr(res_t, f), np.asarray(getattr(res_j, f)), f)
    np.testing.assert_allclose(res_t.x0, res_j.x0, rtol=0, atol=1e-12)
    conv = _converged(res_t.statuses)
    assert conv.any() and (res_t.statuses != 0).all()
    np.testing.assert_allclose(res_t.u_sol[conv], np.asarray(res_j.u_sol)[conv], rtol=0,
                               atol=1e-6)
    stats_t, stats_j = mc_study.analyze_results(res_t), jax_mc.analyze_results(res_j)
    for k in ('scenario', 'solver', 'total', 'converged', 'success_rate', 'mean_iters',
              'max_iters', 'mean_qp_solves', 'status_counts'):
        assert stats_t[k] == stats_j[k], k
    prov = stats_t['provenance']
    assert (prov['platform'], prov['device_name'], prov['dtype']) == ('cpu', 'cpu', 'float64')
    assert prov['torch_version'] == torch.__version__ and prov['seed'] == 0
    assert prov['solver_class'] == 'DGSQPV2' and prov['p_tol'] == 1e-3
    assert res_t.provenance['params']['nms_frequency'] == 5
    json.dumps(stats_t)


FAILED_GAMES = (1, 4, 6)


@pytest.fixture(scope='module')
def retried(study):
    """``solve_with_retries`` in both packages from the study's results as the primary
    result, in which three games are marked as stalled (the study converges all eight):
    those three are solved again from a perturbed warm start."""
    jsc, sc, jsolver, solver, res_j, res_t = study
    x0, u_ws, _, _ = jax_mc._sample(jsc, SAMPLES, 0)
    u0 = np.stack([np.asarray(jsolver.problem.stage_to_u(jnp.asarray(u))) for u in u_ws])
    up = np.zeros((SAMPLES, jsc.joint_model.n_u))
    l0 = np.zeros((SAMPLES, jsolver.n_c))       # only read for the games not retried

    def primary(res, cls, conv):
        status = np.array(res.statuses)
        status[list(FAILED_GAMES)] = STALLED
        return cls(*(conv(a) for a in (
            res.u_sol, l0, status, res.iters, res.qp_solves, res.p_feas, res.comp, res.stat)))

    batch = (u0, l0, x0, up)
    out_j = jax_mc.solve_with_retries(jsolver, None, *(jnp.asarray(a) for a in batch),
                                      perturb_sigmas=(0.3,), seed=1,
                                      res=primary(res_j, JaxSQPResult, jnp.asarray))
    out_t = mc_study.solve_with_retries(solver, None,
                                        *interop.bench_batch(*batch, device='cpu'),
                                        perturb_sigmas=(0.3,), seed=1,
                                        res=primary(res_t, SQPResult, torch.as_tensor))
    return out_j, out_t


def test_retries_merge_the_same_games(study, retried):
    *_, res_t = study
    out_j, out_t = retried
    out_j = interop.to_torch_tuple(out_j, SQPResult, device='cpu')
    for f in ('status', 'iters', 'qp_solves'):
        assert torch.equal(getattr(out_t, f).long(), getattr(out_j, f).long()), f
    conv = out_t.status.numpy() == CONV_ABS
    np.testing.assert_allclose(out_t.u.numpy()[conv], out_j.u.numpy()[conv], rtol=0, atol=1e-6)
    # a retry only ever adds conv_abs games, and leaves the others as they were
    kept = np.setdiff1d(np.arange(SAMPLES), FAILED_GAMES)
    np.testing.assert_array_equal(out_t.status.numpy()[kept], res_t.statuses[kept])
    np.testing.assert_array_equal(out_t.u.numpy()[kept], res_t.u_sol[kept])
    won = [g for g in FAILED_GAMES if conv[g]]
    assert won, 'no perturbed restart converged: the merge was not exercised'
    # a merged game carries the retry's own solution, not the primary's
    assert all(np.abs(out_t.u.numpy()[g] - res_t.u_sol[g]).max() > 0 for g in won)
    lost = [g for g in FAILED_GAMES if not conv[g]]
    assert all(out_t.status[g] == STALLED for g in lost)


def test_analysis_matches_jax(study, retried):
    jsc, *_, res_j, _ = study
    out_j, _ = retried
    res_j2 = dataclasses.replace(res_j, statuses=np.asarray(out_j.status),
                                 iters=np.asarray(out_j.iters), u_sol=np.asarray(out_j.u),
                                 p_feas=np.asarray(out_j.p_feas))
    pair_j = (res_j, res_j2)
    pair_t = tuple(interop.to_mc_results(r, mc_study.MCResults) for r in pair_j)
    assert isinstance(pair_t[0].statuses, np.ndarray)
    for r_t, r_j in zip(pair_t, pair_j):
        assert analysis.summarize(r_t) == jax_analysis.summarize(r_j)
        np.testing.assert_array_equal(analysis.success_locations(r_t),
                                      jax_analysis.success_locations(r_j))
    num_ua = jsc.joint_model.num_ua_d
    for kw in (dict(), dict(success='any', input_scale=[2.1, 0.436] * M, match_tol=0.05),
               dict(keep_cols_a=[0, 2], keep_cols_b=[0, 2], hist_bins=6)):
        assert analysis.gne_compare(*pair_t, N, num_ua, **kw) == \
            jax_analysis.gne_compare(*pair_j, N, num_ua, **kw), kw
    np.testing.assert_array_equal(
        analysis.stage_inputs(pair_t[0].u_sol, N, num_ua),
        jax_analysis.stage_inputs(np.asarray(res_j.u_sol), N, num_ua))
    rows = [analysis.summarize(r) for r in pair_t]
    assert analysis.format_table(rows) == jax_analysis.format_table(
        [jax_analysis.summarize(r) for r in pair_j])
    assert analysis.format_table([]) == '(no rows)'
    with pytest.raises(ValueError):
        analysis.gne_compare(pair_t[0], dataclasses.replace(pair_t[1], num_samples=3),
                             N, num_ua)


def _script():
    spec = importlib.util.spec_from_file_location(
        'torch_monte_carlo_main', ROOT / 'scripts' / 'torch_monte_carlo_main.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('dtype, qp_tol', [('float64', 1e-8), ('float32', 3e-7)])
def test_script_writes_results_on_the_cpu(tmp_path, capsys, dtype, qp_tol):
    _script().main(['--scenario', 'curve', '--solver', 'dgsqp_v2', '--n', '4', '--N', '4',
                    '--sqp_iters', '3', '--reg_init', '1e-3', '--reg_decay', '1.0',
                    '--device', 'cpu', '--dtype', dtype, '--out', str(tmp_path)])
    printed = json.loads(capsys.readouterr().out)
    # the options off their defaults name the output: the iteration budget, and float64
    # where the solver's default is float32
    name = 'curve_t60_N4_dgsqp_v2_exact_reg0.001_decay1.0_it3' \
        + ('_float64' if dtype == 'float64' else '') + '_n4_s0'
    with open(tmp_path / f'{name}.pkl', 'rb') as f:
        res = pickle.load(f)
    saved = json.loads((tmp_path / f'{name}.json').read_text())
    assert isinstance(res, mc_study.MCResults) and res.num_samples == 4
    assert saved['total'] == printed['total'] == 4
    assert saved['provenance']['platform'] == 'cpu' and saved['solver'] == 'DGSQPV2'
    assert saved['provenance']['dtype'] == dtype
    # the QP tolerance follows the dtype, as in the bench configuration
    assert res.provenance['params']['qp_tol'] == qp_tol
    assert (res.statuses != 0).all()


@pytest.mark.parametrize('argv', [['--scenario', 'dynamic'],
                                  ['--scenario', 'dynamic', '--formulation', 'approximate']])
def test_script_exits_2_for_what_is_not_ported(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        _script().main(argv + ['--device', 'cpu'])
    assert exc.value.code == 2
    assert 'not' in capsys.readouterr().err


def _ablation_option_sets():
    """The option sets of ``scripts/run_ablation_study.sh``: its loops expanded, its
    sample count and output directory substituted."""
    text = (ROOT / 'scripts' / 'run_ablation_study.sh').read_text()
    lines = text.replace('\\\n', ' ').splitlines()
    loops, sets = {}, []
    for ln in lines:
        ln = ln.strip()
        if ln.startswith('for ') and ' in ' in ln:
            var, values = ln[4:].split(' in ', 1)
            loops[var.strip()] = values.split(';')[0].split()
        elif 'monte_carlo_main.py' in ln:
            argv = ln.split('monte_carlo_main.py', 1)[1].split()
            argv = [a.replace('$N_SAMPLES', '100').replace('$OUT', 'out') for a in argv]
            names = [v for v in loops if any(f'${v}' in a for a in argv)]
            combos = [{}]
            for v in names:
                combos = [dict(c, **{v: x}) for c in combos for x in loops[v]]
            for c in combos:
                sets.append([a if not a.startswith('$') else c[a[1:]] for a in argv])
    return sets


def test_ablation_option_sets_get_distinct_names():
    """Every option set of the ablation study writes an output of its own (the option
    names the JAX script leaves out of its outputs' names collided there), and the
    defaults keep the JAX script's name."""
    script = _script()
    sets = _ablation_option_sets()
    assert len(sets) == 6
    paths = []
    for argv in sets:
        ap = script.parser()
        args = ap.parse_args(argv)
        paths.append(script.output_path(args, ap, script.build_scenario(args)))
    assert len(set(paths)) == len(paths), paths
    ap = script.parser()
    args = ap.parse_args(['--scenario', 'chicane', '--solver', 'dgsqp_v2', '--n', '100'])
    assert script.output_path(args, ap, script.build_scenario(args)).name == \
        'chicane_t45_N25_dgsqp_v2_exact_n100_s0.pkl'
    # one option off its default at a time: a name of its own each
    base = ['--scenario', 'chicane', '--solver', 'mcp', '--n', '8']
    variants = [[], ['--dtype', 'float32'], ['--ibr_ws'], ['--dgsqp_ws', '10'],
                ['--sqp_iters', '30'], ['--p_tol', '1e-4'], ['--d_tol', '1e-4'],
                ['--conv', 'eigh'], ['--no_nms'], ['--merit_function', 'sum_obj_l1'],
                ['--merit_decrease_condition', 'max'], ['--nms_frequency', '3'],
                ['--nms_memory', '3'], ['--delta0', '0']]
    names = set()
    for extra in variants:
        ap = script.parser()
        args = ap.parse_args(base + extra)
        names.add(script.output_path(args, ap, script.build_scenario(args)).name)
    assert len(names) == len(variants)


def test_unported_study_options_raise():
    sc = build_agents_scenario(M=2, N=3)
    with pytest.raises(NotImplementedError):
        mc_study.run_mc_study(sc, num_samples=2, device='cpu', n_devices=4)
