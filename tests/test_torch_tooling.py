"""Port parity for the diagnosis and study tooling, on the CPU in float64.

* v1's ``solve_batch_traced`` (the nested machine's iterations, here with the bench's
  watchdog) on the chicane bench at N=5, 4 games from a perturbed warm start, with
  ``record_iterates`` and ``record_conds``: every trace field of the games that do not
  diverge within 1e-8 of the JAX package's, relative to the field's largest entry; the
  statuses, iterations and QP solves of all of them equal.
* ``scripts/torch_diagnose_failures.py``: ``classify_trace`` labels traces drawn with
  numpy as the JAX script's does; ``trace_failures`` traces the padded failures and cuts
  the trace to them; ``classify_failures`` reports every failure.
* ``dgsqp_torch.utils.profiling``: ``Timers``, ``device_trace``.
* ``scripts/torch_analyze_regularization.py`` on a small synthetic study directory,
  ``scripts/torch_merge_oracles.py`` against the JAX script's ``merge``, and
  ``scripts/torch_stalled_oracle_crosstab.py``'s cross-tab on synthetic runs.
* The equilibrium-match study's games (``chip_smoke.py``'s ``oracle_path``: 128 chicane
  games, N=25, seed 0, float64): :func:`oracle_statuses` gives each package's per-game
  statuses on the CPU, for DGSQP v1 or the MCP oracle; run this file as a script
  (``python tests/test_torch_tooling.py --oracle-statuses [GAMES]``) to print both
  packages' strings, and the ``slow`` test holds DGSQP's to each other.  ``python
  tests/test_torch_tooling.py --write-record`` writes the JAX package's strings of all
  128 games (DGSQP and the MCP) to ``dgsqp_torch/harness/data/oracle_statuses_f64.json``,
  the record that ``oracle_path`` counts the card's games against.  ``python
  tests/test_torch_tooling.py --mcp-parting GAME [ITERS]`` traces one of those games
  through the hybrid MCP's Josephy phase in both packages (alone in its batch) and in
  the port beside game 91 and in the batch of 128, and prints how far the iterates are
  apart after each iteration (where the MCP's statuses part: rounding, amplified).
"""
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# run as a script, the packages are found from the repo's root
sys.path.insert(0, str(ROOT))

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dgsqp_tpu.harness.bench_setup import build_bench_batch as jax_batch
from dgsqp_tpu.harness.bench_setup import build_bench_solver as jax_solver
from dgsqp_torch import interop
from dgsqp_torch.harness.bench_setup import build_bench_solver
from dgsqp_torch.harness.mc_study import MCResults
from dgsqp_torch.solvers.dgsqp import (CONV_ABS, CONV_REL, DIVERGED, MAX_IT, STALLED,
                                       STATUS_MSG)
from dgsqp_torch.utils.profiling import Timers, device_trace

from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

N, BATCH, TRACE_ITERS = 5, 4, 8
# a perturbed warm start (tests/test_torch_dgsqp.py's): the watchdog runs insurance
# rounds and one game diverges
SIGMA, NOISE_SEED = 0.5, 2
RTOL = 1e-8


def _script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / 'scripts' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def traced():
    """The perturbed bench batch traced by both packages:
    (port solver, batch, port (result, trace), JAX (result, trace))."""
    jsc, jsol = jax_solver(horizon=N)
    u0, l0, x0, up = (np.asarray(a) for a in jax_batch(jsc, jsol, BATCH, seed=0))
    u0 = u0 + SIGMA * np.random.default_rng(NOISE_SEED).standard_normal(u0.shape)
    batch = (u0, l0, x0, up)
    sc, tsol = build_bench_solver(horizon=N, dtype=torch.float64, device='cpu')
    interop.load_track_tables(sc.track, np.asarray(jsc.track._kp),
                              np.asarray(jsc.track._cum_angle))
    kw = dict(num_iters=TRACE_ITERS, record_iterates=True, record_conds=True)
    out_j = jsol.solve_batch_traced(*(jnp.asarray(a) for a in batch), **kw)
    batch_t = interop.bench_batch(*batch, device='cpu')
    out_t = tsol.solve_batch_traced(*batch_t, **kw)
    return tsol, batch_t, out_t, out_j


def test_v1_traced_matches_jax(traced):
    tsol, _, (res_t, tr_t), (res_j, tr_j) = traced
    # the bench's solver runs the flat machine; its traced solve runs the nested body
    assert tsol._use_flat()
    assert set(tr_t) == set(tr_j) == {'status', 'it', 'p_feas', 'comp', 'stat', 'qp_solves',
                                      'du_norm', 'dl_norm', 'u', 'l', 'cond_Q', 'cond_G'}
    status_j = np.asarray(res_j.status)
    for f in ('status', 'it', 'qp_solves'):
        np.testing.assert_array_equal(tr_t[f].numpy(), np.asarray(tr_j[f]), err_msg=f)
    # the watchdog ran insurance rounds (more QPs than iterations) and a game diverged
    assert (tr_t['qp_solves'][:, -1] > tr_t['it'][:, -1]).any()
    assert (status_j == DIVERGED).sum() == 1
    keep = status_j != DIVERGED
    for f in tr_j:
        a, b = tr_t[f].double().numpy()[keep], np.asarray(tr_j[f], np.float64)[keep]
        assert np.abs(a - b).max() <= RTOL * np.abs(b).max(), f
    for f in ('u', 'l', 'stat', 'p_feas', 'comp'):
        a, b = getattr(res_t, f).numpy()[keep], np.asarray(getattr(res_j, f))[keep]
        assert np.abs(a - b).max() <= RTOL * max(np.abs(b).max(), 1.0), f


def test_trace_failures_traces_the_padded_failures(traced):
    diag = _script('torch_diagnose_failures')
    tsol, batch, (_, tr_full), _ = traced
    fail = np.array([1, 3])
    pad, _, tr = diag.trace_failures(tsol, batch, fail, TRACE_ITERS)
    assert pad.tolist() == [1, 3] + [1] * 14
    assert all(v.shape[0] == 2 for v in tr.values())
    for f in ('status', 'it', 'qp_solves'):
        np.testing.assert_array_equal(tr[f][0], tr_full[f][1].numpy())
    np.testing.assert_allclose(tr['stat'][0], tr_full['stat'][1].numpy(), rtol=1e-10)
    status = np.array([CONV_ABS, MAX_IT, CONV_ABS, STALLED])
    rep = diag.classify_failures(fail, tr, status, tsol.params.p_tol, tsol.params.d_tol,
                                 STATUS_MSG)
    assert set(rep['failures']) == {1, 3}
    assert rep['failures'][3]['status'] == 'stalled'
    assert sum(rep['failure_classes'].values()) == 2
    assert all(v['label'] in diag.LABELS for v in rep['failures'].values())
    assert set(rep['stat_final_percentiles']) == {'10', '50', '90'}


def _traces(rng, T=30):
    """Traces of every kind: plateaus, decays, swings, infeasible tails."""
    out = []
    t = np.arange(T)
    for kind in range(40):
        p_feas = np.where(rng.random(T) < 0.3 * (kind % 4 == 3), 1e-2, 0.0)
        if kind % 4 == 0:
            stat = 0.5 * (1 + 0.02 * rng.standard_normal(T))
        elif kind % 4 == 1:
            stat = np.exp(-rng.uniform(0.05, 0.3) * t)
        else:
            stat = np.abs(rng.uniform(0.5, 4.0) * np.sin(t * rng.uniform(0.5, 2.0))) + 1e-3
        out.append((p_feas, np.abs(rng.standard_normal(T)), stat))
    return out


def test_classify_trace_matches_jax_script():
    ours = _script('torch_diagnose_failures').classify_trace
    theirs = _script('diagnose_failures').classify_trace
    labels = []
    for p_feas, comp, stat in _traces(np.random.default_rng(0)):
        labels.append(ours(p_feas, comp, stat, 1e-3, 1e-3))
        assert labels[-1] == theirs(p_feas, comp, stat, 1e-3, 1e-3)
    assert set(labels) == {'stalled', 'slow', 'oscillating', 'infeasible'}


def test_profiling_helpers(tmp_path):
    timers = Timers()
    for _ in range(3):
        with timers.span('a'):
            time.sleep(0.001)
    with timers.span('b'):
        pass
    s = timers.summary()
    assert list(s) == ['a', 'b'] and s['a']['count'] == 3 and s['b']['count'] == 1
    assert s['a']['total_s'] >= 0.003 and s['a']['mean_s'] == s['a']['total_s'] / 3
    with device_trace(None) as prof:
        assert prof is None
    with device_trace(str(tmp_path)) as prof:
        torch.ones(8) @ torch.ones(8)
    assert prof is not None and any(tmp_path.iterdir())


def test_analyze_regularization(tmp_path, capsys):
    ana = _script('torch_analyze_regularization')
    cells = {('once', 1.0, 0.5): 0.25, ('once', 1.0, 1.0): 0.5, ('once', 100.0, 0.5): 0.75,
             ('always', 0.0, 1.0): 1.0}
    for (ev, reg, decay), rate in cells.items():
        name = f'chicane_dgsqp_v2_approximate_reg{reg}_decay{decay}_{ev}_n4_s0.json'
        (tmp_path / name).write_text(json.dumps(dict(success_rate=rate, solves_per_s=2.0,
                                                     mean_iters=10.0,
                                                     status_counts={'conv_abs_tol': 1})))
    (tmp_path / 'chicane_dgsqp_v2_approximate_n4_s0.json').write_text('{}')  # not a cell
    ana.main([str(tmp_path)])
    text = capsys.readouterr().out
    assert 'eval_type=once' in text and 'eval_type=always' in text and '   --  ' in text
    summary = json.loads((tmp_path / 'regularization_summary.json').read_text())
    assert set(summary['once']) == {'reg1.0_decay0.5', 'reg1.0_decay1.0', 'reg100.0_decay0.5'}
    assert summary['always']['reg0.0_decay1.0']['success_rate'] == 1.0


def _mc(cls, solver, statuses, u, x0, **prov):
    n = len(statuses)
    z = np.zeros(n)
    return cls(scenario='chicane', solver=solver, num_samples=n,
               statuses=np.asarray(statuses), iters=z, qp_solves=z, p_feas=z, comp=z, stat=z,
               u_sol=np.asarray(u, float), x0=np.asarray(x0, float), wall_time_s=1.0,
               compile_time_s=0.0, provenance=prov or None)


def test_merge_oracles_matches_jax_script():
    from dgsqp_tpu.harness.mc_study import MCResults as JaxMCResults
    ours, theirs = _script('torch_merge_oracles').merge, _script('merge_oracles').merge
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal((6, 4))
    sa, sb = [CONV_ABS, 5, 5, CONV_REL, CONV_ABS, 5], [5, CONV_ABS, 5, CONV_ABS, 5, CONV_ABS]
    ua, ub = rng.standard_normal((6, 3)), rng.standard_normal((6, 3))
    out = ours(_mc(MCResults, 'PATHMCP', sa, ua, x0), _mc(MCResults, 'ALGAMES', sb, ub, x0))
    ref = theirs(_mc(JaxMCResults, 'PATHMCP', sa, ua, x0),
                 _mc(JaxMCResults, 'ALGAMES', sb, ub, x0))
    assert out.solver == ref.solver == 'PATHMCP+ALGAMES'
    np.testing.assert_array_equal(out.statuses, ref.statuses)
    np.testing.assert_array_equal(out.u_sol, ref.u_sol)
    with pytest.raises(AssertionError):     # float32 and float64 runs do not merge
        ours(_mc(MCResults, 'a', sa, ua, x0, dtype='float32', seed=0),
             _mc(MCResults, 'b', sb, ub, x0, dtype='float64', seed=0))


def test_stalled_oracle_crosstab():
    ct = _script('torch_stalled_oracle_crosstab').crosstab
    rng = np.random.default_rng(2)
    x0 = rng.standard_normal((6, 4))
    bench = np.array([CONV_ABS, STALLED, CONV_REL, MAX_IT, CONV_ABS, STALLED])
    # the oracle sampled games 0-4 (in another order) and one game the bench did not
    o_x0 = np.concatenate([x0[[4, 3, 2, 1, 0]], rng.standard_normal((1, 4))])
    oracle = _mc(MCResults, 'PATHMCP', [CONV_ABS, 5, CONV_ABS, CONV_ABS, 5, CONV_ABS],
                 np.zeros((6, 2)), o_x0)
    rep = ct(bench, x0, {'mcp.pkl': oracle}, STATUS_MSG, CONV_ABS)
    assert rep['aligned'] == 5 and rep['aligned_by_file'] == {'mcp.pkl': 5}
    assert rep['bench_conv_abs'] == 2 and rep['bench_failures'] == 3
    # bench failures 1, 2, 3: the oracle solved games 1 and 2, not 3
    assert rep['failures_oracle_solved'] == 2 and rep['failures_oracle_also_fails'] == 1
    assert [r['sample'] for r in rep['per_failure']] == [1, 2, 3]
    assert [r['PATHMCP'] for r in rep['per_failure']] == [True, True, False]
    assert rep['oracle_conv_counts'] == {'PATHMCP': 3}


ORACLE_GAMES = 128
ORACLE_RECORD = ROOT / 'dgsqp_torch' / 'harness' / 'data' / 'oracle_statuses_f64.json'


def oracle_statuses(package: str, solver: str, games: int = ORACLE_GAMES) -> str:
    """One status digit a game: the oracle study's first ``games`` of its 128 chicane
    games solved on the CPU in float64 by ``solver`` ('dgsqp': DGSQP v1 with the study's
    defaults; 'mcp': the hybrid MCP oracle as ``oracle_path`` runs it) in ``package``
    ('jax' or 'torch'; the JAX package needs x64 on)."""
    if package == 'jax':
        from dgsqp_tpu.harness import mc_study
        from dgsqp_tpu.harness.scenarios import build_chicane_scenario
        from dgsqp_tpu.solvers.mcp import PATHMCP
        from dgsqp_tpu.solvers.solver_types import PATHMCPParams
        head = lambda sample: (lambda sc, n, seed: tuple(a[:n] for a in sample(sc, 128, seed)))
        kw = {}
    else:
        from dgsqp_torch.harness import mc_study
        from dgsqp_torch.harness.scenarios import build_chicane_scenario
        from dgsqp_torch.solvers.mcp import PATHMCP
        from dgsqp_torch.solvers.solver_types import PATHMCPParams
        head = lambda sample: (lambda sc, n, seed, dtype, device:
                               tuple(a[:n] for a in sample(sc, 128, seed, dtype, device)))
        kw = dict(dtype=torch.float64, device='cpu')
    sc = build_chicane_scenario(N=25, theta_deg=45.0)
    if solver == 'mcp':
        kw = dict(solver=PATHMCP(sc.joint_model, sc.costs, sc.agent_constraints,
                                 sc.shared_constraints, sc.bounds,
                                 PATHMCPParams(N=sc.N, dt=sc.dt, tol=1e-3, method='hybrid',
                                               max_iters=200, max_restarts=4),
                                 print_method=None, **kw))
    sample = mc_study._sample
    mc_study._sample = head(sample)
    try:
        res = mc_study.run_mc_study(sc, num_samples=games, seed=0, **kw)
    finally:
        mc_study._sample = sample
    return ''.join(str(int(s)) for s in res.statuses)


@pytest.mark.slow
def test_oracle_dgsqp_statuses_match_jax():
    """DGSQP v1 on the oracle study's games: the port on the CPU gives the JAX package's
    statuses game for game (the card's ``oracle_path`` is compared with the same
    strings)."""
    assert oracle_statuses('torch', 'dgsqp') == oracle_statuses('jax', 'dgsqp')


def _write_oracle_record():
    """The JAX package's DGSQP and MCP statuses of the 128 oracle games, with how they
    were made."""
    rec = dict(command='python tests/test_torch_tooling.py --write-record',
               package='dgsqp_tpu', device='cpu', dtype='float64', scenario='chicane',
               horizon=25, theta_deg=45.0, games=ORACLE_GAMES, seed=0,
               status_string={}, seconds={})
    for solver in ('dgsqp', 'mcp'):
        t0 = time.time()
        rec['status_string'][solver] = oracle_statuses('jax', solver)
        rec['seconds'][solver] = time.time() - t0
    ORACLE_RECORD.write_text(json.dumps(rec) + '\n')
    print(json.dumps(rec))


def mcp_parting(game: int, iters: int = 10):
    """One oracle game's Josephy-phase iterates (the hybrid MCP's first phase, float64,
    CPU) in the JAX package and in the port from the same inputs, alone in the batch,
    and in the port beside game 91 and in the batch of 128: one JSON line an iteration
    with the largest differences of u and (relative) of the duals."""
    import jax
    from dgsqp_tpu.harness.scenarios import build_chicane_scenario as jax_chicane
    from dgsqp_tpu.solvers.mcp import PATHMCP as JaxPATHMCP
    from dgsqp_tpu.solvers.solver_types import PATHMCPParams as JaxParams
    from dgsqp_torch.harness import mc_study
    from dgsqp_torch.harness.scenarios import build_chicane_scenario
    from dgsqp_torch.harness.warm_start import seed_virtual_rate_prev
    from dgsqp_torch.solvers.mcp import PATHMCP
    from dgsqp_torch.solvers.solver_types import PATHMCPParams
    from test_torch_mcp import jax_trace, port_trace
    torch.set_num_threads(1)
    kw = dict(N=25, tol=1e-3, method='hybrid', max_iters=200, max_restarts=4)
    sc, jsc = build_chicane_scenario(N=25, theta_deg=45.0), jax_chicane(N=25, theta_deg=45.0)
    game_args = (sc.joint_model, sc.costs, sc.agent_constraints, sc.shared_constraints,
                 sc.bounds)
    ts = PATHMCP(*game_args, PATHMCPParams(dt=sc.dt, **kw), print_method=None,
                 dtype=torch.float64, device='cpu')
    js = JaxPATHMCP(jsc.joint_model, jsc.costs, jsc.agent_constraints,
                    jsc.shared_constraints, jsc.bounds, JaxParams(dt=jsc.dt, **kw),
                    print_method=None)
    x0_all, u_ws_all, _, _ = mc_study._sample(sc, ORACLE_GAMES, 0, torch.float64, 'cpu')

    def warm(games):
        x0 = torch.as_tensor(x0_all)[games]
        u_ws = torch.as_tensor(u_ws_all)[games]
        u0 = ts.problem.stage_to_u(u_ws)
        up = seed_virtual_rate_prev(torch.zeros(len(games), sc.joint_model.n_u),
                                    u_ws[:, 0, :], sc.joint_model)
        return u0, mc_study._dual_warm_start(ts, u0, x0, up), x0, up

    alone = warm([game])
    _, hist_j = jax_trace(lambda u, l, x, p: js._solve_core_josephy(u, l, x, p, None),
                          iters, *(jnp.asarray(a.numpy()) for a in alone))
    runs = {'jax': [(np.asarray(hist_j.u)[0, k], np.asarray(hist_j.l)[0, k])
                    for k in range(iters)]}
    for name, games in (('alone', [game]), ('beside_91', [game, 91]),
                        ('batch_128', list(range(ORACLE_GAMES)))):
        row = games.index(game)
        runs[name] = [(c.u[row].numpy(), c.l[row].numpy())
                      for c in port_trace(ts, 'josephy', iters, *warm(games))]
    for k in range(iters):
        u0, l0 = runs['alone'][k]
        line = {'iteration': k + 1}
        for name in ('jax', 'beside_91', 'batch_128'):
            u, l = runs[name][k]
            line[name] = {'u': float(np.abs(u - u0).max()),
                          'l': float(np.abs(l - l0).max() / max(1.0, np.abs(l0).max()))}
        print(json.dumps(line), flush=True)


if __name__ == '__main__':
    usage = ('usage: python tests/test_torch_tooling.py --oracle-statuses [GAMES]'
             ' | --write-record | --mcp-parting GAME [ITERS]')
    if not (sys.argv[1:] == ['--write-record'] or
            (sys.argv[1:2] == ['--oracle-statuses'] and len(sys.argv) <= 3) or
            (sys.argv[1:2] == ['--mcp-parting'] and len(sys.argv) in (3, 4))):
        sys.exit(usage)
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    if sys.argv[1] == '--write-record':
        _write_oracle_record()
        sys.exit(0)
    if sys.argv[1] == '--mcp-parting':
        sys.path.insert(0, str(ROOT / 'tests'))
        mcp_parting(int(sys.argv[2]), *(int(a) for a in sys.argv[3:]))
        sys.exit(0)
    n = int(sys.argv[2]) if len(sys.argv) == 3 else ORACLE_GAMES
    print(json.dumps({f'{solver}_{package}': oracle_statuses(package, solver, n)
                      for solver in ('dgsqp', 'mcp') for package in ('jax', 'torch')}))
