"""Port parity: the Monte-Carlo study with the baselines, on the CPU in float64.

On the chicane duel at N=5 (4 games, seed 0, the JAX package's track tables):

* ``run_mc_study(solver=PATHMCP(...))`` with the oracle's configuration
  (``method='hybrid'``, tol 1e-3, 4 restarts; 40 iterations a phase): the same x0
  (1e-12), statuses, iterations and ``qp_solves`` (the iteration count, as in the JAX
  package) as the JAX study, ``u_sol`` of solved games within 1e-6, and
  ``analyze_results``' counts;
* ``run_mc_study(..., ibr_ws=True)`` (one batched IBR sweep refines the warm start, here
  before an FB-Newton MCP): the same;
* ``scripts/torch_monte_carlo_main.py --solver mcp --device cpu`` writes a float64
  study with the method and budget of ``DGSQP_MCP_METHOD``/``DGSQP_MCP_ITERS``, and
  ``scripts/torch_gne_compare_main.py`` compares two study pickles (a study with
  itself: every solved game matches).

The ALGAMES study is in ``test_torch_algames_study.py``.
"""
import importlib.util
import json
import pathlib
import pickle

import numpy as np
import pytest
import torch

from dgsqp_tpu.harness import mc_study as jax_mc
from dgsqp_tpu.solvers.mcp import PATHMCP as JaxPATHMCP
from dgsqp_tpu.solvers.solver_types import PATHMCPParams as JaxParams
from dgsqp_torch.harness import mc_study
from dgsqp_torch.solvers.mcp import SOLVED, PATHMCP
from dgsqp_torch.solvers.solver_types import PATHMCPParams

from test_torch_mcp_chicane import chicane_pair
from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, GAMES = 5, 4
ORACLE = dict(N=N, dt=0.1, tol=1e-3, max_iters=40, max_restarts=4)


def _mcp(cls, params_cls, sc, method, **kw):
    return cls(sc.joint_model, sc.costs, sc.agent_constraints, sc.shared_constraints,
               sc.bounds, params_cls(method=method, **ORACLE), print_method=None, **kw)


def same_study(res_t, res_j, solved_code=SOLVED):
    assert (res_t.scenario, res_t.solver, res_t.num_samples) == \
        (res_j.scenario, res_j.solver, GAMES)
    np.testing.assert_allclose(res_t.x0, np.asarray(res_j.x0), rtol=0, atol=1e-12)
    for f in ('statuses', 'iters', 'qp_solves'):
        np.testing.assert_array_equal(getattr(res_t, f), np.asarray(getattr(res_j, f)), f)
    conv = res_t.statuses == solved_code
    assert conv.any()
    np.testing.assert_allclose(res_t.u_sol[conv], np.asarray(res_j.u_sol)[conv], rtol=0,
                               atol=1e-6)
    stats_t, stats_j = mc_study.analyze_results(res_t), jax_mc.analyze_results(res_j)
    for k in ('total', 'converged', 'success_rate', 'max_iters', 'status_counts'):
        assert stats_t[k] == stats_j[k], k


@pytest.mark.parametrize('method,ibr_ws', [('hybrid', False), ('fbnewton', True)],
                         ids=['oracle', 'ibr_ws'])
def test_mcp_study_matches_jax(method, ibr_ws):
    jsc, sc = chicane_pair()
    js = _mcp(JaxPATHMCP, JaxParams, jsc, method)
    ts = _mcp(PATHMCP, PATHMCPParams, sc, method, dtype=torch.float64, device='cpu')
    res_j = jax_mc.run_mc_study(jsc, num_samples=GAMES, seed=0, solver=js, n_devices=1,
                                ibr_ws=ibr_ws)
    res_t = mc_study.run_mc_study(sc, num_samples=GAMES, seed=0, solver=ts, ibr_ws=ibr_ws)
    same_study(res_t, res_j)
    assert res_t.provenance['ibr_ws'] == ibr_ws
    assert res_t.provenance['solver_class'] == 'PATHMCP'


def _script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / 'scripts' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_study_scripts_run_the_oracle(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv('DGSQP_MCP_METHOD', 'fbnewton')
    monkeypatch.setenv('DGSQP_MCP_ITERS', '40')
    _script('torch_monte_carlo_main').main(
        ['--scenario', 'chicane', '--solver', 'mcp', '--n', str(GAMES), '--N', str(N),
         '--device', 'cpu', '--out', str(tmp_path)])
    stats = json.loads(capsys.readouterr().out)
    assert stats['total'] == GAMES and stats['provenance']['dtype'] == 'float64'
    # the oracle's method and budget are off their defaults: the output's name says so
    pkl = tmp_path / f'chicane_t45_N{N}_mcp_exact_mcpfbnewton_mcpit40_n{GAMES}_s0.pkl'
    with open(pkl, 'rb') as f:
        res = pickle.load(f)
    assert res.solver == 'PATHMCP' and res.provenance['params']['method'] == 'fbnewton'
    assert res.provenance['params']['max_iters'] == 40

    out = tmp_path / 'match.json'
    _script('torch_gne_compare_main').main(
        [str(pkl), str(pkl), '--N', str(N), '--num_ua', '2', '2', '--scale', '2.1', '0.436',
         '2.1', '0.436', '--out', str(out)])
    rep = json.loads(out.read_text())
    assert rep['both_converged'] == int((res.statuses == SOLVED).sum())
    assert rep['match'] == rep['both_converged'] and rep['solver_a'] == 'PATHMCP'
