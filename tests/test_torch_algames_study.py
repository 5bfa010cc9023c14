"""Port parity: ``run_mc_study_algames`` on the CPU in float64.

On the chicane duel at N=4 (4 games, seed 0, the JAX package's track tables), the
study's default ALGAMES parameters: the same x0 (1e-12), statuses, outer iterations and
``qp_solves`` (the Newton solves) as the JAX study, ``u_sol`` (stage-major) of the
converged games within 1e-6, and ``analyze_results``' counts.  ``scripts/
torch_monte_carlo_main.py --solver algames --device cpu`` writes a float64 ALGAMES
study of the same games with the same statuses.
"""
import json
import pickle

import numpy as np
import torch

from dgsqp_tpu.harness import mc_study as jax_mc
from dgsqp_tpu.harness.scenarios import build_chicane_scenario as jax_chicane
from dgsqp_torch import interop
from dgsqp_torch.harness import mc_study
from dgsqp_torch.harness.scenarios import build_chicane_scenario
from dgsqp_torch.solvers.algames import CONV_ABS, CONV_REL

from test_torch_baselines_study import _script

N, GAMES = 4, 4


def test_algames_study_matches_jax(tmp_path, capsys):
    jsc, sc = jax_chicane(N=N, theta_deg=45.0), build_chicane_scenario(N=N, theta_deg=45.0)
    interop.load_track_tables(sc.track, np.asarray(jsc.track._kp),
                              np.asarray(jsc.track._cum_angle))
    res_j = jax_mc.run_mc_study_algames(jsc, num_samples=GAMES, seed=0)
    res_t = mc_study.run_mc_study_algames(sc, num_samples=GAMES, seed=0,
                                          dtype=torch.float64, device='cpu')
    assert (res_t.scenario, res_t.solver, res_t.num_samples) == \
        (res_j.scenario, 'ALGAMES', GAMES)
    np.testing.assert_allclose(res_t.x0, np.asarray(res_j.x0), rtol=0, atol=1e-12)
    for f in ('statuses', 'iters', 'qp_solves'):
        np.testing.assert_array_equal(getattr(res_t, f), np.asarray(getattr(res_j, f)), f)
    conv = np.isin(res_t.statuses, (CONV_ABS, CONV_REL))
    assert conv.any() and res_t.u_sol.shape == (GAMES, N * 4)
    np.testing.assert_allclose(res_t.u_sol[conv], np.asarray(res_j.u_sol)[conv], rtol=0,
                               atol=1e-6)
    stats_t, stats_j = mc_study.analyze_results(res_t), jax_mc.analyze_results(res_j)
    for k in ('total', 'converged', 'success_rate', 'max_iters', 'mean_qp_solves',
              'status_counts'):
        assert stats_t[k] == stats_j[k], k
    assert res_t.provenance['solver_class'] == 'ALGAMES'
    assert res_t.provenance['dtype'] == 'float64'

    _script('torch_monte_carlo_main').main(
        ['--scenario', 'chicane', '--solver', 'algames', '--n', str(GAMES), '--N', str(N),
         '--device', 'cpu', '--out', str(tmp_path)])
    printed = json.loads(capsys.readouterr().out)
    assert printed['solver'] == 'ALGAMES' and printed['provenance']['dtype'] == 'float64'
    with open(tmp_path / f'chicane_t45_N{N}_algames_exact_n{GAMES}_s0.pkl', 'rb') as f:
        res_s = pickle.load(f)
    np.testing.assert_array_equal(res_s.statuses, res_t.statuses)
