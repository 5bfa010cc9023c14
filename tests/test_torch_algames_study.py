"""Port parity: ``run_mc_study_algames`` on the CPU in float64.

On the chicane duel at N=4 (4 games, seed 0), the
study's default ALGAMES parameters: the same x0 (1e-12), statuses, outer iterations and
``qp_solves`` (the Newton solves) as the JAX study, ``u_sol`` (stage-major) of the
converged games within 1e-6, and ``analyze_results``' counts.  The port's study is the
one ``scripts/torch_monte_carlo_main.py --solver algames --device cpu`` writes (float64
by default).
"""
import json
import pickle

import numpy as np

from dgsqp_tpu.harness import mc_study as jax_mc
from dgsqp_tpu.harness.scenarios import build_chicane_scenario as jax_chicane
from dgsqp_torch.harness import mc_study
from dgsqp_torch.solvers.algames import CONV_ABS, CONV_REL

from test_torch_baselines_study import _script
from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

N, GAMES = 4, 4


def test_algames_study_matches_jax(tmp_path, capsys):
    jsc = jax_chicane(N=N, theta_deg=45.0)
    res_j = jax_mc.run_mc_study_algames(jsc, num_samples=GAMES, seed=0)
    # the port's study runs once, through the script (the port's chicane key-point tables
    # equal the JAX package's: test_torch_tracks_dynamics.py)
    _script('torch_monte_carlo_main').main(
        ['--scenario', 'chicane', '--solver', 'algames', '--n', str(GAMES), '--N', str(N),
         '--device', 'cpu', '--out', str(tmp_path)])
    printed = json.loads(capsys.readouterr().out)
    assert printed['solver'] == 'ALGAMES' and printed['provenance']['dtype'] == 'float64'
    with open(tmp_path / f'chicane_t45_N{N}_algames_exact_n{GAMES}_s0.pkl', 'rb') as f:
        res_t = pickle.load(f)
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
