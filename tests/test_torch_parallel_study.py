"""Port parity: the Monte-Carlo study sharded over ranks, on the CPU in float64.

* ``run_mc_study(n_devices=2)`` on the chicane (N=6, 8 games, seed 0, DGSQP v1 with the
  study's defaults, the JAX package's track tables), each rank a ``gloo`` process:
  statuses, iterations and QP solves equal to the JAX ``run_mc_study(n_devices=2)`` on
  the same seed, ``u_sol`` within 1e-8, on every rank; the provenance names the world
  size, the backend and each rank's device.
* ``scripts/torch_monte_carlo_main.py --devices 2 --device cpu`` writes one output,
  under the name one device gives it, with the per-game results of the one-device run.
"""
import importlib.util
import pathlib
import pickle
import sys

import numpy as np
import pytest
import torch

from dgsqp_torch import interop
from dgsqp_torch.parallel.mesh import spawn_ranks

from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, GAMES, RANKS = 6, 8, 2
TIMEOUT_S = 300.0


def _rank_study(mesh, key_pts, cum_angle):
    from dgsqp_torch.harness.mc_study import run_mc_study
    from dgsqp_torch.harness.scenarios import build_chicane_scenario
    sc = build_chicane_scenario(N=N, theta_deg=45.0)
    interop.load_track_tables(sc.track, key_pts, cum_angle)
    res = run_mc_study(sc, num_samples=GAMES, seed=0, n_devices=mesh.size,
                       dtype=torch.float64, device=str(mesh.device))
    return res


@pytest.fixture(scope='module')
def studies():
    from dgsqp_tpu.harness import mc_study as jax_mc
    from dgsqp_tpu.harness.scenarios import build_chicane_scenario as jax_chicane
    jsc = jax_chicane(N=N, theta_deg=45.0)
    res_j = jax_mc.run_mc_study(jsc, num_samples=GAMES, seed=0, n_devices=RANKS)
    out = spawn_ranks(_rank_study, RANKS, np.asarray(jsc.track._kp),
                      np.asarray(jsc.track._cum_angle), devices='cpu', timeout_s=TIMEOUT_S)
    return res_j, out


def test_sharded_study_matches_jax(studies):
    res_j, out = studies
    assert len(out) == RANKS
    for res in out:
        assert res.num_samples == GAMES and res.solver == res_j.solver == 'DGSQP'
        np.testing.assert_allclose(res.x0, np.asarray(res_j.x0), rtol=0, atol=1e-12)
        for f in ('statuses', 'iters', 'qp_solves'):
            np.testing.assert_array_equal(getattr(res, f), np.asarray(getattr(res_j, f)), f)
        np.testing.assert_allclose(res.u_sol, np.asarray(res_j.u_sol), rtol=0, atol=1e-8)
        assert np.isin(res.statuses, (1, 2)).any()
        prov = res.provenance
        assert (prov['world_size'], prov['backend']) == (RANKS, 'gloo')
        assert len(prov['rank_devices']) == RANKS and prov['dtype'] == 'float64'


def _script():
    """The study script as the module its ranks import by name."""
    spec = importlib.util.spec_from_file_location(
        'torch_monte_carlo_main', ROOT / 'scripts' / 'torch_monte_carlo_main.py')
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def test_devices_flag_writes_the_one_device_output(tmp_path):
    script = _script()
    base = ['--scenario', 'chicane', '--solver', 'dgsqp_v2', '--n', '4', '--N', '3',
            '--sqp_iters', '10', '--device', 'cpu', '--dtype', 'float64']
    one, two = tmp_path / 'one', tmp_path / 'two'
    script.main(base + ['--out', str(one)])
    script.main(base + ['--out', str(two), '--devices', str(RANKS),
                        '--rank_timeout', str(TIMEOUT_S)])
    names_1 = sorted(p.name for p in one.iterdir())
    assert sorted(p.name for p in two.iterdir()) == names_1 and len(names_1) == 2
    pkl = next(p.name for p in one.iterdir() if p.suffix == '.pkl')
    with open(one / pkl, 'rb') as f:
        res_1 = pickle.load(f)
    with open(two / pkl, 'rb') as f:
        res_2 = pickle.load(f)
    for f in ('statuses', 'iters', 'qp_solves'):
        np.testing.assert_array_equal(getattr(res_2, f), getattr(res_1, f), f)
    np.testing.assert_allclose(res_2.u_sol, res_1.u_sol, rtol=0, atol=1e-8)
    assert res_2.provenance['world_size'] == RANKS
    assert 'world_size' not in res_1.provenance
