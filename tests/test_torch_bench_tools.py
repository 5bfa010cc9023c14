"""CPU rehearsals of the port's bench tooling at tiny sizes (``--device cpu``), each
through the script's own ``main``:

* ``scripts/torch_retry_probe.py``: the base configuration's solve of the bench draw
  and the four variants' re-solves of failed games (here the first two games stand in
  for the failures: at N=5 every game converges);
* ``scripts/torch_profile_batch_scaling.py``: every operation timed at one batch size;
* ``scripts/torch_bench_parting.py``: the four layouts of the bench solve (one width,
  compaction, two ranks over gloo, the ranks' blocks alone); on the CPU in float32 no
  game's iterate differs by a bit between them.
"""
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
N, BATCH = 5, 4


def _script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / 'scripts' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_retry_probe_rehearsal(tmp_path, capsys):
    probe = _script('torch_retry_probe')
    out = tmp_path / 'probe.json'
    probe.main(['--device', 'cpu', '--dtype', 'float64', '--batch', str(BATCH),
                '--horizon', str(N), '--out', str(out)])
    rec = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert (rec['batch'], rec['horizon'], rec['device']) == (BATCH, N, 'cpu')
    assert len(rec['base']['status_string']) == BATCH
    assert rec['base']['failures'] == round((1 - rec['base']['conv_abs']) * BATCH)

    from dgsqp_torch.harness.samplers import sample_duel_initial_conditions
    from dgsqp_torch.harness.scenarios import build_chicane_scenario
    sc = build_chicane_scenario(N=N, theta_deg=45.0)
    base, variants = probe.build_solvers(sc, torch.float64, 'cpu')
    assert list(variants) == ['v1 reg=1e-2', 'v1 reg=1e-1', 'v1 merit=stat', 'v2 max']
    assert base.params.qp_tol == 1e-8 and base.params.reg == 1e-3
    x0, u_ws, _, _ = sample_duel_initial_conditions(sc, BATCH, seed=0,
                                                    dtype=torch.float64, device='cpu')
    u0 = base.problem.stage_to_u(torch.as_tensor(u_ws))
    x0 = torch.as_tensor(x0)
    up = torch.zeros(BATCH, sc.joint_model.n_u, dtype=torch.float64)
    l0 = base.problem.dual_warm_start(u0, x0, up)
    fail = np.array([0, 1])
    got = probe.probe_variants(variants, (u0, l0, x0, up), fail)
    assert list(got) == list(variants)
    for name, v in got.items():
        assert v['of'] == 2 and 0 <= v['rescued'] <= 2, name
        assert set(v['rescued_games']) <= {0, 1} and len(v['rescued_games']) == v['rescued']


def test_profile_batch_scaling_rehearsal(tmp_path):
    prof = _script('torch_profile_batch_scaling')
    out = tmp_path / 'scaling.json'
    prof.main(['--device', 'cpu', '--batches', str(BATCH), '--horizon', str(N), '--reps',
               '1', '--out', str(out)])
    rec = json.loads(out.read_text())
    assert (rec['card'], rec['batches'], rec['horizon']) == ('cpu', [BATCH], N)
    ops = rec['ops'][str(BATCH)]
    assert list(ops) == ['evaluate(+Q)', 'conv eigh', 'conv ns', 'qp it25', 'qp it12',
                         'merit grid 20', 'flat round']
    for name, v in ops.items():
        assert v['ms'] > 0 and not v['graph'], name
        assert v['us_per_game'] == pytest.approx(v['ms'] * 1e3 / BATCH), name


def test_bench_parting_rehearsal(tmp_path):
    """On the CPU the bench solve's layouts agree to the bit, the ranks' run included."""
    # the ranks are spawned processes: they import the script's rank function by name
    sys.path.insert(0, str(ROOT / 'scripts'))
    try:
        parting = importlib.import_module('torch_bench_parting')
        out = tmp_path / 'parting.json'
        parting.main(['--device', 'cpu', '--batch', str(BATCH), '--horizon', str(N),
                      '--out', str(out)])
    finally:
        sys.path.remove(str(ROOT / 'scripts'))
    rec = json.loads(out.read_text())
    assert set(rec['status_string']) == set(parting.LAYOUTS)
    assert rec['widths'] == {'fixed': [BATCH], 'compacted': [BATCH],
                             'sharded': [BATCH // 2], 'blocks': [BATCH // 2]}
    assert len(rec['pairs']) == 6
    for pair, v in rec['pairs'].items():
        assert v['agree'] == BATCH and v['games_parted'] == 0 and not v['flips'], pair
