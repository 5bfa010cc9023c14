"""Port parity: the F1 comparison study (``dgsqp_torch/harness/f1_study.py``), on the CPU
in float64.

* ``f1_track_segment``: the 20 m Austin segment's length (in (19, 20.5]), widths,
  curvature and tangent angle at sampled s (past its ends, where both clip) within 1e-10
  of the JAX package's; ``f1_raceline``'s table within 1e-12, and the constants equal.
* ``run_f1_study(N=3, num_samples=1, params=f1_solver_params(3, sqp_iters=40))``, the
  JAX package's tier-1 configuration, against the JAX package's run of the same call:
  x0 within 1e-12, the status and the iteration count equal, ``u_sol`` within 1e-6.
  The JAX package's dict carries no iteration count: it is read from the JAX solver's
  batched result, captured on the way.
* ``scripts/torch_f1_study_main.py`` writes its report on the CPU.
"""
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dgsqp_tpu.harness import f1_study as jf1
from dgsqp_tpu.solvers import dgsqp_v2_frenet as jax_frenet
from dgsqp_torch.harness import f1_study as tf1

from test_torch_baselines_study import _script
from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)


def _close(out, ref, what, tol):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(out, np.float64), ref, rtol=0,
                               atol=tol * max(1.0, float(np.max(np.abs(ref)))), err_msg=what)


def test_segment_and_raceline_match_jax():
    for name in ('TRACK', 'DT', 'VL', 'VW', 'CAR_R', 'SEGMENT', 'TOL'):
        assert getattr(tf1, name) == getattr(jf1, name), name
    jt, tt = jf1.f1_track_segment(), tf1.f1_track_segment()
    assert 19.0 < tt.track_length <= 20.5
    assert tt.track_length == jt.track_length and tt.half_width == jt.half_width
    assert tt.circuit == jt.circuit is False
    s = np.linspace(-1.0, tt.track_length + 1.0, 61)
    for fn in ('curvature', 'tangent_angle', 'left_width', 'right_width'):
        _close(getattr(tt, fn)(torch.tensor(s)).numpy(), getattr(jt, fn)(jnp.asarray(s)),
               fn, 1e-10)
    _close(tf1.f1_raceline()[2], jf1.f1_raceline()[2], 'raceline', 1e-12)


def test_run_f1_study_matches_jax(monkeypatch):
    results = []

    class Recorded(jax_frenet.DGSQPV2FrenetApprox):
        """The JAX solver, keeping what its batched solve returns."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            solve = self._solve_batch_jit

            def recorded(*args):
                results.append(solve(*args))
                return results[-1]
            self._solve_batch_jit = recorded

    monkeypatch.setattr(jax_frenet, 'DGSQPV2FrenetApprox', Recorded)
    ref = jf1.run_f1_study(N=3, num_samples=1, seed=0,
                           params=jf1.f1_solver_params(3, sqp_iters=40))
    out = tf1.run_f1_study(N=3, num_samples=1, seed=0,
                           params=tf1.f1_solver_params(3, sqp_iters=40),
                           dtype=torch.float64, device='cpu')
    assert out['total'] == ref['total'] == 1
    assert out['status_counts'] == ref['status_counts']
    assert out['converged'] == ref['converged'] == 1
    np.testing.assert_array_equal(out['statuses'], np.asarray(results[-1].status))
    np.testing.assert_array_equal(out['iters'], np.asarray(results[-1].iters))
    _close(out['x0'], ref['x0'], 'x0', 1e-12)
    np.testing.assert_allclose(out['u_sol'], ref['u_sol'], rtol=0, atol=1e-6)


def test_script_writes_its_report(tmp_path, capsys):
    path = tmp_path / 'f1.json'
    _script('torch_f1_study_main').main(['--device', 'cpu', '--dtype', 'float64', '--n', '1',
                                         '--N', '3', '--sqp_iters', '2', '--out', str(path)])
    report = json.loads(path.read_text())
    assert report['N'] == 3 and report['n'] == 1
    res = report['results']['dgsqp']
    assert res['total'] == 1 and len(res['statuses']) == 1
    assert '"dgsqp"' in capsys.readouterr().out
