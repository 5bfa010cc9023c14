"""Port parity: saved tracks and racelines (``dgsqp_torch/tracks/track_lib.py``), on
the CPU in float64.

* ``get_track`` in both save modes (``L_track_barc``: ``radius_and_arc_length``;
  ``f1_austin_tenth_scale``: ``casadi_bspline``) gives the JAX package's track: length
  and widths equal, curvature, tangent angle, left/right width and ``local_to_global``
  at sampled s (across the start line) and ``global_to_local`` of those points within
  1e-10.
* ``RacelineInterpolator`` and its ``s2t``, from ``load_mpclab_raceline`` (the dynamic
  study's, two laps) and ``load_tum_raceline`` (whole, and on the F1 study's segment),
  match the JAX package's tables to 1e-12 and its ``jnp.interp`` inside and outside the
  knots (the end values held) to 1e-12.
* The port's data files are byte-equal to the JAX package's, and the port reads its own.
"""
import filecmp
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dgsqp_tpu.harness import dynamic_study as jds
from dgsqp_tpu.harness import f1_study as jf1
from dgsqp_tpu.tracks import track_lib as jtl
from dgsqp_torch.harness import dynamic_study as tds
from dgsqp_torch.harness import f1_study as tf1
from dgsqp_torch.tracks import track_lib as ttl

from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
DATA = [('tracks/track_data/L_track_barc.npz'), ('tracks/track_data/f1_austin_tenth_scale.npz'),
        ('harness/data/L_track_barc_raceline.npz'), ('harness/data/traj_race_cl.csv')]
TOL = 1e-10


def _close(out, ref, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(out, np.float64), np.asarray(ref, np.float64),
                               rtol=0, atol=tol * max(1.0, float(np.max(np.abs(ref)))),
                               err_msg=what)


@pytest.mark.parametrize('name', ['L_track_barc', 'f1_austin_tenth_scale'])
def test_get_track_matches_jax(name):
    jt, tt = jtl.get_track(name), ttl.get_track(name)
    assert type(tt).__name__ == type(jt).__name__
    assert tt.track_length == jt.track_length and tt.half_width == jt.half_width
    L = tt.track_length
    s = np.concatenate([np.linspace(-1.0, L + 1.0, 57), [0.0, L]])
    st = torch.tensor(s)
    for fn in ('curvature', 'tangent_angle', 'left_width', 'right_width'):
        _close(getattr(tt, fn)(st).numpy(), getattr(jt, fn)(jnp.asarray(s)), f'{name}.{fn}')
    rng = np.random.default_rng(5)
    cl = np.column_stack([rng.uniform(0.1, L - 0.1, 40), rng.uniform(-0.3, 0.3, 40),
                          rng.uniform(-0.4, 0.4, 40)])
    xy_t = tt.local_to_global(torch.tensor(cl)).numpy()
    _close(xy_t, jt.local_to_global(jnp.asarray(cl)), f'{name}.local_to_global')
    _close(tt.global_to_local(torch.tensor(xy_t)).numpy(), jt.global_to_local(jnp.asarray(xy_t)),
           f'{name}.global_to_local')


def _interp_both(jr, tr, T, s_col):
    """Both raceline interpolators at times and arc lengths inside and outside the knots."""
    t = np.concatenate([np.linspace(T[0] - 1.0, T[-1] + 1.0, 97), T[[0, 5, -1]]])
    s = np.concatenate([np.linspace(s_col[0] - 1.0, s_col[-1] + 1.0, 97), s_col[[0, 5, -1]]])
    for a, b in zip(tr(torch.tensor(t)), jr(jnp.asarray(t))):
        _close(a.numpy(), b, 'raceline(t)', 1e-12)
    _close(tr.s2t(torch.tensor(s)).numpy(), jr.s2t(jnp.asarray(s)), 's2t', 1e-12)


def test_mpclab_raceline_matches_jax():
    jr, js2t, jmat = jds.ltrack_raceline()
    tr, ts2t, tmat = tds.ltrack_raceline()
    _close(tmat, jmat, 'raceline mat', 1e-12)
    _close(tr.T, jr.T, 'two-lap T', 1e-12)
    _close(tr.mat, jr.mat, 'two-lap mat', 1e-12)
    _interp_both(jr, tr, jr.T, jr.mat[:, 7])
    # bound methods of the same interpolator
    assert ts2t.__self__ is tr


@pytest.mark.parametrize('segment', [None, list(tf1.SEGMENT)])
def test_tum_raceline_matches_jax(segment):
    csv = ROOT / 'dgsqp_torch' / 'harness' / 'data' / 'traj_race_cl.csv'
    jr, _, jmat = jtl.load_tum_raceline(str(csv), tf1.TRACK, tenth_scale=True, segment=segment)
    tr, _, tmat = ttl.load_tum_raceline(csv, tf1.TRACK, tenth_scale=True, segment=segment)
    assert tmat.shape == jmat.shape
    _close(tmat, jmat, 'tum mat')
    _close(tr.T, jr.T, 'tum T')
    _interp_both(jr, tr, jr.T, jr.mat[:, 7])
    if segment:
        # the study's own loader: s counted from the segment's start
        assert tf1.f1_raceline()[2][0, 7] < 1.0


def test_data_files_are_the_jax_packages():
    for rel in DATA:
        ours = ROOT / 'dgsqp_torch' / rel
        assert filecmp.cmp(ours, ROOT / 'dgsqp_tpu' / rel, shallow=False), rel
    assert Path(ttl.get_save_folder()) == ROOT / 'dgsqp_torch' / 'tracks' / 'track_data'
    assert sorted(ttl.get_available_tracks()) == ['L_track_barc.npz',
                                                  'f1_austin_tenth_scale.npz']
    with pytest.raises(ValueError):
        ttl.get_track('no_such_track')
    assert jf1.TRACK == tf1.TRACK and jf1.SEGMENT == tf1.SEGMENT
