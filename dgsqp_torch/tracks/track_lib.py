"""Track constructors, saved tracks and racelines, ported from
``dgsqp_tpu/tracks/track_lib.py``.

``StraightTrack``/``CurveTrack``/``ChicaneTrack`` are built from ``[length, radius]``
segment tables; ``get_track`` loads a saved track by name from this package's own
``track_data`` folder (``radius_and_arc_length`` and ``casadi_bspline`` files); the
raceline loaders build a ``RacelineInterpolator`` (time -> state columns, arc length ->
time) from an mpclab ``.npz`` or a TUM ``.csv`` raceline.
"""
from __future__ import annotations

import csv
import os

import numpy as np
import torch

from dgsqp_torch.tracks.base import RadiusArclengthTrack, interp
from dgsqp_torch.tracks.bspline import BSplineTrack, _cached


class StraightTrack(RadiusArclengthTrack):
    def __init__(self, length, width, slack, phase_out=False):
        if phase_out:
            cl_segs = np.array([[length, 0.0], [10.0, 0.0]])
        else:
            cl_segs = np.array([[length, 0.0]])
        super().__init__(width, slack, cl_segs)
        self.phase_out = phase_out
        self.initialize()


class CurveTrack(RadiusArclengthTrack):
    def __init__(self, enter_straight_length, curve_length, curve_swept_angle,
                 exit_straight_length, width, slack, phase_out=False, ccw=True):
        s = 1 if ccw else -1
        segs = [[enter_straight_length, 0.0],
                [curve_length, s * curve_length / curve_swept_angle],
                [exit_straight_length, 0.0]]
        if phase_out:
            segs.append([10.0, 0.0])
        super().__init__(width, slack, np.array(segs))
        self.phase_out = phase_out
        self.initialize()


class ChicaneTrack(RadiusArclengthTrack):
    def __init__(self, enter_straight_length, curve1_length, curve1_swept_angle,
                 mid_straight_length, curve2_length, curve2_swept_angle,
                 exit_straight_length, width, slack, phase_out=False, mirror=False):
        if mirror:
            s1, s2 = 1, -1
        else:
            s1, s2 = -1, 1
        segs = [[enter_straight_length, 0.0],
                [curve1_length, s1 * curve1_length / curve1_swept_angle],
                [mid_straight_length, 0.0],
                [curve2_length, s2 * curve2_length / curve2_swept_angle],
                [exit_straight_length, 0.0]]
        if phase_out:
            segs.append([10.0, 0.0])
        super().__init__(width, slack, np.array(segs))
        self.phase_out = phase_out
        self.initialize()


def get_save_folder():
    return os.path.join(os.path.dirname(__file__), 'track_data')


def get_available_tracks():
    folder = get_save_folder()
    if not os.path.isdir(folder):
        return []
    return os.listdir(folder)


def get_track(track_file: str):
    """Load a saved track by name from :func:`get_save_folder`: a
    ``radius_and_arc_length`` file gives a ``RadiusArclengthTrack``, a
    ``casadi_bspline`` file a ``BSplineTrack`` on its saved waypoints and arc lengths."""
    if not track_file.endswith('.npz'):
        track_file += '.npz'
    path = os.path.join(get_save_folder(), track_file)
    if not os.path.isfile(path):
        raise ValueError(f'Track {track_file} unavailable; looked in {get_save_folder()}')

    data = np.load(path, allow_pickle=False)
    mode = str(data['save_mode'])
    if mode == 'radius_and_arc_length':
        track = RadiusArclengthTrack()
        track.initialize(float(data['track_width']), float(data['slack']), data['cl_segs'])
    elif mode == 'casadi_bspline':
        track = BSplineTrack(np.asarray(data['xy_waypoints']),
                             np.asarray(data['left_width']),
                             np.asarray(data['right_width']),
                             s_waypoints=np.asarray(data['s_waypoints']))
    else:
        raise NotImplementedError(f'Unknown track save mode {mode}')
    return track


class RacelineInterpolator:
    """Time-parametrised raceline: ``interp(t)`` gives the state columns [x, y, psi,
    v_long, v_tran, psidot, e_psi, s, e_y] at times ``t`` and ``s2t(s)`` the time at arc
    lengths ``s``, each piecewise linear with ``jnp.interp``'s semantics (the end values
    held outside the knots).  The table is float64 on the host; a query runs in the
    query tensor's dtype and on its device."""

    def __init__(self, T: np.ndarray, mat: np.ndarray):
        self.T = np.asarray(T, dtype=np.float64)
        self.mat = np.asarray(mat, dtype=np.float64)
        self._tables = {}

    def _table(self, like):
        return _cached(self._tables, like, (self.T, self.mat.T.copy()))

    def __call__(self, t):
        T, cols = self._table(t)
        return [interp(t, T, col) for col in cols]

    def s2t(self, s):
        T, cols = self._table(s)
        return interp(s, cols[7], T)


def load_mpclab_raceline(file_path, track_name, time_scale: float = 1.0):
    """Load an mpclab ``.npz`` raceline and build its two-lap interpolator (the second
    lap's s shifted by the track length).  Returns (raceline, s2t, raceline_mat)."""
    track = get_track(track_name)
    f = np.load(file_path)
    mat = np.vstack((f['x'], f['y'], f['psi'], f['v_long'] / time_scale,
                     f['v_tran'] / time_scale, f['psidot'] / time_scale,
                     f['e_psi'], f['s'], f['e_y'])).T
    T = f['t'] * time_scale

    mat2 = mat.copy()
    mat2[:, 7] += track.track_length
    T2 = T + T[-1]
    mat_two = np.vstack((mat, mat2[1:]))
    T_two = np.append(T, T2[1:])
    raceline = RacelineInterpolator(T_two, mat_two)
    return raceline, raceline.s2t, mat


def load_tum_raceline(file_path, track_name, tenth_scale: bool = False,
                      time_scale: float = 1.0, segment=None, resample_resolution=None):
    """Load a TUM global-raceline csv (``s;x;y;psi;kappa;v;a``) and convert it to local
    coordinates on the named track: every row projected by one batched
    ``global_to_local`` (float64, host), s unwrapped across the start line.  With
    ``segment=(s0, s1)`` the raceline is resampled on that arc-length window with s
    counted from s0; otherwise it gets a second lap.  Returns (raceline, s2t, mat)."""
    track = get_track(track_name)
    size_scale = 0.1 if tenth_scale else 1.0
    rows = []
    with open(file_path, 'r') as f:
        for d in csv.reader(f, delimiter=';'):
            if '#' in d[0]:
                continue
            rows.append([float(v) for v in d])
    rows = np.asarray(rows)
    x = rows[:, 1] * size_scale
    y = rows[:, 2] * size_scale
    psi = rows[:, 3] + np.pi / 2
    v = rows[:, 5] * size_scale / time_scale
    s_raw = list(rows[:, 0] * size_scale)
    xyp = torch.as_tensor(np.stack([x, y, psi], axis=-1), dtype=torch.float64)
    sey = track.global_to_local(xyp).numpy()
    s, ey, epsi = sey[:, 0].copy(), sey[:, 1], sey[:, 2]
    # unwrap the arc coordinate across the start/finish line
    for k in range(1, len(s)):
        if s[k] < s[k - 1]:
            s[k:] += track.track_length
            break
    mat = np.stack([x, y, psi, v, np.zeros_like(x), np.zeros_like(x),
                    epsi, s, ey], axis=-1)
    T = [0.0]
    for k in range(len(s_raw) - 1):
        T.append(T[-1] + (s_raw[k + 1] - s_raw[k]) / mat[k, 3])
    T = np.array(T)

    if not resample_resolution:
        resample_resolution = int(len(s_raw) / s_raw[-1])

    if segment:
        n = int((segment[1] - segment[0]) * resample_resolution)
        Ts = np.interp(np.linspace(segment[0], segment[1], n), mat[:, 7], T)
        T_seg = Ts - Ts[0]
        mat_seg = np.stack([np.interp(Ts, T, mat[:, i]) for i in range(mat.shape[1])],
                           axis=-1)
        mat_seg[:, 7] -= segment[0]
        raceline = RacelineInterpolator(T_seg, mat_seg)
        return raceline, raceline.s2t, mat_seg

    mat2 = mat.copy()
    mat2[:, 7] += track.track_length
    T2 = T + T[-1]
    raceline = RacelineInterpolator(np.append(T, T2[1:]), np.vstack((mat, mat2[1:])))
    return raceline, raceline.s2t, mat
