"""State carried across from the JAX package, as numpy arrays, into the port's tensors.

The system has no weights; what crosses over is numeric state.  Every function takes
numpy arrays (or anything ``np.asarray`` accepts, such as a JAX array handed over by
the caller) and never imports JAX, so both packages can compute on bit-identical inputs:

* :func:`load_track_tables` installs a track's key-point table and cumulative-angle
  table (``RadiusArclengthTrack._kp`` / ``_cum_angle`` in the JAX package);
* :func:`bench_batch` converts a bench batch ``(u0, l0, x0, up)``;
* :func:`to_torch_tuple` converts a NamedTuple of arrays (a ``QPSolution``, an
  ``SQPResult``, a solver carry such as ``_CarryV2``) field by field into the port's
  NamedTuple of the same fields;
* :func:`fields_to_numpy` gives the fields of a NamedTuple or dataclass of either
  package (a carry, an ``MCResults``) as numpy arrays, for comparisons;
* :func:`to_mc_results` converts an ``MCResults`` into the port's dataclass;
* :func:`mpcc_params` converts the approximate game's parameter pytree (the JAX
  ``_evaluate_mpcc`` output, a dict of per-agent lists, stacked over the games) into the
  port's batched ``P``;
* :func:`load_track_splines` installs the knots and coefficients of the JAX
  ``TrackSplines``' ``_Spline1D`` objects on a port model's splines;
* :func:`vehicle_state` copies a ``VehicleState`` (of either package) field by field
  into the port's ``VehicleState``;
* :func:`mpc_state` carries a ``CA_LTV_MPC``'s host state (warm starts, the last input,
  the predictions, the delay buffers) and :func:`race_state` a ``RaceStack``'s (both
  trackers, the planner's warm start, the game references and the trigger's flag) into
  the port's objects, so that both packages can continue from the same mid-race state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def to_tensor(a, dtype=torch.float64, device='cuda'):
    """One array as a tensor; integer and boolean arrays keep an integer/bool dtype."""
    arr = np.array(a)
    if arr.dtype.kind in 'biu':
        return torch.as_tensor(arr, device=device)
    return torch.as_tensor(arr, dtype=dtype, device=device)


def load_track_tables(track, key_pts, cum_angle):
    """Install a key-point table (n_segs+1, 6) and cumulative-angle table on a port
    track, replacing what its constructor computed."""
    track.set_tables(np.asarray(key_pts, dtype=np.float64),
                     np.asarray(cum_angle, dtype=np.float64))
    return track


def bench_batch(u0, l0, x0, up, dtype=torch.float64, device='cuda'):
    """A bench batch ``(u0, l0, x0, up)`` as tensors."""
    return tuple(to_tensor(a, dtype, device) for a in (u0, l0, x0, up))


def to_torch_tuple(result, cls, dtype=torch.float64, device='cuda'):
    """A NamedTuple of arrays (``QPSolution``, ``SQPResult``) as ``cls`` of tensors."""
    return cls(*[to_tensor(getattr(result, f), dtype, device) for f in cls._fields])


def fields_to_numpy(obj) -> dict:
    """The fields of a NamedTuple or dataclass as a dict; tensors and arrays become
    numpy arrays, everything else (strings, numbers, dicts) is passed through."""
    names = obj._fields if hasattr(obj, '_fields') \
        else [f.name for f in dataclasses.fields(obj)]
    out = {}
    for name in names:
        v = getattr(obj, name)
        if torch.is_tensor(v):
            v = v.detach().cpu().numpy()
        elif hasattr(v, 'shape'):
            v = np.asarray(v)
        out[name] = v
    return out


def to_mc_results(results, cls):
    """An ``MCResults`` of the JAX package as the port's ``cls``, field by field."""
    src = fields_to_numpy(results)
    return cls(**{f.name: src[f.name] for f in dataclasses.fields(cls)})


def mpcc_params(P, dtype=torch.float64, device='cuda'):
    """An approximate-game parameter pytree ``{'Qe', 'qe', 'Gtb', 'gtb'}`` of per-agent
    (B, N+1, ...) arrays (the games' pytrees stacked, as ``vmap`` gives them) as the
    port's ``P`` of tensors in the same layout."""
    return {key: [to_tensor(a, dtype, device) for a in P[key]]
            for key in ('Qe', 'qe', 'Gtb', 'gtb')}


def load_track_splines(splines, src):
    """Install the six splines of ``src`` (an object with attributes x, y, xi, yi, xo,
    yo, each with numpy-convertible ``knots`` and ``coeffs``, such as the JAX
    ``TrackSplines``) on the port's ``TrackSplines`` ``splines``."""
    from dgsqp_torch.dynamics.progress_augmented import SPLINE_NAMES
    from dgsqp_torch.tracks.bspline import _Spline1D
    splines.set_splines({
        name: _Spline1D(np.asarray(getattr(src, name).knots, np.float64),
                        coeffs=np.asarray(getattr(src, name).coeffs, np.float64))
        for name in SPLINE_NAMES})
    return splines


def vehicle_state(src, cls=None):
    """A ``VehicleState`` (or any message dataclass) copied field by field into the
    port's class of the same name."""
    from dgsqp_torch import types
    cls = cls or getattr(types, type(src).__name__)
    kw = {}
    for f in dataclasses.fields(src):
        v = getattr(src, f.name)
        if dataclasses.is_dataclass(v):
            v = vehicle_state(v)
        elif hasattr(v, 'shape'):
            v = np.array(v)
        kw[f.name] = v
    return cls(**kw)


_MPC_FIELDS = ('u_ws', 'du_ws', 'u_prev', 'q_pred', 'u_pred', 'du_pred')


def mpc_state(src, dst=None) -> dict:
    """The host state of a ``CA_LTV_MPC`` (or such a state, a dict) as numpy arrays
    (and its time and delay buffers); installed into the port's ``dst`` when one is
    given."""
    if isinstance(src, dict):
        state = src
    else:
        state = {name: np.array(getattr(src, name), dtype=np.float64)
                 for name in _MPC_FIELDS}
        state['t'] = src.t
        state['delay_buffer'] = None if src.delay_buffer is None \
            else [list(buf) for buf in src.delay_buffer]
    if dst is not None:
        for name in _MPC_FIELDS:
            setattr(dst, name, state[name].copy())
        dst.t = state['t']
        if state['delay_buffer'] is not None:
            for buf, vals in zip(dst.delay_buffer, state['delay_buffer']):
                buf.clear()
                buf.extend(vals)
    return state


def race_state(src, dst=None) -> dict:
    """The state of a ``RaceStack`` between control steps (or such a state, a dict):
    both trackers' :func:`mpc_state`, the planner's warm start, the game references
    ``(t_grid, q_ref, s_lim)`` per car and the trigger's ``solve_game``; installed
    into the port's ``dst`` when one is given."""
    if isinstance(src, dict):
        state = src
    else:
        state = dict(
            trackers=[mpc_state(mpc) for mpc in src.trackers],
            planner_u_ws=np.array(src.planner.u_ws, dtype=np.float64),
            planner_l_ws=None if src.planner.l_ws is None
            else np.array(src.planner.l_ws, dtype=np.float64),
            game_refs=[None if ref is None else
                       (np.array(ref[0], np.float64), np.array(ref[1], np.float64),
                        (float(ref[2][0]), float(ref[2][1]))) for ref in src.game_refs],
            solve_game=bool(src.solve_game))
    if dst is not None:
        for mpc, mpc_dst in zip(state['trackers'], dst.trackers):
            mpc_state(mpc, mpc_dst)
        dst.planner.u_ws = state['planner_u_ws'].copy()
        dst.planner.l_ws = None if state['planner_l_ws'] is None \
            else state['planner_l_ws'].copy()
        dst.game_refs = list(state['game_refs'])
        dst.solve_game = state['solve_game']
    return state
