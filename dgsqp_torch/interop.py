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
  ``TrackSplines``' ``_Spline1D`` objects on a port model's splines.
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
