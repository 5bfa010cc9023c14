"""State carried across from the JAX package, as numpy arrays, into the port's tensors.

The system has no weights; what crosses over is numeric state.  Every function takes
numpy arrays (or anything ``np.asarray`` accepts, such as a JAX array handed over by
the caller) and never imports JAX, so both packages can compute on bit-identical inputs:

* :func:`load_track_tables` installs a track's key-point table and cumulative-angle
  table (``RadiusArclengthTrack._kp`` / ``_cum_angle`` in the JAX package);
* :func:`bench_batch` converts a bench batch ``(u0, l0, x0, up)``;
* :func:`to_torch_tuple` converts a result NamedTuple (a ``QPSolution`` or an
  ``SQPResult``) field by field into the port's NamedTuple of the same fields.
"""
from __future__ import annotations

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
