"""Small numeric helpers, ported from ``dgsqp_tpu/utils/math.py``.

Every function works on tensors with any leading batch dimensions.
"""
from __future__ import annotations

import math

import torch


def smooth_abs(x, eps: float = 1e-3):
    """Smooth positive approximation of ``|x|``."""
    return torch.sqrt(x * x + eps * eps)


def hard_abs(x):
    """Exact ``|x|``."""
    return torch.abs(x)


def smooth_sign(x, eps: float = 1e-3):
    """Smooth approximation of ``sign(x)``."""
    return x / smooth_abs(x, eps)


def resistance(v, c_da: float, c_dr: float, c_r: float, p_r: float):
    """The bicycles' longitudinal resistance ``-c_da v - c_dr v|v| - c_r |v|^p_r
    smooth_sign(v)`` (damping, drag, rolling).

    A term whose coefficient is zero is left out: it is identically zero, and costs
    tensor operations in every sub-step of a rollout.  At v = 0 the rolling term's
    derivative holds ``|v|^(p_r - 1)``: the JAX package's is NaN there even at p_r = 0,
    so with ``c_r = 0`` the port's derivative is the zero limit where JAX's is NaN.
    Returns the float 0.0 when every coefficient is zero.
    """
    f = 0.0
    if c_da:
        f = f - c_da * v
    if c_dr:
        f = f - c_dr * v * hard_abs(v)
    if c_r:
        f = f - c_r * hard_abs(v) ** p_r * smooth_sign(v)
    return f


def wrap_angle(theta):
    """Wrap an angle to (-pi, pi]."""
    return torch.where(theta < -math.pi, theta + 2 * math.pi,
                       torch.where(theta > math.pi, theta - 2 * math.pi, theta))


def _eye_like(A):
    return torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)


def eigh_or_nan(B):
    """``torch.linalg.eigh`` of a batch of symmetric matrices, with NaN eigenvalues and
    eigenvectors for a matrix it cannot decompose (a NaN entry, or an iteration that
    does not converge, as the card's batched solver can in float32), as the JAX
    package's ``eigh`` gives, where ``torch.linalg.eigh`` raises for the whole batch.
    A failed batch is split in halves until the failing matrices stand alone."""
    try:
        return torch.linalg.eigh(B)
    except torch.linalg.LinAlgError:
        if B.dim() == 2 or B.shape[0] == 1:
            return (torch.full(B.shape[:-1], float('nan'), dtype=B.dtype, device=B.device),
                    torch.full_like(B, float('nan')))
        if B.dim() > 3:
            s, U = eigh_or_nan(B.reshape(-1, *B.shape[-2:]))
            return s.reshape(B.shape[:-1]), U.reshape(B.shape)
        h = B.shape[0] // 2
        (s0, U0), (s1, U1) = eigh_or_nan(B[:h]), eigh_or_nan(B[h:])
        return torch.cat([s0, s1]), torch.cat([U0, U1])


def nearest_pd(A, min_eig: float = 1e-10):
    """Project a square matrix onto the PSD cone by eigenvalue clipping: symmetrize,
    eigendecompose, clip negative eigenvalues to ``min_eig``, re-symmetrize (NaN for a
    matrix the eigendecomposition fails on, as in the JAX package)."""
    B = 0.5 * (A + A.transpose(-1, -2))
    s, U = eigh_or_nan(B)
    s = torch.where(s < 0, torch.full_like(s, min_eig), s)
    C = (U * s[..., None, :]) @ U.transpose(-1, -2)
    return 0.5 * (C + C.transpose(-1, -2))


def regularized_convexification(A, reg: float, min_eig: float = 1e-10,
                                method: str = 'eigh', ns_iters: int = 14,
                                ns_safety: float = 1e-3, ns_equilibrate: bool = False):
    """``nearest_pd(A) + reg*I``; ``method='ns'`` projects by Newton-Schulz
    (:func:`nearest_pd_ns`), ``method='none'`` only symmetrizes."""
    if method == 'none':
        Q = 0.5 * (A + A.transpose(-1, -2))
    elif method == 'ns':
        Q = nearest_pd_ns(A, iters=ns_iters, safety=ns_safety, equilibrate=ns_equilibrate)
    else:
        Q = nearest_pd(A, min_eig)
    if reg > 0:
        Q = Q + reg * _eye_like(A)
    return Q


def nearest_pd_ns(A, iters: int = 14, safety: float = 1e-3, equilibrate: bool = False):
    """PSD projection via a Newton-Schulz matrix-sign iteration, matmuls only.

    For symmetric B, ``clip(eigvals, 0)`` equals ``(B + |B|)/2`` with ``|B| = sign(B) B``.
    A relative diagonal shift ``safety * ||P||_F`` covers the iteration's residual
    negative eigenvalues.  ``equilibrate`` applies a symmetric Jacobi scaling first and
    undoes it after (a congruence, so the result stays PSD).
    """
    B = 0.5 * (A + A.transpose(-1, -2))
    eye = _eye_like(A)
    if equilibrate:
        diag = torch.abs(torch.diagonal(B, dim1=-2, dim2=-1))
        rowmax = torch.amax(torch.abs(B), dim=-1)
        d = torch.sqrt(torch.clamp(torch.maximum(diag, 1e-2 * rowmax), min=1e-8))
        dinv = 1.0 / d
        B = B * dinv[..., :, None] * dinv[..., None, :]
    nrm = torch.sqrt(torch.sum(B * B, dim=(-2, -1), keepdim=True)) + 1e-30
    Y = B / nrm
    S = Y
    for _ in range(iters):
        S = 1.5 * S - 0.5 * (S @ S) @ S
    absY = S @ Y
    P = 0.5 * (Y + absY) * nrm
    P = 0.5 * (P + P.transpose(-1, -2))
    shift = safety * torch.sqrt(torch.sum(P * P, dim=(-2, -1), keepdim=True))
    P = P + shift * eye
    if equilibrate:
        P = P * d[..., :, None] * d[..., None, :]
    return P
