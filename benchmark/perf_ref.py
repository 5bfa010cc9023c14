"""The plain reference of the comparison that decides ``correct``: a game's condensed
derivatives by automatic differentiation in float64, the configured PSD projection of
its Hessian, and the normalised residuals by which the program's answers are judged.

A game is an object with ``rollout(u, x0)``, ``costs(x, u, up)`` (B, M),
``constraints(x, u, up)`` (B, n_c), ``own_block(a)`` and ``M`` (see
``configs/*_game.py``).  Games in a batch never interact, so every Jacobian is taken by
pushing one tangent through all games at once.  This module imports nothing of the
program.
"""
from __future__ import annotations

import torch
from torch.func import grad, jvp, vmap


def sel(mask, a, b):
    """Per game: ``a`` where ``mask``, else ``b``, over any trailing dimensions."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def dot(a, b):
    return (a * b).sum(-1)


def mv(M, v):
    return (M @ v[..., None])[..., 0]


def mtv(M, v):
    return (M.transpose(-1, -2) @ v[..., None])[..., 0]


def _basis(u):
    n = u.shape[-1]
    eye = torch.eye(n, dtype=u.dtype, device=u.device)
    return eye[:, None, :].expand(n, *u.shape).contiguous()


def _fwd_jac(f, u):
    """Per-game Jacobian of ``f``: (B, n) -> (B, m), as (B, m, n)."""
    cols = vmap(lambda t: jvp(f, (u,), (t,))[1])(_basis(u))
    return cols.permute(1, 2, 0)


def evaluate(game, u, l, x0, up, hessian: bool = True):
    """(Q, q, G, g) of the game at (u, l): q stacks each player's gradient of its own
    cost in its own inputs, g the constraints, G their Jacobian, and Q the game
    Hessian, whose rows of player a are the Jacobian of player a's own-input gradient
    of its cost plus l'g.  ``Q`` is None without ``hessian``."""
    M = game.M

    def parts(v):
        x = game.rollout(v, x0)
        return game.costs(x, v, up), game.constraints(x, v, up)

    J, g = parts(u)
    DJ = _fwd_jac(lambda v: parts(v)[0], u)
    G = _fwd_jac(lambda v: parts(v)[1], u)
    q = torch.cat([DJ[:, a, game.own_block(a)] for a in range(M)], dim=-1)
    if not hessian:
        return None, q, G, g

    def own_grads(v):
        out = []
        for a in range(M):
            def phi(w, a=a):
                J_w, g_w = parts(w)
                return (J_w[:, a] + (l * g_w).sum(-1)).sum()
            out.append(grad(phi)(v)[:, game.own_block(a)])
        return torch.cat(out, dim=-1)

    Q = _fwd_jac(own_grads, u)
    return Q, q, G, g


def _stationarity_fn(game, l, x0, up):
    """v -> d(v) = q + G'l: player a's rows are the gradient in its own inputs of its
    cost plus l'g, one reverse sweep a player."""
    def d_of(v):
        out = []
        for a in range(game.M):
            def phi(w, a=a):
                x = game.rollout(w, x0)
                return (game.costs(x, w, up)[:, a]
                        + (l * game.constraints(x, w, up)).sum(-1)).sum()
            out.append(grad(phi)(v)[:, game.own_block(a)])
        return torch.cat(out, dim=-1)
    return d_of


def merit_terms(game, u, l, x0, up):
    """(d, g) at (u, l): d = q + G'l and the constraints, without a Jacobian."""
    d = _stationarity_fn(game, l, x0, up)(u)
    x = game.rollout(u, x0)
    return d, game.constraints(x, u, up)


def hessian_times(game, u, l, x0, up, v, transpose: bool = False):
    """Q v (or Q'v) of the game Hessian Q = dd/du at (u, l), without forming Q."""
    d_of = _stationarity_fn(game, l, x0, up)
    if transpose:
        return torch.func.vjp(d_of, u)[1](v)[0]
    return jvp(d_of, (u,), (v,))[1]


def psd_project_ns(A, iters: int, safety: float, equilibrate: bool):
    """The configured convexification: symmetrise, optionally scale by the diagonal,
    take the PSD part (B + |B|)/2 with |B| = sign(B) B, the sign by ``iters``
    Newton-Schulz steps on B/||B||_F, add ``safety * ||P||_F`` to the diagonal and undo
    the scaling."""
    B = 0.5 * (A + A.transpose(-1, -2))
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    if equilibrate:
        diag = B.diagonal(dim1=-2, dim2=-1).abs()
        rowmax = B.abs().amax(-1)
        d = torch.clamp(torch.maximum(diag, 1e-2 * rowmax), min=1e-8).sqrt()
        B = B / d[..., :, None] / d[..., None, :]
    nrm = torch.linalg.matrix_norm(B, keepdim=True) + 1e-30
    Y = B / nrm
    S = Y
    for _ in range(iters):
        S = 1.5 * S - 0.5 * S @ S @ S
    P = 0.5 * (Y + S @ Y) * nrm
    P = 0.5 * (P + P.transpose(-1, -2))
    P = P + safety * torch.linalg.matrix_norm(P, keepdim=True) * eye
    if equilibrate:
        P = P * d[..., :, None] * d[..., None, :]
    return P


def convexify(Q, reg, conv: dict):
    """Q_hat = PSD part of Q (``conv``: iters, safety, equilibrate) + reg I; ``reg`` a
    float or a (B,) tensor."""
    P = psd_project_ns(Q, int(conv['iters']), float(conv['safety']), bool(conv['equilibrate']))
    reg = torch.as_tensor(reg, dtype=Q.dtype, device=Q.device).reshape(-1, 1, 1)
    return P + reg * torch.eye(Q.shape[-1], dtype=Q.dtype, device=Q.device)


def _amax(v):
    return v.abs().amax(-1)


def kkt_report(q, G, g, l):
    """(p_feas, comp, stat) at (u, l) as the solver reports them, with the scale of the
    terms each is made of: max(g, 0), max |g l|, max |q + G'l|."""
    Gl = (G * l[..., :, None]).sum(-2)
    p_feas = torch.clamp(g.amax(-1), min=0.0)
    comp = _amax(g * l)
    stat = _amax(q + Gl)
    scale = {'p_feas': 1.0 + _amax(g),
             'comp': 1.0 + _amax(g) * _amax(l),
             'stat': 1.0 + (q.abs() + (G.abs() * l.abs()[..., :, None]).sum(-2)).amax(-1)}
    return {'p_feas': p_feas, 'comp': comp, 'stat': stat}, scale


def qp_residual(Qh, q, G, g, x, lam):
    """Normalised KKT residual of (x, lam) for min 1/2 x'Qh x + q'x s.t. G x + g <= 0:
    the largest of stationarity, primal violation, complementarity and dual sign, each
    over the scale of its terms."""
    Qx = (Qh @ x[..., None])[..., 0]
    Gl = (G.transpose(-1, -2) @ lam[..., None])[..., 0]
    Gx = (G @ x[..., None])[..., 0]
    r = Gx + g
    s_stat = 1.0 + torch.maximum(torch.maximum(_amax(Qx), _amax(q)), _amax(Gl))
    s_prim = 1.0 + torch.maximum(_amax(Gx), _amax(g))
    stat = _amax(Qx + q + Gl) / s_stat
    prim = torch.clamp(r.amax(-1), min=0.0) / s_prim
    comp = _amax(lam * r) / (s_prim * (1.0 + _amax(lam)))
    sign = torch.clamp(-lam.amin(-1), min=0.0) / (1.0 + _amax(lam))
    return torch.maximum(torch.maximum(stat, prim), torch.maximum(comp, sign))


def rel_gap(a, b):
    """Per game: max |a - b| over the largest |b| (plus 1), for tensors of any rank."""
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    return (a - b).abs().amax(-1) / (1.0 + b.abs().amax(-1))
