"""Stage-structured OCP-QP solver, ported from ``dgsqp_tpu/solvers/ocp_qp.py``: an
interior point whose Newton systems are eliminated by a backward Riccati recursion.

For every problem of a batch it solves

    min  sum_k 1/2 [x_k; v_k]' [[Qx_k, S_k'], [S_k, Rv_k]] [x_k; v_k] + qx_k'x_k + rv_k'v_k
    s.t. x_{k+1} = A_k x_k + B_k v_k + g_k,      k = 0..N-1        (x_0 given)
         D_k x_k + E_k v_k <= b_k,               k = 0..N          (E_N ignored)

with a primal-dual Mehrotra IPM.  The barrier terms of the stage-local inequalities only
thicken the per-stage cost blocks, so each Newton step is one backward Riccati pass and
one forward rollout: O(N (nx + nv)^3) work an iteration.

Every tensor carries the batch as its leading dimension and the stage as its second.
The JAX version's ``lax.scan`` over stages is a Python loop over stages here, each
stage's work batched over the problems; its ``lax.while_loop`` is a loop in which each
problem freezes once it is done or out of iterations, with one host sync an iteration.
The stage factorizations are ``torch.linalg.cholesky_ex`` with a failed factor made NaN
(``jnp.linalg.cholesky``'s result), so a problem whose stage block is not positive
definite ends with a non-finite residual and ``ok = False``, as in the JAX version.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from dgsqp_torch.solvers.qp import cholesky_nan


class OCPQPSolution(NamedTuple):
    x: torch.Tensor        # (B, N+1, nx) states
    v: torch.Tensor        # (B, N, nv) inputs
    lam: torch.Tensor      # (B, N+1, mi) inequality duals >= 0
    ok: torch.Tensor       # (B,) bool
    iters: torch.Tensor    # (B,) int
    res: torch.Tensor      # (B,)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _mtv(M, v):
    return (M.transpose(-1, -2) @ v[..., None])[..., 0]


def _lqr_solve(A, B, g, Qx, S, Rv, qx, rv, x0):
    """Equality-constrained LQR by a backward Riccati pass and a forward rollout.

    Shapes (leading batch b): A (b,N,nx,nx), B (b,N,nx,nv), g (b,N,nx), Qx (b,N+1,nx,nx),
    S (b,N,nv,nx), Rv (b,N,nv,nv), qx (b,N+1,nx), rv (b,N,nv), x0 (b,nx).  Returns
    (x (b,N+1,nx), v (b,N,nv)).
    """
    N = A.shape[1]
    P, p = Qx[:, N], qx[:, N]
    Ks, kffs = [None] * N, [None] * N
    for k in range(N - 1, -1, -1):
        A_k, B_k, g_k = A[:, k], B[:, k], g[:, k]
        Bt = B_k.transpose(-1, -2)
        PA = P @ A_k
        PB = P @ B_k
        H_vv = Rv[:, k] + Bt @ PB
        H_vx = S[:, k] + Bt @ PA
        Pg_p = _mv(P, g_k) + p
        h_v = rv[:, k] + _mv(Bt, Pg_p)
        L = cholesky_nan(H_vv)
        K = -torch.cholesky_solve(H_vx, L)        # v = K x + kff
        kff = -torch.cholesky_solve(h_v[..., None], L)[..., 0]
        H_vxT = H_vx.transpose(-1, -2)
        P_new = Qx[:, k] + A_k.transpose(-1, -2) @ PA + H_vxT @ K
        P = 0.5 * (P_new + P_new.transpose(-1, -2))
        p = qx[:, k] + _mtv(A_k, Pg_p) + _mv(H_vxT, kff)
        Ks[k], kffs[k] = K, kff

    xs, vs = [x0], []
    x = x0
    for k in range(N):
        v_k = _mv(Ks[k], x) + kffs[k]
        x = _mv(A[:, k], x) + _mv(B[:, k], v_k) + g[:, k]
        xs.append(x)
        vs.append(v_k)
    return torch.stack(xs, dim=1), torch.stack(vs, dim=1)


def _ein_mdm(M1, d, M2):
    """Per stage M1_k' diag(d_k) M2_k: (b,K,i,j), (b,K,i), (b,K,i,l) -> (b,K,j,l)."""
    return (M1.transpose(-1, -2) * d[..., None, :]) @ M2


def solve_ocp_qp(A, B, g, Qx, S, Rv, qx, rv, D, E, b, x0, tol: float = 1e-8,
                 max_iters: int = 30) -> OCPQPSolution:
    """Primal-dual IPM over the stage-local inequalities with Riccati Newton solves.

    ``D (b, N+1, mi, nx)``, ``E (b, N+1, mi, nv)`` (stage N's E is ignored: the
    terminal stage has no input), ``b (b, N+1, mi)``.  Vacuous rows can be padded with
    D = E = 0, b >= 1.
    """
    Bt_, N = A.shape[0], A.shape[1]
    nv = B.shape[-1]
    mi = b.shape[-1]
    dtype, dev = x0.dtype, x0.device
    eps_floor = 1e-14 if dtype == torch.float64 else 1e-7
    n_ineq = mi * (N + 1)

    E = E.clone()
    E[:, N] = 0.0

    # degenerate (all-zero) rows: lift b to keep the barrier well defined
    row_norm = torch.maximum(torch.amax(torch.abs(D), dim=-1), torch.amax(torch.abs(E), dim=-1))
    degen = (row_norm <= 1e-12) & (b >= 0)
    b = torch.where(degen, torch.clamp(b, min=1.0), b)
    E_ = E[:, :-1]
    zero_v = x0.new_zeros(Bt_, 1, nv)

    def residuals(x, v, lam, t):
        v_pad = torch.cat([v, zero_v], dim=1)
        r_p = _mv(D, x) + _mv(E, v_pad) + t - b
        mu = torch.sum(t * lam, dim=(1, 2)) / n_ineq
        return r_p, mu

    def grad_lagrangian(x, v, lam):
        """Stage gradients of the Lagrangian in (x, v) without the dynamics
        multipliers: the Newton right-hand side in augmented form."""
        gx = _mv(Qx, x) + qx + _mtv(D, lam)
        gx = torch.cat([gx[:, :-1] + _mtv(S, v), gx[:, -1:]], dim=1)
        gv = _mv(Rv, v) + rv + _mv(S, x[:, :-1]) + _mtv(E_, lam[:, :-1])
        return gx, gv

    def step_len(z, dz):
        neg = dz < 0
        ratios = torch.where(neg, -z / torch.where(neg, dz, -1.0), torch.inf)
        return torch.clamp(0.99 * torch.amin(ratios, dim=(1, 2)), max=1.0)

    scale = 1.0 + torch.amax(torch.abs(b), dim=(1, 2))
    zerog = torch.zeros_like(g)
    zerox0 = torch.zeros_like(x0)

    def body(x, v, lam, t):
        r_p, mu = residuals(x, v, lam, t)
        d = torch.clamp(lam / torch.clamp(t, min=eps_floor), 0.0, 1e7)
        t_f = torch.clamp(t, min=eps_floor)

        # barrier-augmented stage blocks; the Newton solve is the Riccati recursion on
        # the homogeneous dynamics (the iterates stay dynamics-consistent)
        Qx_a = Qx + _ein_mdm(D, d, D)
        Rv_a = Rv + _ein_mdm(E_, d[:, :-1], E_)
        S_a = S + _ein_mdm(E_, d[:, :-1], D[:, :-1])
        gx, gv = grad_lagrangian(x, v, lam)

        def newton_step(r_c):
            w = d * r_p - r_c / t_f
            qx_a = gx + _mtv(D, w)
            rv_a = gv + _mtv(E_, w[:, :-1])
            dx_all, dv = _lqr_solve(A, B, zerog, Qx_a, S_a, Rv_a, qx_a, rv_a, zerox0)
            dv_pad = torch.cat([dv, zero_v], dim=1)
            dDEz = _mv(D, dx_all) + _mv(E, dv_pad)
            dlam = d * (dDEz + r_p) - r_c / t_f
            dt = -(r_c + t * dlam) / torch.clamp(lam, min=eps_floor)
            return dx_all, dv, dlam, dt

        # predictor (affine scaling)
        dx_a, dv_a, dlam_a, dt_a = newton_step(t * lam)
        a_p = step_len(t, dt_a)[:, None, None]
        a_d = step_len(lam, dlam_a)[:, None, None]
        mu_aff = torch.sum((t + a_p * dt_a) * (lam + a_d * dlam_a), dim=(1, 2)) / n_ineq
        sigma = (mu_aff / (mu + 1e-300)) ** 3
        # corrector
        r_c = t * lam + dt_a * dlam_a - (sigma * mu)[:, None, None]
        dx, dv, dlam, dt = newton_step(r_c)
        alpha = torch.minimum(step_len(t, dt), step_len(lam, dlam))[:, None, None]

        x_n = x + alpha * dx
        v_n = v + alpha * dv
        lam_n = torch.clamp(lam + alpha * dlam, min=eps_floor)
        t_n = torch.clamp(t + alpha * dt, min=eps_floor)

        r_p_n, mu_n = residuals(x_n, v_n, lam_n, t_n)
        res = torch.maximum(torch.amax(torch.abs(r_p_n), dim=(1, 2)), mu_n)
        done = (res < tol * scale) | ~torch.isfinite(res)
        bad = ~torch.isfinite(torch.amax(torch.abs(x_n), dim=(1, 2))
                              + torch.amax(torch.abs(v_n), dim=(1, 2)))
        bb = bad[:, None, None]
        return (torch.where(bb, x, x_n), torch.where(bb, v, v_n), lam_n, t_n, done | bad,
                res)

    # strictly feasible-ish start: the dynamics-consistent rollout from x0 with v = 0
    xs = [x0]
    for k in range(N):
        xs.append(_mv(A[:, k], xs[-1]) + g[:, k])
    x = torch.stack(xs, dim=1)
    v = x0.new_zeros(Bt_, N, nv)
    ones = x0.new_ones(Bt_, N + 1, mi)
    r_p0, _ = residuals(x, v, ones, ones)
    t = torch.clamp(torch.abs(r_p0) + 1.0, min=1.0)
    lam = ones

    it = torch.zeros(Bt_, dtype=torch.long, device=dev)
    done = torch.zeros(Bt_, dtype=torch.bool, device=dev)
    res = torch.full((Bt_,), torch.inf, dtype=dtype, device=dev)
    active = ~done & (it < max_iters)
    while bool(active.any()):
        x_n, v_n, lam_n, t_n, done_n, res_n = body(x, v, lam, t)
        act = active[:, None, None]
        x = torch.where(act, x_n, x)
        v = torch.where(act, v_n, v)
        lam = torch.where(act, lam_n, lam)
        t = torch.where(act, t_n, t)
        it = torch.where(active, it + 1, it)
        done = torch.where(active, done_n, done)
        res = torch.where(active, res_n, res)
        active = ~done & (it < max_iters)

    # certification: primal feasibility, complementarity and dynamics consistency
    r_p, mu = residuals(x, v, lam, t)
    viol = torch.amax(torch.clamp(r_p - t, min=0.0) + torch.abs(torch.clamp(t, max=0.0)),
                      dim=(1, 2))
    dyn = x[:, 1:] - (_mv(A, x[:, :-1]) + _mv(B, v) + g)
    res = torch.maximum(torch.amax(torch.abs(dyn), dim=(1, 2)), torch.maximum(viol, mu))
    ok = (res < 1e4 * tol * scale) & torch.isfinite(res)
    return OCPQPSolution(x, v, lam, ok, it, res)
