"""Batched dense QP solvers (primal-dual interior point), ported from
``dgsqp_tpu/solvers/qp.py``: ``solve_qp`` (and ``solve_qp_batch``, its JAX name for a
batch), the equality-constrained ``solve_eq_qp`` (the LTV-MPC's dense backend) and the
elastic-mode ``solve_elastic_qp``.

Solves, for every game b of a batch,

    min_x  1/2 x'Q_b x + q_b'x   s.t.  A_b x <= b_b

returning the primal solution, the inequality duals ``lam >= 0`` and the slacks.  The
method is the reference's: degenerate-row lifting, Ruiz equilibration, a Mehrotra
predictor-corrector with Gondzio correctors on the reduced normal equations
``(Q + A' diag(lam/t) A) dx = rhs`` factorized by Cholesky (optionally with the
input-box rows folded in as a diagonal update and the paired state-bound rows merged),
then a top-K Schur-complement primal-dual active-set polish.

Every tensor carries the batch as its leading dimension.  The JAX version vmaps a
per-instance ``lax.while_loop``; here the loop is a Python loop over the batch in which
each game freezes once it is done or out of iterations (``torch.where`` on the still
active games) and the loop ends when none is active.  The Cholesky factorizations and
solves go through :mod:`dgsqp_torch.ops.linalg`, which launches the CUDA kernels on a
CUDA tensor.  The indefinite branch factorizes a Levenberg-shifted normal matrix with
``torch.linalg.lu_factor_ex`` (a library call in the JAX version too) and skips the polish.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dgsqp_torch.ops.linalg import cho_solve, cholesky
from dgsqp_torch.utils import profiling


class QPSolution(NamedTuple):
    x: torch.Tensor        # (B, n) primal
    lam: torch.Tensor      # (B, m) inequality duals >= 0
    t: torch.Tensor        # (B, m) slacks > 0
    ok: torch.Tensor       # (B,) bool, converged to tolerance
    iters: torch.Tensor    # (B,) int
    res: torch.Tensor      # (B,) final max KKT residual


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _mtv(M, v):
    return (M.transpose(-1, -2) @ v[..., None])[..., 0]


def _amax(v):
    return torch.amax(v, dim=-1)


def _step_length(z, dz, frac=0.99):
    """Largest alpha in (0, 1] keeping z + alpha*dz >= (1 - frac) z (fraction to the
    boundary), per game."""
    neg = dz < 0
    ratios = torch.where(neg, -z / torch.where(neg, dz, -1.0), torch.inf)
    return torch.clamp(frac * torch.amin(ratios, dim=-1), max=1.0)


def _ruiz_equilibrate(Q, A, E=None, iters: int = 3):
    """Ruiz equilibration of the KKT block matrix [[Q, A', E'], [A, 0, 0], [E, 0, 0]]:
    diagonal scalings ``(d_x, e_a)`` (plus ``e_e`` when an equality block ``E`` is
    given) giving ``Dx Q Dx``, ``Ea A Dx`` and ``Ee E Dx`` ~unit row/col inf-norms."""
    B, n = Q.shape[0], Q.shape[-1]
    blocks = [A] + ([E] if E is not None else [])
    e_rs = [torch.ones(B, Bk.shape[-2], dtype=Q.dtype, device=Q.device) for Bk in blocks]
    d_x = torch.ones(B, n, dtype=Q.dtype, device=Q.device)
    for _ in range(iters):
        Qs = Q * d_x[:, :, None] * d_x[:, None, :]
        col_norm = torch.amax(torch.abs(Qs), dim=-2)
        for Bk, e_r in zip(blocks, e_rs):
            if Bk.shape[-2]:
                col_norm = torch.maximum(col_norm, torch.amax(
                    torch.abs(Bk * e_r[:, :, None] * d_x[:, None, :]), dim=-2))
        d_x = d_x / torch.sqrt(torch.clamp(col_norm, min=1e-8))
        for i, (Bk, e_r) in enumerate(zip(blocks, e_rs)):
            if Bk.shape[-2]:
                rn = torch.amax(torch.abs(Bk * e_r[:, :, None] * d_x[:, None, :]), dim=-1)
                # all-zero rows get no scaling (the 1e-8 guard would compound over sweeps)
                e_rs[i] = e_r / torch.where(rn == 0, 1.0, torch.sqrt(torch.clamp(rn, min=1e-8)))
    return tuple([torch.clamp(d_x, 1e-6, 1e6)] + [torch.clamp(e, 1e-6, 1e6) for e in e_rs])


def solve_qp(Q, q, A, b, tol: float = 1e-8, max_iters: int = 50, scale: bool = True,
             polish_iters: int = 4, warm=None, indefinite: bool = False, box=None,
             pairs=None, correctors: int = 0) -> QPSolution:
    """Solve a batch of QPs: Q (B, n, n) SPD, q (B, n), A (B, m, n), b (B, m).

    ``indefinite=True`` accepts a symmetric indefinite ``Q``: the Newton systems use a
    Levenberg-shifted LU factorization instead of Cholesky, the iteration converges to a
    KKT point (not necessarily a global minimizer) and the active-set polish is skipped
    (its Schur machinery needs ``Q`` positive definite).

    ``warm``: optional ``(lam0, t0)`` pair of (B, m) tensors, shifted to the central path.
    ``box``: static ``(rows, cols)`` of single-nonzero rows of A, folded into the normal
    matrix diagonal.  ``pairs``: static ``(rows_plus, rows_minus)`` of rows with
    ``A[minus] = c * A[plus]``, merged into one normal-matrix row.  ``correctors``:
    Gondzio centrality correctors per IPM iteration.  All three leave the solution
    unchanged and only shorten the work, as in the JAX version.
    """
    n = q.shape[-1]
    m = b.shape[-1]
    dtype = q.dtype
    f64 = dtype == torch.float64

    if m == 0:
        L = cholesky(Q.contiguous())
        x = -cho_solve(L, q.contiguous())
        B = q.shape[0]
        empty = q.new_zeros(B, 0)
        return QPSolution(x, empty, empty, torch.ones(B, dtype=torch.bool, device=q.device),
                          torch.zeros(B, dtype=torch.long, device=q.device),
                          q.new_zeros(B))

    # degenerate (near-)zero rows: zero the row and lift b to unit scale; rows with
    # b < 0 encode genuine infeasibility and are left alone
    row_norm = _amax(torch.abs(A))
    eps_row = (1e-10 if f64 else 1e-5) * torch.clamp(_amax(row_norm), min=1.0)
    degen = (row_norm <= eps_row[:, None]) & (b >= 0)
    A = torch.where(degen[:, :, None], 0.0, A)
    b = torch.where(degen, torch.clamp(b, min=1.0), b)

    if not scale:
        return _solve_scaled(Q, q, A, b, tol, max_iters, polish_iters, warm, box, pairs,
                             correctors, indefinite)

    d_x, e_r = _ruiz_equilibrate(Q, A)
    Qs = Q * d_x[:, :, None] * d_x[:, None, :]
    As = A * e_r[:, :, None] * d_x[:, None, :]
    qs = q * d_x
    bs = b * e_r
    warm_s = None if warm is None else (warm[0] / e_r, warm[1] * e_r)
    inner = solve_qp(Qs, qs, As, bs, tol, max_iters, scale=False, polish_iters=polish_iters,
                     warm=warm_s, indefinite=indefinite, box=box, pairs=pairs,
                     correctors=correctors)
    x = inner.x * d_x
    lam = inner.lam * e_r
    # re-certify on the original data
    Ax_b = _mv(A, x) - b
    r_d = _mv(Q, x) + q + _mtv(A, lam)
    res = torch.maximum(_amax(torch.abs(r_d)),
                        torch.maximum(_amax(torch.clamp(Ax_b, min=0.0)),
                                      _amax(torch.abs(lam * Ax_b))))
    sc = 1.0 + torch.maximum(_amax(torch.abs(q)), _amax(torch.abs(b)))
    ok = (res < 1e4 * tol * sc) & torch.isfinite(res)
    t_out = torch.clamp(b - _mv(A, x), min=1e-14 if f64 else 1e-7)
    return QPSolution(x, lam, t_out, ok, inner.iters, res)


def _solve_scaled(Q, q, A, b, tol, max_iters, polish_iters, warm, box, pairs,
                  correctors, indefinite=False) -> QPSolution:
    """IPM + polish on already-equilibrated data (the ``scale=False`` body)."""
    B, n = q.shape
    m = b.shape[-1]
    dtype, dev = q.dtype, q.device
    f64 = dtype == torch.float64
    eps_floor = 1e-14 if f64 else 1e-7
    d_cap = 1e14 if f64 else 1e7
    eye_n = torch.eye(n, dtype=dtype, device=dev)

    if box is not None or pairs is not None:
        # Rows are permuted once into [general, pair+, pair-, box] order; the IPM and the
        # polish run in permuted space and duals/slacks are unpermuted on return.
        box_rows = np.asarray(box[0] if box else (), dtype=int)
        box_cols = np.asarray(box[1] if box else (), dtype=int)
        p_rows = np.asarray(pairs[0] if pairs else (), dtype=int)
        m_rows = np.asarray(pairs[1] if pairs else (), dtype=int)
        gen_rows = np.setdiff1d(np.arange(m), np.concatenate([box_rows, p_rows, m_rows]))
        perm_np = np.concatenate([gen_rows, p_rows, m_rows, box_rows])
        perm = torch.as_tensor(perm_np, device=dev)
        inv = torch.as_tensor(np.argsort(perm_np), device=dev)
        ng, npair, nbox = len(gen_rows), len(p_rows), len(box_rows)
        A = A[:, perm]
        b = b[:, perm]
        if warm is not None:
            warm = (warm[0][:, perm], warm[1][:, perm])
        A_e = A[:, :ng + npair]
        A_box = A[:, ng + 2 * npair:]
        box_v2 = A_box[:, torch.arange(nbox, device=dev),
                       torch.as_tensor(box_cols, device=dev)] ** 2
        pair_c2 = (torch.sum(A[:, ng + npair:ng + 2 * npair] ** 2, dim=-1)
                   / torch.clamp(torch.sum(A[:, ng:ng + npair] ** 2, dim=-1), min=1e-30))
        S_onehot_np = np.zeros((n, nbox))
        S_onehot_np[box_cols, np.arange(nbox)] = 1.0
        S_onehot_t = torch.as_tensor(S_onehot_np.T, dtype=dtype, device=dev)   # (nbox, n)

        def normal_matrix(d):
            w = torch.cat([d[:, :ng],
                           d[:, ng:ng + npair] + pair_c2 * d[:, ng + npair:ng + 2 * npair]],
                          dim=-1)
            K = Q + (A_e.transpose(-1, -2) * w[:, None, :]) @ A_e
            if nbox:
                K = K + torch.diag_embed((d[:, ng + 2 * npair:] * box_v2) @ S_onehot_t)
            return K

        def unperm(v):
            return v[:, inv]
    else:
        def normal_matrix(d):
            return Q + (A.transpose(-1, -2) * d[:, None, :]) @ A

        def unperm(v):
            return v

    def residuals(x, lam, t):
        r_d = _mv(Q, x) + q + _mtv(A, lam)
        r_p = _mv(A, x) + t - b
        mu = torch.sum(t * lam, dim=-1) / m
        return r_d, r_p, mu

    scale_q = 1.0 + torch.maximum(_amax(torch.abs(q)), _amax(torch.abs(b)))

    def body(x, lam, t):
        r_d, r_p, mu = residuals(x, lam, t)
        d = torch.clamp(lam / torch.clamp(t, min=eps_floor), 0.0, d_cap)
        K = normal_matrix(d)
        if indefinite:
            # indefinite Q: Levenberg-shifted LU instead of Cholesky
            shift = 1e-8 * (1.0 + torch.amax(torch.abs(K), dim=(-2, -1)))
            K = K + shift[:, None, None] * eye_n
            lu, piv, _ = torch.linalg.lu_factor_ex(K)

            def ksolve(rhs):
                return torch.linalg.lu_solve(lu, piv, rhs[..., None])[..., 0]
        else:
            # Levenberg guard keeps the factorization alive in ill-conditioned corners
            trace = torch.diagonal(K, dim1=-2, dim2=-1).sum(-1)
            K = K + (1e-12 * trace / n)[:, None, None] * eye_n
            L = cholesky(K.contiguous())

            def ksolve(rhs):
                return cho_solve(L, rhs.contiguous())

        def newton(r_c):
            rhs = -r_d - _mtv(A, d * r_p - r_c / t)
            dx = ksolve(rhs)
            dlam = d * (_mv(A, dx) + r_p) - r_c / t
            dt = -(r_c + t * dlam) / lam
            return dx, dlam, dt

        # predictor (affine scaling)
        dx_a, dlam_a, dt_a = newton(t * lam)
        a_p = _step_length(t, dt_a)
        a_d = _step_length(lam, dlam_a)
        mu_aff = torch.sum((t + a_p[:, None] * dt_a) * (lam + a_d[:, None] * dlam_a),
                           dim=-1) / m
        sigma = (mu_aff / (mu + 1e-300)) ** 3

        # corrector
        r_c = t * lam + dt_a * dlam_a - (sigma * mu)[:, None]
        dx, dlam, dt = newton(r_c)
        alpha = torch.minimum(_step_length(t, dt), _step_length(lam, dlam))

        # Gondzio centrality correctors on the same factorization
        mu_t = (sigma * mu)[:, None]
        for _ in range(correctors):
            a_try = torch.clamp(alpha + 0.1, max=1.0)[:, None]
            v = (t + a_try * dt) * (lam + a_try * dlam)
            r_c_g = r_c + (v - torch.minimum(torch.maximum(v, 0.1 * mu_t), 10.0 * mu_t))
            dx_c, dlam_c, dt_c = newton(r_c_g)
            a_c = torch.minimum(_step_length(t, dt_c), _step_length(lam, dlam_c))
            accept = a_c > alpha + 0.01
            acc = accept[:, None]
            dx = torch.where(acc, dx_c, dx)
            dlam = torch.where(acc, dlam_c, dlam)
            dt = torch.where(acc, dt_c, dt)
            r_c = torch.where(acc, r_c_g, r_c)
            alpha = torch.where(accept, a_c, alpha)

        al = alpha[:, None]
        x_n = x + al * dx
        lam_n = torch.clamp(lam + al * dlam, min=eps_floor)
        t_n = torch.clamp(t + al * dt, min=eps_floor)

        r_d_n, r_p_n, mu_n = residuals(x_n, lam_n, t_n)
        res = torch.maximum(torch.maximum(_amax(torch.abs(r_d_n)), _amax(torch.abs(r_p_n))),
                            mu_n)
        done = (res < tol * scale_q) | ~torch.isfinite(res)
        # freeze iterates on non-finite steps (treat as failed, keep last good values)
        bad = ~torch.isfinite(_amax(torch.abs(x_n)) + _amax(torch.abs(lam_n)))
        bb = bad[:, None]
        x_n = torch.where(bb, x, x_n)
        lam_n = torch.where(bb, lam, lam_n)
        t_n = torch.where(bb, t, t_n)
        return x_n, lam_n, t_n, done | bad, res

    x = q.new_zeros(B, n)
    if warm is not None:
        # central-path shift keeps the warm point strictly interior
        lam = torch.clamp(warm[0], min=0.1)
        t = torch.clamp(warm[1], min=0.1)
    else:
        t = torch.clamp(torch.abs(b), min=1.0)
        lam = torch.ones(B, m, dtype=dtype, device=dev)
    it = torch.zeros(B, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    res = torch.full((B,), torch.inf, dtype=dtype, device=dev)
    # each game freezes once done or out of iterations (the vmapped while_loop's select)
    active = ~done & (it < max_iters)
    with profiling.span('qp.ipm'):
        while profiling.read_bool(active.any(), 'ipm.active'):
            profiling.count('ipm_iters')
            x_n, lam_n, t_n, done_n, res_n = body(x, lam, t)
            act = active[:, None]
            x = torch.where(act, x_n, x)
            lam = torch.where(act, lam_n, lam)
            t = torch.where(act, t_n, t)
            it = torch.where(active, it + 1, it)
            done = torch.where(active, done_n, done)
            res = torch.where(active, res_n, res)
            active = ~done & (it < max_iters)

    if indefinite or polish_iters == 0:
        # no active-set polish; certify the IPM point
        r_d, r_p, mu = residuals(x, lam, t)
        res = torch.maximum(torch.maximum(_amax(torch.abs(r_d)), _amax(torch.abs(r_p))), mu)
        ok = (res < 1e4 * tol * scale_q) & torch.isfinite(res)
        t_out = torch.clamp(b - _mv(A, x), min=eps_floor)
        return QPSolution(x, unperm(lam), unperm(t_out), ok, it, res)

    # ---- polish: Schur-complement PDAS on the top-K candidate rows
    with profiling.span('qp.polish'):
        neg_tol = torch.full((B,), 1e-9, dtype=dtype, device=dev) if f64 \
            else 1e-4 * (1.0 + _amax(torch.abs(lam)))

        def certify(x_p, lam_p):
            Ax_b = _mv(A, x_p) - b
            r_d_p = _mv(Q, x_p) + q + _mtv(A, lam_p)
            res_p = torch.maximum(_amax(torch.abs(r_d_p)),
                                  torch.maximum(_amax(torch.clamp(Ax_b, min=0.0)),
                                                _amax(torch.abs(lam_p * Ax_b))))
            ok_p = torch.isfinite(res_p) & (torch.amin(lam_p, dim=-1) > -neg_tol)
            return torch.where(ok_p, res_p, torch.inf)

        r_d, r_p, mu = residuals(x, lam, t)
        res0 = torch.maximum(torch.maximum(_amax(torch.abs(r_d)), _amax(torch.abs(r_p))), mu)

        K = int(min(m, max(48, n // 2 + 14)))
        score = torch.maximum(lam - t, _mv(A, x) - b)
        # lax.top_k breaks ties toward the lower index: a stable descending sort does too
        cand = torch.sort(score, dim=-1, descending=True, stable=True).indices[:, :K]
        A_k = torch.gather(A, 1, cand[:, :, None].expand(B, K, n))
        b_k = torch.gather(b, 1, cand)
        act0 = (torch.gather(lam, 1, cand) > torch.gather(t, 1, cand)).to(dtype)
        pad = -(-K // 8) * 8 - K
        if pad:
            # always-inactive pad rows (0'x <= 1) scattered to the sentinel index m
            A_k = torch.cat([A_k, A_k.new_zeros(B, pad, n)], dim=1)
            b_k = torch.cat([b_k, b_k.new_ones(B, pad)], dim=1)
            cand = torch.cat([cand, cand.new_full((B, pad), m)], dim=1)
            act0 = torch.cat([act0, act0.new_zeros(B, pad)], dim=1)
            K = K + pad

        # active-set independent pieces hoisted out of the PDAS loop
        A_kT = A_k.transpose(-1, -2).contiguous()
        Lq = cholesky(Q.contiguous())
        Y = cho_solve(Lq, A_kT)                            # (B, n, K)
        S_full = A_k @ Y                                   # (B, K, K)
        xq = cho_solve(Lq, (-q).contiguous())
        r0 = _mv(A_k, xq)
        delta = 1e-12 if f64 else 1e-7
        eyeK = torch.eye(K, dtype=dtype, device=dev)

        act_k, best_x, best_lam, best_res = act0, x, lam, res0
        for _ in range(polish_iters):
            a = act_k
            Sm = a[:, :, None] * a[:, None, :] * S_full + (1.0 - a)[:, None, :] * eyeK \
                + (delta * a)[:, None, :] * eyeK
            Ls = cholesky(Sm.contiguous())
            lam_k = cho_solve(Ls, (a * (r0 - b_k)).contiguous())
            x_c = xq - _mv(Y, a * lam_k)
            # full-KKT iterative refinement (triangular solves + matvecs)
            for _r in range(2):
                e1 = -q - _mv(Q, x_c) - _mv(A_kT, a * lam_k)
                w = cho_solve(Lq, e1.contiguous())
                rhs = a * (_mv(A_k, w) + _mv(A_k, x_c) - b_k)
                dlam = cho_solve(Ls, rhs.contiguous())
                x_c = x_c + w - _mv(Y, a * dlam)
                lam_k = lam_k + dlam
            # scatter into m+1 slots and drop the sentinel slot m
            lam_c = lam.new_zeros(B, m + 1).scatter(1, cand, a * lam_k)[:, :m]
            res_c = certify(x_c, lam_c)
            better = res_c < best_res
            bt = better[:, None]
            best_x = torch.where(bt, x_c, best_x)
            best_lam = torch.where(bt, torch.clamp(lam_c, min=0.0), best_lam)
            best_res = torch.where(better, res_c, best_res)
            viol_k = _mv(A_k, x_c) - b_k
            act_k = (a * lam_k + viol_k > 0).to(dtype)

        ok = (best_res < 1e4 * tol * scale_q) & torch.isfinite(best_res)
        t_out = torch.clamp(b - _mv(A, best_x), min=eps_floor)
        return QPSolution(best_x, unperm(best_lam), unperm(t_out), ok, it, best_res)


def solve_qp_batch(Q, q, A, b, tol: float = 1e-8, max_iters: int = 50) -> QPSolution:
    """The JAX package's batched entry point: :func:`solve_qp` takes the batch
    natively."""
    return solve_qp(Q, q, A, b, tol, max_iters)


class EqQPSolution(NamedTuple):
    x: torch.Tensor        # (B, n)
    lam: torch.Tensor      # (B, m) inequality duals >= 0
    nu: torch.Tensor       # (B, me) equality duals
    ok: torch.Tensor       # (B,) bool
    iters: torch.Tensor    # (B,) int
    res: torch.Tensor      # (B,)


def _amax0(v):
    """max over the last dimension with 0 included (``jnp.max(.., initial=0.0)`` of
    non-negative values: 0 for an empty dimension)."""
    if v.shape[-1] == 0:
        return v.new_zeros(v.shape[:-1])
    return torch.clamp(_amax(v), min=0.0)


def cholesky_nan(K):
    """Cholesky factor by ``torch.linalg.cholesky_ex``, NaN where a matrix is not
    positive definite (``jnp.linalg.cholesky``'s result, with no host sync to check)."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info != 0)[..., None, None], torch.nan, L)


def solve_eq_qp(Q, q, A, b, E, d, tol: float = 1e-8, max_iters: int = 50,
                scale: bool = True) -> EqQPSolution:
    """Solve, for a batch, min 1/2 x'Qx + q'x  s.t.  Ex = d,  Ax <= b: Q (B, n, n),
    A (B, m, n), E (B, me, n).

    The same Mehrotra IPM as :func:`solve_qp` with the equality block handled by a
    Schur complement on the reduced normal matrix (two Cholesky factorizations an
    iteration, ``torch.linalg`` as ``jnp.linalg`` in the JAX version; a factor that
    fails is NaN there, and the problem then ends not ``ok``).  With ``scale=True``
    the data is Ruiz-equilibrated first and the solution and duals unscaled on return.
    """
    B, n = q.shape
    m = b.shape[-1]
    me = d.shape[-1]
    dtype, dev = q.dtype, q.device

    def scale_of(q, b, d):
        return 1.0 + torch.maximum(_amax(torch.abs(q)),
                                   torch.maximum(_amax0(torch.abs(b)), _amax0(torch.abs(d))))

    if scale:
        d_x, e_a, e_e = _ruiz_equilibrate(Q, A, E)
        inner = solve_eq_qp(Q * d_x[:, :, None] * d_x[:, None, :], q * d_x,
                            A * e_a[:, :, None] * d_x[:, None, :], b * e_a,
                            E * e_e[:, :, None] * d_x[:, None, :], d * e_e,
                            tol, max_iters, scale=False)
        x = inner.x * d_x
        lam = inner.lam * e_a
        nu = inner.nu * e_e
        # re-certify on the original data
        Ax_b = _mv(A, x) - b
        r_d = _mv(Q, x) + q + _mtv(A, lam) + _mtv(E, nu)
        res = torch.maximum(_amax(torch.abs(r_d)),
                            torch.maximum(_amax0(torch.clamp(Ax_b, min=0.0)),
                                          torch.maximum(_amax0(torch.abs(_mv(E, x) - d)),
                                                        _amax0(torch.abs(lam * Ax_b)))))
        ok = (res < 1e4 * tol * scale_of(q, b, d)) & torch.isfinite(res)
        return EqQPSolution(x, lam, nu, ok, inner.iters, res)

    mm = max(m, 1)
    eye_n = torch.eye(n, dtype=dtype, device=dev)
    eye_e = torch.eye(me, dtype=dtype, device=dev)
    Et = E.transpose(-1, -2)
    sc = scale_of(q, b, d)

    def residuals(x, lam, nu, t):
        r_d = _mv(Q, x) + q + _mtv(A, lam) + _mtv(E, nu)
        r_p = _mv(A, x) + t - b
        r_e = _mv(E, x) - d
        mu = torch.sum(t * lam, dim=-1) / mm
        return r_d, r_p, r_e, mu

    def kkt_res(r_d, r_p, r_e, mu):
        return torch.maximum(torch.maximum(_amax(torch.abs(r_d)), _amax0(torch.abs(r_p))),
                             torch.maximum(_amax0(torch.abs(r_e)), mu))

    def body(x, lam, nu, t):
        r_d, r_p, r_e, mu = residuals(x, lam, nu, t)
        dd = lam / t
        K = Q + (A.transpose(-1, -2) * dd[:, None, :]) @ A
        trace = torch.diagonal(K, dim1=-2, dim2=-1).sum(-1)
        K = K + (1e-12 * trace / n)[:, None, None] * eye_n
        L = cholesky_nan(K)
        Kinv_Et = torch.cholesky_solve(Et, L)
        Ls = cholesky_nan(E @ Kinv_Et + 1e-12 * eye_e)

        def newton(r_c):
            r1 = -r_d - _mtv(A, dd * r_p - r_c / t)
            w = torch.cholesky_solve(r1[..., None], L)[..., 0]
            dnu = torch.cholesky_solve((_mv(E, w) + r_e)[..., None], Ls)[..., 0]
            dx = w - _mv(Kinv_Et, dnu)
            dlam = dd * (_mv(A, dx) + r_p) - r_c / t
            dt = -(r_c + t * dlam) / lam
            return dx, dlam, dnu, dt

        dx_a, dlam_a, dnu_a, dt_a = newton(t * lam)
        a_p = _step_length(t, dt_a)
        a_d = _step_length(lam, dlam_a)
        mu_aff = torch.sum((t + a_p[:, None] * dt_a) * (lam + a_d[:, None] * dlam_a),
                           dim=-1) / mm
        sigma = (mu_aff / (mu + 1e-300)) ** 3

        r_c = t * lam + dt_a * dlam_a - (sigma * mu)[:, None]
        dx, dlam, dnu, dt = newton(r_c)
        al = torch.minimum(_step_length(t, dt), _step_length(lam, dlam))[:, None]

        x_n = x + al * dx
        lam_n = lam + al * dlam
        nu_n = nu + al * dnu
        t_n = t + al * dt
        res = kkt_res(*residuals(x_n, lam_n, nu_n, t_n))
        done = (res < tol * sc) | ~torch.isfinite(res)
        bad = (~torch.isfinite(_amax(torch.abs(x_n)) + _amax0(torch.abs(lam_n))))[:, None]
        return (torch.where(bad, x, x_n), torch.where(bad, lam, lam_n),
                torch.where(bad, nu, nu_n), torch.where(bad, t, t_n), done | bad[:, 0], res)

    x = q.new_zeros(B, n)
    lam = q.new_ones(B, m)
    nu = q.new_zeros(B, me)
    t = torch.clamp(torch.abs(b), min=1.0)
    it = torch.zeros(B, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    res = torch.full((B,), torch.inf, dtype=dtype, device=dev)
    active = ~done & (it < max_iters)
    while bool(active.any()):
        x_n, lam_n, nu_n, t_n, done_n, res_n = body(x, lam, nu, t)
        act = active[:, None]
        x = torch.where(act, x_n, x)
        lam = torch.where(act, lam_n, lam)
        nu = torch.where(act, nu_n, nu)
        t = torch.where(act, t_n, t)
        it = torch.where(active, it + 1, it)
        done = torch.where(active, done_n, done)
        res = torch.where(active, res_n, res)
        active = ~done & (it < max_iters)

    res = kkt_res(*residuals(x, lam, nu, t))
    ok = (res < 1e4 * tol * sc) & torch.isfinite(res)
    return EqQPSolution(x, lam, nu, ok, it, res)


def solve_elastic_qp(Q, q, A, b, eta: float = 1e3, rho: float = 1e3,
                     tol: float = 1e-8, max_iters: int = 50) -> QPSolution:
    """Elastic-mode QP, an always-feasible relaxation with slack penalties, for a batch:

        min 1/2 x'Qx + q'x + eta*1's + rho/2 s's   s.t.  Ax - s <= b,  s >= 0

    solved by :func:`solve_qp` (so by the Cholesky kernels on the card).  No solver
    calls it from its hot path, as in the JAX package; the duals returned are those of
    the original rows."""
    B, n = q.shape
    m = b.shape[-1]
    eye_m = torch.eye(m, dtype=q.dtype, device=q.device).expand(B, m, m)
    Z = q.new_zeros(B, n, m)
    Qem = torch.cat([torch.cat([Q, Z], dim=-1),
                     torch.cat([Z.transpose(-1, -2), rho * eye_m], dim=-1)], dim=-2)
    qem = torch.cat([q, q.new_full((B, m), eta)], dim=-1)
    Aem = torch.cat([torch.cat([A, -eye_m], dim=-1),
                     torch.cat([q.new_zeros(B, m, n), -eye_m], dim=-1)], dim=-2)
    bem = torch.cat([b, q.new_zeros(B, m)], dim=-1)
    sol = solve_qp(Qem, qem, Aem, bem, tol=tol, max_iters=max_iters)
    return QPSolution(sol.x[:, :n], sol.lam[:, :m], sol.t[:, :m], sol.ok, sol.iters,
                      sol.res)
