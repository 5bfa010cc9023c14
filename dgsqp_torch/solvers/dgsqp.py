"""DGSQP v1: sequential quadratic programming for open-loop generalized Nash equilibria,
ported from ``dgsqp_tpu/solvers/dgsqp.py`` (the flat round machine and its chunked
batch driver).

Each round of the flat machine is one evaluate of the condensed game derivatives, one
convexified QP and one grid line search, and each game advances its own
(iteration, watchdog-mode) state; the decisions are the reference's watchdog line
search flattened into modes.  The JAX version vmaps a per-game round under
``lax.while_loop``; here a round updates the whole batch at once and every game whose
status is no longer RUNNING keeps its state verbatim (``torch.where`` on each carry
field).  The nested machine, BFGS and the host ``solve``/``step`` API are not ported.

Status codes returned in ``SQPResult.status``:
    1 conv_abs_tol   2 conv_rel_tol   3 diverged   4 qp_fail   5 max_it   0 still-running
    6 time_limit (QP-solve budget)    7 stalled
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from dgsqp_torch.solvers.chunked import run_chunked_compacted
from dgsqp_torch.solvers.game_problem import GameProblem
from dgsqp_torch.solvers.qp import solve_qp
from dgsqp_torch.solvers.solver_types import DGSQPParams
from dgsqp_torch.utils.math import regularized_convexification

(RUNNING, CONV_ABS, CONV_REL, DIVERGED, QP_FAIL, MAX_IT, TIME_LIMIT,
 STALLED) = 0, 1, 2, 3, 4, 5, 6, 7
STATUS_MSG = {CONV_ABS: 'conv_abs_tol', CONV_REL: 'conv_rel_tol', DIVERGED: 'diverged',
              QP_FAIL: 'qp_fail', MAX_IT: 'max_it', RUNNING: 'running',
              TIME_LIMIT: 'time_limit', STALLED: 'stalled'}

# flat round-machine modes
FM_STEP, FM_AB, FM_INS2, FM_INS3, FM_FB = 0, 1, 2, 3, 4


class SQPResult(NamedTuple):
    u: torch.Tensor
    l: torch.Tensor
    status: torch.Tensor      # int32 code
    iters: torch.Tensor
    qp_solves: torch.Tensor
    p_feas: torch.Tensor
    comp: torch.Tensor
    stat: torch.Tensor


class FlatCarry(NamedTuple):
    """Per-game state of the flat SQP+watchdog round machine (leading batch dim)."""
    u: torch.Tensor          # accepted iterate
    l: torch.Tensor
    it: torch.Tensor
    status: torch.Tensor
    rel_its: torch.Tensor
    qp_solves: torch.Tensor
    p_feas: torch.Tensor     # convergence quantities at the current iteration's start
    comp: torch.Tensor
    stat: torch.Tensor
    mode: torch.Tensor       # FM_* watchdog mode
    t: torch.Tensor          # watchdog relaxed-step counter
    u_cur: torch.Tensor      # current watchdog candidate
    l_cur: torch.Tensor
    s_pred: torch.Tensor     # predicted slack at u_cur (for the A/B merit check)
    u_prev: torch.Tensor     # last point before the most recent relaxed full step
    l_prev: torch.Tensor
    u_k: torch.Tensor        # iteration-start data (for the fallback line search)
    du_k: torch.Tensor
    l_k: torch.Tensor
    dl_k: torch.Tensor
    s_k: torch.Tensor
    ds_k: torch.Tensor
    mu: torch.Tensor         # iteration merit penalty
    phi_k: torch.Tensor      # merit and directional derivative at the iteration start
    dphi_k: torch.Tensor
    stat_best: torch.Tensor  # best stationarity seen (stagnation escape)
    stall: torch.Tensor      # consecutive evaluations without 1% stat improvement
    qp_lam: torch.Tensor     # previous round's QP duals/slacks (IPM warm start)
    qp_t: torch.Tensor


def _sel(mask, a, b):
    """``torch.where`` with a per-game mask broadcast over trailing dimensions."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _mtv(M, v):
    return (M.transpose(-1, -2) @ v[..., None])[..., 0]


def _merit_phi_dg(d, g, l, s, mu, use_l1: bool):
    """Merit = 1/2 ||KKT stationarity||^2 (+ mu * l1 violation), from d = q + G'l."""
    stat_norm = 0.5 * (_dot(d, d) + _dot(l, g) ** 2)
    if use_l1:
        return stat_norm + mu * torch.sum(g - s, dim=-1)
    return stat_norm


def _merit_phi(l, s, q, G, g, mu, use_l1: bool):
    return _merit_phi_dg(q + _mtv(G, l), g, l, s, mu, use_l1)


def _merit_dphi(du, l, dl, s, Q, q, G, g, mu, use_l1: bool):
    """Directional derivative of the merit along (du, dl)."""
    d = q + _mtv(G, l)
    dstat = _dot(d, _mv(Q, du) + _mtv(G, dl)) + _dot(l, g) * (_dot(l, _mv(G, du)) + _dot(dl, g))
    if use_l1:
        return dstat - mu * torch.sum(g - s, dim=-1)
    return dstat


def _get_mu(du, l, dl, s, Q, q, G, g, merit_function: str):
    """Adaptive merit penalty with a dtype-aware feasibility noise floor."""
    if merit_function == 'stat':
        return q.new_zeros(q.shape[:-1])
    constr_vio = torch.sum(g - s, dim=-1)
    d_stat = _merit_dphi(du, l, dl, s, Q, q, G, g, 0.0, use_l1=True)
    rho = 0.5
    thresh = (1e-10 if q.dtype == torch.float64 else 1e-5) * \
        (1.0 + torch.amax(torch.abs(g), dim=-1))
    mu_pos = torch.abs(d_stat) / ((1 - rho) * torch.clamp(constr_vio, min=1e-300))
    return torch.where(constr_vio > thresh, mu_pos, 0.0)


class DGSQP:
    """Batched DGSQP v1 solver (flat round machine).

    Entry points run on ``device`` (default the card) in ``dtype``; pass
    ``device='cpu'`` to run the plain CPU path.
    """

    def __init__(self, joint_dynamics, costs, agent_constraints, shared_constraints,
                 bounds, params: DGSQPParams = None, print_method=print,
                 dtype=torch.float32, device='cuda'):
        params = params or DGSQPParams()
        self.params = params
        if not self._use_flat():
            raise NotImplementedError('only the flat round machine (watchdog on, exact '
                                      'Hessians) is ported')
        if params.hessian_mode != 'ad':
            raise NotImplementedError(f"hessian_mode={params.hessian_mode!r} is not ported")
        self.device = torch.device(device)
        if self.device.type == 'cuda':
            # full-precision float32 products: the merit and KKT machinery needs them
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.dtype = dtype
        self.joint_dynamics = joint_dynamics
        self.M = joint_dynamics.n_a
        self.N = params.N
        self.print_method = (lambda s: None) if print_method is None else print_method

        self.problem = GameProblem(joint_dynamics, costs, agent_constraints,
                                   shared_constraints, bounds, params.N, dtype=dtype,
                                   device=device)
        self.n_u = self.problem.n_u
        self.n_q = self.problem.n_q
        self.n_c = self.problem.n_c_total
        self.n_dec = self.problem.n_dec

        self._qp_box = self.problem.input_box_structure() if params.qp_box_split else None
        self._qp_pairs = self.problem.state_pair_structure() if params.qp_box_split else None
        if self._qp_pairs is not None and not self._qp_pairs[0]:
            self._qp_pairs = None
        self.last_chunk_history = None

    def _use_flat(self) -> bool:
        p = self.params
        if p.execution == 'nested':
            return False
        if p.execution == 'flat':
            return True
        return p.nonmono_ls and p.hessian_approximation == 'none'

    # ------------------------------------------------------------------ pieces
    def _qp(self, Q, q, G, g, warm=None):
        p = self.params
        Qh = regularized_convexification(Q, p.reg, method=p.conv_method,
                                         ns_iters=p.conv_ns_iters,
                                         ns_safety=p.conv_ns_safety,
                                         ns_equilibrate=p.conv_ns_equil)
        sol = solve_qp(Qh, q, G, -g, tol=p.qp_tol, max_iters=p.qp_max_iters,
                       polish_iters=p.qp_polish_iters, warm=warm,
                       indefinite=(p.conv_method == 'none'), box=self._qp_box,
                       pairs=self._qp_pairs, correctors=p.qp_correctors)
        # reject a step only when it is non-finite (the reference takes whatever step
        # its QP backend returns)
        finite = torch.isfinite(sol.x).all(-1) & torch.isfinite(sol.lam).all(-1)
        return sol.x, sol.lam, finite, sol.t

    def _grid_ls(self, enabled, u, du, l, dl, s, ds, phi0, dphi0, mu, x0, up):
        """Geometric trial grid alpha = tau^j, j < line_search_iters, evaluated at once;
        the first Armijo-accepted trial wins, else the last.  Only the enabled games are
        evaluated; the others return (u, l, phi0) as they would in the full grid."""
        p = self.params
        use_l1 = p.merit_function == 'stat_l1'
        W = p.line_search_iters
        alphas = torch.tensor(p.tau, dtype=self.dtype, device=self.device) ** \
            torch.arange(W, dtype=self.dtype, device=self.device)
        u_t, l_t, phi_out = u, l, phi0
        sel = torch.nonzero(enabled).flatten()
        nb = int(sel.numel())
        if nb == 0:
            return u_t, l_t, phi_out
        a3 = alphas[None, :, None]
        u_try = u[sel][:, None] + a3 * du[sel][:, None]
        l_try = l[sel][:, None] + a3 * dl[sel][:, None]
        s_try = s[sel][:, None] + a3 * ds[sel][:, None]
        rep = lambda v: v[sel][:, None].expand(nb, W, *v.shape[1:]).reshape(nb * W, *v.shape[1:])
        d_t, g_t = self.problem.merit_terms(u_try.reshape(nb * W, -1),
                                            l_try.reshape(nb * W, -1), rep(x0), rep(up))
        phis = _merit_phi_dg(d_t, g_t, l_try.reshape(nb * W, -1), s_try.reshape(nb * W, -1),
                             rep(mu), use_l1).reshape(nb, W)
        ok = phis <= phi0[sel][:, None] + (p.beta * alphas)[None, :] * dphi0[sel][:, None]
        first = torch.argmax(ok.to(torch.uint8), dim=-1)
        idx = torch.where(ok.any(-1), first, W - 1)
        alpha_sel = alphas[idx][:, None]
        u_t = u.index_copy(0, sel, u[sel] + alpha_sel * du[sel])
        l_t = l.index_copy(0, sel, l[sel] + alpha_sel * dl[sel])
        phi_out = phi0.index_copy(0, sel, phis.gather(1, idx[:, None])[:, 0])
        return u_t, l_t, phi_out

    # --------------------------------------------- flattened round machine
    def _round(self, c: FlatCarry, x0, up) -> FlatCarry:
        """One lockstep round of the flat SQP+watchdog machine for the whole batch."""
        p = self.params
        xtol, ltol = p.p_tol, p.d_tol
        rel_tol_req = 3
        t_hat = 5
        merit_max = 1e6
        use_l1 = p.merit_function == 'stat_l1'

        running = c.status == RUNNING
        is_step = c.mode == FM_STEP
        is_ab = c.mode == FM_AB
        is_2 = c.mode == FM_INS2
        is_3 = c.mode == FM_INS3
        is_fb = c.mode == FM_FB

        u_eval = _sel(is_step, c.u, c.u_cur)
        l_eval = _sel(is_step, c.l, c.l_cur)

        # ---- the round's single evaluate + QP
        Q_t, q_t, G_t, g_t, _ = self.problem.evaluate(u_eval, l_eval, x0, up, hessian=True)
        d_t = q_t + _mtv(G_t, l_eval)
        if self.n_c > 0:
            p_feas_t = torch.clamp(torch.amax(g_t, dim=-1), min=0.0)
            comp_t = torch.amax(torch.abs(g_t * l_eval), dim=-1)
        else:
            p_feas_t = comp_t = q_t.new_zeros(q_t.shape[0])
        stat_t = torch.amax(torch.abs(d_t), dim=-1)

        warm = (c.qp_lam, c.qp_t) if p.qp_warm_start else None
        du_t, lhat_t, fin, qp_t_out = self._qp(Q_t, q_t, G_t, g_t, warm=warm)
        dl_t = lhat_t - l_eval
        s_t = torch.clamp(g_t, max=0.0)
        ds_t = g_t + _mv(G_t, du_t) - s_t

        # step-formation quantities (FM_STEP and fused FM_AB acceptance)
        mu_t = _get_mu(du_t, l_eval, dl_t, s_t, Q_t, q_t, G_t, g_t, p.merit_function)
        phi_t = _merit_phi(l_eval, s_t, q_t, G_t, g_t, mu_t, use_l1)
        dphi_t = _merit_dphi(du_t, l_eval, dl_t, s_t, Q_t, q_t, G_t, g_t, mu_t, use_l1)

        # A/B candidate merit at u_cur with the iteration's mu and predicted slack
        phi_cur = _merit_phi(l_eval, c.s_pred, q_t, G_t, g_t, c.mu, use_l1)

        # ---- the round's single grid line search
        phi0_23 = _merit_phi(l_eval, s_t, q_t, G_t, g_t, c.mu, use_l1)
        dphi0_23 = _merit_dphi(du_t, l_eval, dl_t, s_t, Q_t, q_t, G_t, g_t, c.mu, use_l1)
        ls_en = (((is_2 | is_3) & fin) | is_fb) & running
        u_ls, l_ls, phi_ls = self._grid_ls(
            ls_en, _sel(is_fb, c.u_k, u_eval), _sel(is_fb, c.du_k, du_t),
            _sel(is_fb, c.l_k, l_eval), _sel(is_fb, c.dl_k, dl_t),
            _sel(is_fb, c.s_k, s_t), _sel(is_fb, c.ds_k, ds_t),
            _sel(is_fb, c.phi_k, phi0_23), _sel(is_fb, c.dphi_k, dphi0_23), c.mu, x0, up)

        # ---------------- decisions
        accept_ref = c.phi_k + p.beta * c.dphi_k
        over_max = is_ab & (phi_cur > merit_max) & (c.t > 1)
        accepted = is_ab & (phi_cur <= accept_ref) & ~over_max
        exhausted = is_ab & ~accepted & ~over_max & (c.t >= t_hat + 1)
        cont = is_ab & ~accepted & ~over_max & ~exhausted

        m2_fail = is_2 & ~fin
        m2_acc = is_2 & fin & (phi_ls <= accept_ref)
        m2_worse = is_2 & fin & (phi_ls > c.phi_k) & ~m2_acc
        m2_cont = is_2 & fin & ~m2_acc & ~m2_worse
        m3_fail = is_3 & ~fin
        m3_done = is_3 & fin

        # ---------------- iteration completion (install the new iterate)
        complete = accepted | m2_acc | m3_done | is_fb
        via_ls = m2_acc | m3_done | is_fb
        u_new = _sel(accepted, u_eval, _sel(via_ls, u_ls, c.u))
        l_new = _sel(accepted, l_eval, _sel(via_ls, l_ls, c.l))

        small = (torch.linalg.vector_norm(u_new - c.u, dim=-1) < xtol / 2) & \
                (torch.linalg.vector_norm(l_new - c.l, dim=-1) < ltol / 2)
        rel_its = torch.where(complete, torch.where(small, c.rel_its + 1, 0), c.rel_its)
        conv_rel = complete & (rel_its >= rel_tol_req) & (c.p_feas < xtol)
        it_new = c.it + complete.to(c.it.dtype)

        # ---------------- status cascade
        status = c.status
        diverged_t = stat_t > 1e5
        converged_t = (p_feas_t < xtol) & (comp_t < ltol) & (stat_t < ltol)
        step_term = is_step & (converged_t | diverged_t)
        status = torch.where(is_step & converged_t, CONV_ABS, status)
        status = torch.where(is_step & diverged_t & ~converged_t, DIVERGED, status)
        step_qp_fail = is_step & ~step_term & ~fin
        status = torch.where(step_qp_fail, QP_FAIL, status)
        step_go = is_step & ~step_term & ~step_qp_fail

        over_it = it_new >= p.sqp_iters
        status = torch.where(complete & conv_rel, CONV_REL, status)
        status = torch.where(complete & ~conv_rel & over_it, MAX_IT, status)

        acc_go0 = accepted & ~conv_rel & ~over_it
        status = torch.where(acc_go0 & converged_t, CONV_ABS, status)
        status = torch.where(acc_go0 & diverged_t & ~converged_t, DIVERGED, status)
        acc_body = acc_go0 & ~converged_t & ~diverged_t
        status = torch.where(acc_body & ~fin, QP_FAIL, status)
        acc_go = acc_body & fin

        qp_inc = (is_step & ~step_term) | acc_body | cont | is_2 | is_3
        qp_solves = c.qp_solves + qp_inc.to(c.qp_solves.dtype)
        if p.qp_solves_limit is not None:
            over_budget = complete & (status == RUNNING) & (qp_solves >= p.qp_solves_limit)
            status = torch.where(over_budget, TIME_LIMIT, status)

        upd_stall = is_step | accepted
        improved = stat_t < 0.99 * c.stat_best
        stat_best = torch.where(upd_stall, torch.minimum(stat_t, c.stat_best), c.stat_best)
        stall = torch.where(upd_stall, torch.where(improved, 0, c.stall + 1), c.stall)
        if p.stall_its is not None:
            status = torch.where((status == RUNNING) & (stall >= p.stall_its), STALLED, status)

        # ---------------- carry updates
        form = step_go | acc_go
        advance = form | (cont & fin)

        u_k = _sel(form, u_eval, c.u_k)
        du_k = _sel(form, du_t, c.du_k)
        l_k = _sel(form, l_eval, c.l_k)
        dl_k = _sel(form, dl_t, c.dl_k)
        s_k = _sel(form, s_t, c.s_k)
        ds_k = _sel(form, ds_t, c.ds_k)
        mu_n = torch.where(form, mu_t, c.mu)
        phi_k = torch.where(form, phi_t, c.phi_k)
        dphi_k = torch.where(form, dphi_t, c.dphi_k)

        u_prev = _sel(advance, u_eval, c.u_prev)
        l_prev = _sel(advance, l_eval, c.l_prev)
        u_cur = _sel(advance, u_eval + du_t,
                     _sel(over_max, c.u_prev, _sel(m2_cont, u_ls, c.u_cur)))
        l_cur = _sel(advance, lhat_t,
                     _sel(over_max, c.l_prev, _sel(m2_cont, l_ls, c.l_cur)))
        s_pred = _sel(advance, s_t + ds_t, c.s_pred)
        t_n = torch.where(form, 1, torch.where(cont & fin, c.t + 1, c.t))

        mode = c.mode
        mode = torch.where(form, FM_AB, mode)
        mode = torch.where(cont & ~fin, FM_FB, mode)
        mode = torch.where(over_max | exhausted, FM_INS2, mode)
        mode = torch.where(m2_fail | m2_worse | m3_fail, FM_FB, mode)
        mode = torch.where(m2_cont, FM_INS3, mode)
        mode = torch.where(via_ls, FM_STEP, mode)

        u_out = _sel(complete, u_new, c.u)
        l_out = _sel(complete, l_new, c.l)

        upd = is_step | accepted
        p_feas_n = torch.where(upd, p_feas_t, c.p_feas)
        comp_n = torch.where(upd, comp_t, c.comp)
        stat_n = torch.where(upd, stat_t, c.stat)

        # the warm-start carry only advances on finite QP results
        qp_lam_n = _sel(fin, lhat_t, c.qp_lam)
        qp_t_n = _sel(fin, qp_t_out, c.qp_t)
        new = FlatCarry(u_out, l_out, it_new, status.to(torch.int32), rel_its,
                        qp_solves, p_feas_n, comp_n, stat_n, mode, t_n,
                        u_cur, l_cur, s_pred, u_prev, l_prev,
                        u_k, du_k, l_k, dl_k, s_k, ds_k, mu_n, phi_k, dphi_k,
                        stat_best, stall, qp_lam_n, qp_t_n)
        # frozen games keep their state verbatim
        return FlatCarry(*[_sel(running, n, o) for n, o in zip(new, c)])

    def init_flat_carry(self, u0, l0) -> FlatCarry:
        dt, dev = self.dtype, self.device
        u0 = torch.as_tensor(u0, dtype=dt, device=dev)
        l0 = torch.as_tensor(l0, dtype=dt, device=dev)
        B = u0.shape[0]

        def full(v, dtype=dt):
            return torch.full((B,), v, dtype=dtype, device=dev)

        zc = torch.zeros(B, self.n_c, dtype=dt, device=dev)
        return FlatCarry(u=u0, l=l0, it=full(0, torch.long),
                         status=full(RUNNING, torch.int32), rel_its=full(0, torch.long),
                         qp_solves=full(0, torch.long), p_feas=full(math.inf),
                         comp=full(math.inf), stat=full(math.inf),
                         mode=full(FM_STEP, torch.long), t=full(1, torch.long),
                         u_cur=u0, l_cur=l0, s_pred=zc, u_prev=u0, l_prev=l0,
                         u_k=u0, du_k=torch.zeros_like(u0), l_k=l0,
                         dl_k=torch.zeros_like(l0), s_k=zc, ds_k=zc,
                         mu=full(0.0), phi_k=full(0.0), dphi_k=full(0.0),
                         stat_best=full(math.inf), stall=full(0, torch.long),
                         qp_lam=torch.ones_like(zc), qp_t=torch.ones_like(zc))

    def finalize(self, c: FlatCarry, x0, up) -> SQPResult:
        q, G, g, _ = self.problem.evaluate(c.u, None, x0, up, hessian=False)
        d = q + _mtv(G, c.l)
        if self.n_c > 0:
            p_feas = torch.clamp(torch.amax(g, dim=-1), min=0.0)
            comp = torch.amax(torch.abs(g * c.l), dim=-1)
        else:
            p_feas = comp = q.new_zeros(q.shape[0])
        stat = torch.amax(torch.abs(d), dim=-1)
        return SQPResult(c.u, c.l, c.status, c.it, c.qp_solves, p_feas, comp, stat)

    _compact_min_bucket = 16

    def solve_batch_chunked(self, u0, l0, x0, up, chunk_iters: int = 8,
                            max_chunks: Optional[int] = None, verbose: bool = False,
                            compact: bool = True) -> SQPResult:
        """Batched solve as a host loop over chunks of ``4 * chunk_iters`` rounds, with
        straggler compaction between chunks unless ``compact=False``.  Inputs are
        (B, ...) tensors on the solver's device; the result is in the input order."""
        flat_rounds = 4 * chunk_iters

        def chunk_fn(c, x, u_p):
            for _ in range(flat_rounds):
                # rounds with no running game change nothing: stop early
                if not bool((c.status == RUNNING).any()):
                    break
                c = self._round(c, x, u_p)
            return c

        max_chunks = max_chunks or (10 * self.params.sqp_iters // flat_rounds + 6)
        carry = self.init_flat_carry(u0, l0)
        res, history = run_chunked_compacted(
            carry, x0, up, chunk_fn, final_fn=self.finalize, running_status=RUNNING,
            max_chunks=max_chunks, min_bucket=self._compact_min_bucket, verbose=verbose,
            can_compact=compact, print_method=self.print_method)
        self.last_chunk_history = history
        return res
