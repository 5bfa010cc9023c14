"""DGSQP v1: sequential quadratic programming for open-loop generalized Nash equilibria,
ported from ``dgsqp_tpu/solvers/dgsqp.py``: both of its machines, their chunked batch
loops, damped BFGS and game parameters.

The **flat** machine (``_round``, taken with the watchdog on and exact Hessians): each
round is one evaluate of the condensed game derivatives, one convexified QP and one grid
line search, and each game advances its own (iteration, watchdog-mode) state; the
decisions are the reference's watchdog line search flattened into modes.

The **nested** machine (``_make_body``, taken with ``nonmono_ls=False`` (the default),
``hessian_approximation='bfgs'`` or ``execution='nested'``): one SQP iteration is one
evaluate and one cold QP, then either a monotone Armijo grid line search or the watchdog
(``_watchdog``), a loop of rounds inside the iteration that runs while any game's
watchdog mode is not done.

The JAX version vmaps a per-game body under ``lax.while_loop``; here a round or an
iteration updates the whole batch at once, and every game whose status is no longer
RUNNING (or, inside the watchdog, whose mode is done) keeps its state verbatim
(``torch.where`` on each carry field).  The host interface (``set_warm_start``/``solve``/
``step``/``get_prediction``) runs the chosen machine on a batch of one; DGSQP v2 shares
it, and ``solve_batch_traced`` (which records the nested machine's iterations for v1),
through ``_HostInterface``.  Game parameters ``P`` are one value for the whole batch,
handed unchanged to every evaluation.

Status codes returned in ``SQPResult.status``:
    1 conv_abs_tol   2 conv_rel_tol   3 diverged   4 qp_fail   5 max_it   0 still-running
    6 time_limit (QP-solve budget)    7 stalled
"""
from __future__ import annotations

import math
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from dgsqp_torch.solvers.chunked import run_chunked_compacted
from dgsqp_torch.solvers.game_problem import GameProblem
from dgsqp_torch.solvers.qp import solve_qp
from dgsqp_torch.solvers.solver_types import DGSQPParams
from dgsqp_torch.types import VehiclePrediction, VehicleState
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


class _Carry(NamedTuple):
    """Per-game state of the nested SQP machine (leading batch dim)."""
    u: torch.Tensor
    l: torch.Tensor
    it: torch.Tensor
    status: torch.Tensor
    rel_its: torch.Tensor
    qp_solves: torch.Tensor
    p_feas: torch.Tensor
    comp: torch.Tensor
    stat: torch.Tensor
    stat_best: torch.Tensor  # best stationarity seen (stagnation escape)
    stall: torch.Tensor      # consecutive iterations without 1% stat improvement
    B: torch.Tensor          # BFGS Hessian approximation ((B, 0, 0) with exact Hessians)
    B_u: torch.Tensor        # iterate at which B was last updated


class _WatchdogCarry(NamedTuple):
    """Per-game state of the nested watchdog's mode machine."""
    mode: torch.Tensor
    t: torch.Tensor
    u_cur: torch.Tensor
    l_cur: torch.Tensor
    s_pred: torch.Tensor     # predicted slack at u_cur (for the A/B merit check)
    u_prev: torch.Tensor     # last point before the most recent relaxed full step
    l_prev: torch.Tensor
    u_out: torch.Tensor
    l_out: torch.Tensor
    qp_n: torch.Tensor


# nested watchdog modes: checking the latest relaxed full step, the two insurance rounds,
# the fallback line search along the iteration's step, done
WD_AB, WD_INS2, WD_INS3, WD_FB, WD_DONE = 0, 2, 3, 4, 5


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


def _sel_tree(mask, new, old):
    """Per-game select of every field of two carries of one NamedTuple type."""
    return type(old)(*[_sel(mask, n, o) for n, o in zip(new, old)])


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


class _HostInterface:
    """What DGSQP v1 and v2 share: the host interface around a batch-of-one solve
    (``set_warm_start``/``step``/``get_prediction``; each solver has its own ``solve``)
    and the per-round trace of a solver with a ``_make_body``/``_init_carry``/
    ``_finalize`` surface."""

    def _init_host_state(self):
        self.q_pred = np.zeros((self.N + 1, self.n_q))
        self.u_pred = np.zeros((self.N, self.n_u))
        self.l_pred = np.zeros(self.n_c)
        self.u_ws = np.zeros(self.N * self.n_u)
        self.l_ws = None
        self.u_prev = np.zeros(self.n_u)
        self.state_input_predictions = [VehiclePrediction() for _ in range(self.M)]

    def solve_batch_traced(self, u0, l0, x0, up, P=None, num_iters: Optional[int] = None,
                           record_iterates: bool = False, record_conds: bool = False):
        """Batched solve with a trace of every iteration of the solver's ``_make_body``
        (a nested SQP iteration of v1, a round of v2), for a fixed ``num_iters``.

        Returns ``(SQPResult, trace)`` where ``trace`` is a dict of (B, T) tensors:
        ``status, it, p_feas, comp, stat, qp_solves, du_norm, dl_norm`` (+ ``u, l`` of
        shape (B, T, n) with ``record_iterates``; + ``cond_Q, cond_G`` with
        ``record_conds``).  Frozen games repeat their terminal row.
        """
        T = int(num_iters or self.params.sqp_iters)
        body = self._make_body(x0, up, P)
        c = self._init_carry(u0, l0, x0, up, P)
        recs = []
        for _ in range(T):
            c2 = body(c)
            rec = dict(status=c2.status, it=c2.it, p_feas=c2.p_feas, comp=c2.comp,
                       stat=c2.stat, qp_solves=c2.qp_solves,
                       du_norm=torch.linalg.vector_norm(c2.u - c.u, dim=-1),
                       dl_norm=torch.linalg.vector_norm(c2.l - c.l, dim=-1))
            if record_iterates:
                rec['u'] = c2.u
                rec['l'] = c2.l
            if record_conds:
                out = self._eval_full(c2.u, c2.l, x0, up, P)
                for name, mat in (('cond_Q', out[0]), ('cond_G', out[2])):
                    sv = torch.linalg.svdvals(mat)
                    rec[name] = sv[:, 0] / torch.clamp(sv[:, -1], min=1e-300)
            recs.append(rec)
            c = c2
        trace = {k: torch.stack([r[k] for r in recs], dim=1) for k in recs[0]}
        return self._finalize(c, x0, up, P), trace

    def initialize(self):
        pass

    def set_warm_start(self, u_ws: np.ndarray, l_ws: Optional[np.ndarray] = None):
        """Accepts an (N, n_u) stage-ordered warm start, stores the agent-stacked flat
        vector."""
        u_ws = np.asarray(u_ws)
        if u_ws.shape != (self.N, self.n_u):
            raise RuntimeError(f'Warm start shape {u_ws.shape} != {(self.N, self.n_u)}')
        parts = []
        off = 0
        for a in range(self.M):
            parts.append(u_ws[:, off:off + self.num_ua_d[a]].ravel())
            off += self.num_ua_d[a]
        self.u_ws = np.concatenate(parts)
        self.l_ws = l_ws

    def _host_batch(self, states: List[VehicleState], parameters=None):
        """The stored warm start and ``states`` as a batch of one: (u0, l0, x0, up)."""
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=self.dtype,
                                      device=self.device)[None]
        x0 = t(self.joint_dynamics.state2q(states))
        up = t(np.zeros(self.n_u))
        u0 = t(self.u_ws)
        if self.l_ws is not None:
            l0 = t(self.l_ws)
        else:
            l0 = self.problem.dual_warm_start(u0, x0, up, parameters)
        return u0, l0, x0, up

    def _host_info(self, res: SQPResult, x0, dur: float) -> dict:
        """Store the predictions of a batch-of-one result and report it."""
        self.q_pred = self.problem.rollout(res.u, x0)[0].cpu().numpy()
        self.u_pred = self.problem.u_to_stage(res.u)[0].cpu().numpy()
        self.l_pred = res.l[0].cpu().numpy()
        status = int(res.status[0])
        msg = STATUS_MSG.get(status, 'unknown')
        self.print_method(f'Solve status: {msg}')
        self.print_method(f'Solve iters: {int(res.iters[0])}')
        self.print_method(f'Solve time: {dur:.2f}')
        return dict(time=dur, num_iters=int(res.iters[0]),
                    status=(status in (CONV_ABS, CONV_REL)),
                    cond=dict(p_feas=float(res.p_feas[0]), comp=float(res.comp[0]),
                              stat=float(res.stat[0])),
                    qp_solves=int(res.qp_solves[0]), msg=msg,
                    u_sol=res.u[0].cpu().numpy(), l_sol=self.l_pred)

    def step(self, states: List[VehicleState], parameters=None):
        """MPC step: solve, apply the first input, shift the warm start."""
        info = self.solve(states, parameters)
        self.joint_dynamics.qu2state(states, None, self.u_pred[0])
        self.state_input_predictions = self.joint_dynamics.qu2prediction(
            self.state_input_predictions, self.q_pred, self.u_pred)
        for pred in self.state_input_predictions:
            pred.t = states[0].t
        self.u_prev = self.u_pred[0]
        if info['msg'] not in ('diverged', 'qp_fail'):
            u_ws = np.vstack((self.u_pred[1:], self.u_pred[-1:]))
            self.set_warm_start(u_ws)
        return info

    def get_prediction(self) -> List[VehiclePrediction]:
        return self.state_input_predictions


class DGSQP(_HostInterface):
    """Batched DGSQP v1 solver (the flat round machine or the nested machine, chosen by
    ``_use_flat`` from the parameters as in the JAX package).

    Entry points run on ``device`` (default the card) in ``dtype``; pass
    ``device='cpu'`` to run the plain CPU path.
    """

    def __init__(self, joint_dynamics, costs, agent_constraints, shared_constraints,
                 bounds, params: DGSQPParams = None, print_method=print,
                 dtype=torch.float32, device='cuda'):
        params = params or DGSQPParams()
        self.params = params
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
        self.num_ua_d = self.problem.num_ua_d

        self._init_host_state()

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
    def _eval_full(self, u, l, x0, up, P=None):
        """(Q, q, G, g, x) by whole-trajectory AD (``hessian_mode='ad'``) or from
        stage-wise derivatives (``'dp'``)."""
        evaluate = self.problem.evaluate_dp if self.params.hessian_mode == 'dp' \
            else self.problem.evaluate
        return evaluate(u, l, x0, up, P, hessian=True)

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

    def _line_search(self, enabled, u, du, l, dl, s, ds, Q, q, G, g, mu, x0, up, P=None):
        """Armijo backtracking from the merit and its slope at (u, l): ``_grid_ls``.  On
        total failure the last trial is taken (the reference returns its last trial);
        disabled games return (u, l) untouched."""
        use_l1 = self.params.merit_function == 'stat_l1'
        phi0 = _merit_phi(l, s, q, G, g, mu, use_l1)
        dphi0 = _merit_dphi(du, l, dl, s, Q, q, G, g, mu, use_l1)
        return self._grid_ls(enabled, u, du, l, dl, s, ds, phi0, dphi0, mu, x0, up, P)

    def _grid_ls(self, enabled, u, du, l, dl, s, ds, phi0, dphi0, mu, x0, up, P=None):
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
                                            l_try.reshape(nb * W, -1), rep(x0), rep(up), P)
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

    # ------------------------------------------------------------- nested machine
    def _watchdog(self, run, u_k, du_k, l_k, dl_k, s_k, ds_k, Q_k, q_k, G_k, g_k, mu,
                  x0, up, P=None):
        """Non-monotone watchdog step acceptance inside one SQP iteration, a bounded
        mode machine over rounds: WD_AB checks the latest relaxed full step (the initial
        full step and up to ``t_hat`` follow-on steps), WD_INS2/WD_INS3 are insurance QP
        + line search rounds, WD_FB is the fallback line search along the iteration's
        own step, WD_DONE ends.  Every round evaluates the Hessian and solves a cold QP
        for the whole batch; the loop runs while any game of ``run`` is not done, and a
        done game (or one outside ``run``) keeps every field and adds no QP solve.
        Returns (u_out, l_out, qp_n)."""
        p = self.params
        use_l1 = p.merit_function == 'stat_l1'
        t_hat = 5
        merit_max = 1e6

        phi_k = _merit_phi(l_k, s_k, q_k, G_k, g_k, mu, use_l1)
        dphi_k = _merit_dphi(du_k, l_k, dl_k, s_k, Q_k, q_k, G_k, g_k, mu, use_l1)
        accept_ref = phi_k + p.beta * dphi_k

        def body(c: _WatchdogCarry) -> _WatchdogCarry:
            mode = c.mode
            Q_t, q_t, G_t, g_t, _ = self._eval_full(c.u_cur, c.l_cur, x0, up, P)
            phi_cur = _merit_phi(c.l_cur, c.s_pred, q_t, G_t, g_t, mu, use_l1)

            in_ab = mode == WD_AB
            # inside the t-loop the merit_max break precedes the acceptance test; the
            # initial full step (t == 1) has no merit_max check
            over_max = in_ab & (phi_cur > merit_max) & (c.t > 1)
            accepted_ab = in_ab & (phi_cur <= accept_ref) & ~over_max
            exhausted = in_ab & (c.t >= t_hat + 1) & ~accepted_ab & ~over_max

            # one cold QP at the current point: the next relaxed step (WD_AB) or the
            # insurance step (WD_INS2/WD_INS3)
            du_t, lhat_t, qp_ok, _ = self._qp(Q_t, q_t, G_t, g_t)
            dl_t = lhat_t - c.l_cur
            s_t = torch.clamp(g_t, max=0.0)
            ds_t = g_t + _mv(G_t, du_t) - s_t
            cont = in_ab & ~accepted_ab & ~over_max & ~exhausted
            qp_used = cont | (mode == WD_INS2) | (mode == WD_INS3)
            qp_n = c.qp_n + qp_used.to(c.qp_n.dtype)

            # one line search shared by the insurance rounds and the fallback, which
            # searches along the iteration-start step with its derivatives
            fb = mode == WD_FB
            ls_en = (((mode == WD_INS2) | (mode == WD_INS3)) & qp_ok) | fb
            u_ls, l_ls, phi_ls = self._line_search(
                ls_en, _sel(fb, u_k, c.u_cur), _sel(fb, du_k, du_t), _sel(fb, l_k, c.l_cur),
                _sel(fb, dl_k, dl_t), _sel(fb, s_k, s_t), _sel(fb, ds_k, ds_t),
                _sel(fb, Q_k, Q_t), _sel(fb, q_k, q_t), _sel(fb, G_k, G_t),
                _sel(fb, g_k, g_t), mu, x0, up, P)

            # WD_AB: accepted -> done; merit blow-up -> insurance from the previous good
            # point; window exhausted -> insurance from here; else the next relaxed full
            # step, or the fallback when its QP failed
            next_mode = torch.where(accepted_ab, WD_DONE, mode)
            u_out = _sel(accepted_ab, c.u_cur, c.u_out)
            l_out = _sel(accepted_ab, c.l_cur, c.l_out)
            u_next = _sel(over_max, c.u_prev, c.u_cur)
            l_next = _sel(over_max, c.l_prev, c.l_cur)
            next_mode = torch.where(over_max | exhausted, WD_INS2, next_mode)
            next_mode = torch.where(cont & ~qp_ok, WD_FB, next_mode)
            step_ok = cont & qp_ok
            u_pv = _sel(step_ok, c.u_cur, c.u_prev)
            l_pv = _sel(step_ok, c.l_cur, c.l_prev)
            u_next = _sel(step_ok, c.u_cur + du_t, u_next)
            l_next = _sel(step_ok, lhat_t, l_next)
            s_next = _sel(step_ok, s_t + ds_t, c.s_pred)
            t_next = torch.where(step_ok, c.t + 1, c.t)

            # WD_INS2: accepted -> done; QP failure or a worse merit -> fallback; else a
            # second insurance round from the line search's point
            m2 = mode == WD_INS2
            m2_acc = m2 & qp_ok & (phi_ls <= accept_ref)
            m2_worse = m2 & qp_ok & (phi_ls > phi_k) & ~m2_acc
            m2_cont = m2 & qp_ok & ~m2_acc & ~m2_worse
            u_out = _sel(m2_acc, u_ls, u_out)
            l_out = _sel(m2_acc, l_ls, l_out)
            next_mode = torch.where(m2_acc, WD_DONE, next_mode)
            next_mode = torch.where((m2 & ~qp_ok) | m2_worse, WD_FB, next_mode)
            u_next = _sel(m2_cont, u_ls, u_next)
            l_next = _sel(m2_cont, l_ls, l_next)
            next_mode = torch.where(m2_cont, WD_INS3, next_mode)

            # WD_INS3 ends on success, else falls back; WD_FB always ends
            m3 = mode == WD_INS3
            ends_ls = (m3 & qp_ok) | fb
            u_out = _sel(ends_ls, u_ls, u_out)
            l_out = _sel(ends_ls, l_ls, l_out)
            next_mode = torch.where(ends_ls, WD_DONE, next_mode)
            next_mode = torch.where(m3 & ~qp_ok, WD_FB, next_mode)

            new = _WatchdogCarry(next_mode, t_next, u_next, l_next, s_next, u_pv, l_pv,
                                 u_out, l_out, qp_n)
            return _sel_tree(mode != WD_DONE, new, c)

        nb = u_k.shape[0]
        c = _WatchdogCarry(
            mode=torch.where(run, WD_AB, WD_DONE).to(torch.long),
            t=torch.ones(nb, dtype=torch.long, device=u_k.device),
            u_cur=u_k + du_k, l_cur=l_k + dl_k, s_pred=s_k + ds_k, u_prev=u_k, l_prev=l_k,
            u_out=u_k, l_out=l_k, qp_n=torch.zeros(nb, dtype=torch.long, device=u_k.device))
        while bool((c.mode != WD_DONE).any()):
            c = body(c)
        return c.u_out, c.l_out, c.qp_n

    def _bfgs_hessian(self, c: _Carry, x0, up, P=None):
        """Damped BFGS (Powell's damping) of the game Hessian on the gradient map
        d(u) = q + G'l at fixed l, from the last update's point B_u to u; the first
        iteration, or an update that is not finite or has no step, keeps B.  Returns
        (Q, q, G, g).  The 1e-300 guards are taken in the carry's dtype, so in float32
        they are 0, as in the JAX package."""
        q, G, g, _ = self.problem.evaluate(c.u, c.l, x0, up, P, hessian=False)
        d_now = q + _mtv(G, c.l)
        d_prev = self.problem.stationarity(c.B_u, c.l, x0, up, P)
        y = d_now - d_prev
        sv = c.u - c.B_u
        Bs = _mv(regularized_convexification(c.B, 0.0), sv)
        sBs = _dot(sv, Bs)
        sy = _dot(sv, y)
        tiny = torch.tensor(1e-300, dtype=self.dtype, device=self.device)
        theta = torch.where(sy >= 0.2 * sBs, 1.0,
                            0.8 * sBs / torch.where(torch.abs(sBs - sy) > tiny, sBs - sy,
                                                    tiny))
        r = theta[:, None] * y + (1 - theta[:, None]) * Bs
        den_s = torch.where(torch.abs(sBs) > tiny, sBs, tiny)
        B_upd = c.B - Bs[:, :, None] * Bs[:, None, :] / den_s[:, None, None] \
            + r[:, :, None] * r[:, None, :] / torch.maximum(_dot(sv, r), tiny)[:, None, None]
        first = c.it == 0
        valid = torch.isfinite(B_upd).all(-1).all(-1) & \
            (torch.linalg.vector_norm(sv, dim=-1) > 1e-14)
        return _sel(first | ~valid, c.B, B_upd), q, G, g

    def _make_body(self, x0, up, P=None):
        """One SQP iteration of the nested machine for the whole batch: the iteration
        body of the JAX package's ``_make_body``, with every game whose status is no
        longer RUNNING frozen."""
        p = self.params
        xtol, ltol = p.p_tol, p.d_tol
        rel_tol_req = 3
        use_bfgs = p.hessian_approximation == 'bfgs'

        def body(c: _Carry) -> _Carry:
            running = c.status == RUNNING
            if use_bfgs:
                Q, q, G, g = self._bfgs_hessian(c, x0, up, P)
            else:
                Q, q, G, g, _ = self._eval_full(c.u, c.l, x0, up, P)
            d = q + _mtv(G, c.l)
            if self.n_c > 0:
                p_feas = torch.clamp(torch.amax(g, dim=-1), min=0.0)
                comp = torch.amax(torch.abs(g * c.l), dim=-1)
            else:
                p_feas = comp = q.new_zeros(q.shape[0])
            stat = torch.amax(torch.abs(d), dim=-1)

            diverged = stat > 1e5
            converged = (p_feas < xtol) & (comp < ltol) & (stat < ltol)
            keep_going = running & ~diverged & ~converged

            du, lhat, qp_ok, _ = self._qp(Q, q, G, g)
            dl = lhat - c.l
            s = torch.clamp(g, max=0.0)
            ds = g + _mv(G, du) - s
            mu = _get_mu(du, c.l, dl, s, Q, q, G, g, p.merit_function)

            if p.nonmono_ls:
                # a game that does not go on runs no watchdog round: its step and QP
                # count are not used
                u_n, l_n, wd_qp = self._watchdog(keep_going, c.u, du, c.l, dl, s, ds, Q, q,
                                                 G, g, mu, x0, up, P)
                qp_add = 1 + wd_qp
            else:
                u_n, l_n, _ = self._line_search(keep_going & qp_ok, c.u, du, c.l, dl, s, ds,
                                                Q, q, G, g, mu, x0, up, P)
                qp_add = 1

            active = keep_going & qp_ok
            u_out = _sel(active, u_n, c.u)
            l_out = _sel(active, l_n, c.l)
            B_next = _sel(active, Q, c.B) if use_bfgs else c.B
            B_u_next = _sel(active, c.u, c.B_u) if use_bfgs else c.B_u

            small = (torch.linalg.vector_norm(u_out - c.u, dim=-1) < xtol / 2) & \
                    (torch.linalg.vector_norm(l_out - c.l, dim=-1) < ltol / 2)
            rel_its = torch.where(active & small, c.rel_its + 1, 0)
            conv_rel = active & (rel_its >= rel_tol_req) & (p_feas < xtol)

            it_next = c.it + active.to(c.it.dtype)
            qp_solves = c.qp_solves + torch.where(keep_going, qp_add, 0)
            # the QP-solve budget and the stagnation escape
            over_budget = qp_solves >= p.qp_solves_limit if p.qp_solves_limit is not None \
                else torch.zeros_like(running)
            improved = stat < 0.99 * c.stat_best
            stat_best = torch.where(active, torch.minimum(stat, c.stat_best), c.stat_best)
            stall = torch.where(active, torch.where(improved, 0, c.stall + 1), c.stall)
            is_stalled = stall >= p.stall_its if p.stall_its is not None \
                else torch.zeros_like(running)
            new_status = torch.full_like(c.status, RUNNING)
            for cond, code in ((is_stalled, STALLED), (over_budget, TIME_LIMIT),
                               (it_next >= p.sqp_iters, MAX_IT), (conv_rel, CONV_REL),
                               (~qp_ok, QP_FAIL), (diverged, DIVERGED),
                               (converged, CONV_ABS)):
                new_status = torch.where(cond, code, new_status)
            new = _Carry(u_out, l_out, it_next, new_status.to(torch.int32), rel_its,
                         qp_solves, p_feas, comp, stat, stat_best, stall, B_next, B_u_next)
            return _sel_tree(running, new, c)

        return body

    def _init_carry(self, u0, l0, x0, up, P=None) -> _Carry:
        dt, dev = self.dtype, self.device
        u0 = torch.as_tensor(u0, dtype=dt, device=dev)
        l0 = torch.as_tensor(l0, dtype=dt, device=dev)
        nb = u0.shape[0]

        def full(v, dtype=dt):
            return torch.full((nb,), v, dtype=dtype, device=dev)

        if self.params.hessian_approximation == 'bfgs':
            Q0 = self.problem.evaluate(u0, l0, x0, up, P, hessian=True)[0]
            B0, B_u = regularized_convexification(Q0, 0.0), u0
        else:
            B0 = torch.zeros(nb, 0, 0, dtype=dt, device=dev)
            B_u = torch.zeros(nb, 0, dtype=dt, device=dev)
        return _Carry(u=u0, l=l0, it=full(0, torch.long), status=full(RUNNING, torch.int32),
                      rel_its=full(0, torch.long), qp_solves=full(0, torch.long),
                      p_feas=full(math.inf), comp=full(math.inf), stat=full(math.inf),
                      stat_best=full(math.inf), stall=full(0, torch.long), B=B0, B_u=B_u)

    # --------------------------------------------- flattened round machine
    def _round(self, c: FlatCarry, x0, up, P=None) -> FlatCarry:
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
        Q_t, q_t, G_t, g_t, _ = self._eval_full(u_eval, l_eval, x0, up, P)
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
            _sel(is_fb, c.phi_k, phi0_23), _sel(is_fb, c.dphi_k, dphi0_23), c.mu, x0, up, P)

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
        return _sel_tree(running, new, c)

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

    def _finalize(self, c, x0, up, P=None) -> SQPResult:
        """The result of either machine's carry, with its convergence quantities
        evaluated afresh at the final iterate."""
        q, G, g, _ = self.problem.evaluate(c.u, None, x0, up, P, hessian=False)
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
                            compact: bool = True, mesh=None) -> SQPResult:
        """Batched solve as a host loop over chunks: of ``4 * chunk_iters`` rounds of the
        flat machine, with straggler compaction between chunks unless ``compact=False``;
        or of ``chunk_iters`` iterations of the nested machine at a fixed layout (the
        nested machine never compacts, as in the JAX package).  Inputs are (B, ...)
        tensors on the solver's device; the result is in the input order.
        ``last_chunk_history`` holds a dict a chunk: ``chunk``, ``running``, ``batch``
        and ``wall_s`` (and, nested, ``iters_p50`` and ``stat_p50``).  With a ``mesh``
        of several ranks (``dgsqp_torch.parallel``) the inputs are this rank's block
        and the result is the whole batch's, on every rank; the nested p50s are over
        this rank's block, so that a chunk's one collective stays the status gather."""
        history_fn = None
        if self._use_flat():
            n_steps, step = 4 * chunk_iters, lambda c, x, u_p: self._round(c, x, u_p)
            max_chunks = max_chunks or (10 * self.params.sqp_iters // n_steps + 6)
            carry = self.init_flat_carry(u0, l0)
        else:
            body = self._make_body(x0, up)
            n_steps, step = chunk_iters, lambda c, x, u_p: body(c)
            max_chunks = max_chunks or (self.params.sqp_iters // chunk_iters + 2) * 8
            carry = self._init_carry(u0, l0, x0, up)
            compact = False
            history_fn = lambda c: dict(iters_p50=float(np.median(c.it.cpu().numpy())),
                                        stat_p50=float(np.median(c.stat.cpu().numpy())))

        def chunk_fn(c, x, u_p):
            for _ in range(n_steps):
                # steps with no running game change nothing: stop early
                if not bool((c.status == RUNNING).any()):
                    break
                c = step(c, x, u_p)
            return c

        res, history = run_chunked_compacted(
            carry, x0, up, chunk_fn, final_fn=self._finalize, running_status=RUNNING,
            max_chunks=max_chunks, min_bucket=self._compact_min_bucket, verbose=verbose,
            can_compact=compact, print_method=self.print_method, history_fn=history_fn,
            mesh=mesh)
        self.last_chunk_history = history
        return res

    def _solve_core(self, u0, l0, x0, up, P=None) -> SQPResult:
        """Run the batch on the chosen machine until no game is RUNNING."""
        if self._use_flat():
            c = self.init_flat_carry(u0, l0)
            step = lambda cc: self._round(cc, x0, up, P)
        else:
            c = self._init_carry(u0, l0, x0, up, P)
            step = self._make_body(x0, up, P)
        while bool((c.status == RUNNING).any()):
            c = step(c)
        return self._finalize(c, x0, up, P)

    def solve(self, states: List[VehicleState], parameters=None):
        """One game from the stored warm start, with the game parameters
        ``parameters``: a batch of one on the chosen machine, driven until its status
        leaves RUNNING."""
        t_start = time.time()
        u0, l0, x0, up = self._host_batch(states, parameters)
        res = self._solve_core(u0, l0, x0, up, parameters)
        J = self.problem.eval_costs(res.u, x0, up, parameters)[0].cpu().numpy()
        info = self._host_info(res, x0, time.time() - t_start)
        self.print_method(str(J))
        info.update(cost=J, init=dict(u=u0[0].cpu().numpy(), l=l0[0].cpu().numpy()))
        return info
