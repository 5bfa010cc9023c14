"""DGSQP v2: the journal algorithm with non-monotone (NMS) globalization, ported from
``dgsqp_tpu/solvers/dgsqp_v2.py``.

What v2 changes against v1 (``dgsqp.py``):

  * merit = 1/2 ||stacked Lagrangian gradient||^2 + mu * sum(max(0, g)) with the slack
    taken as s = max(0, g), and no complementarity term;
  * the symmetrized Hessian ``(Q + Q')/2`` goes to the QP;
  * the regularization rides in the carry and decays ``reg *= reg_decay`` on every
    m-step, with checkpoint save and restore;
  * the NMS step machine: cheap d-steps (the full SQP step is accepted while its norm
    is below a trust quantity ``delta`` that shrinks by ``delta_decay`` per step),
    punctuated every ``nms_frequency`` steps by m-steps that enforce merit decrease
    against the max of a rolling merit memory, with watchdog rollback to the last
    checkpoint and a line search from there on failure;
  * a QP failure is recovered by an m-step from the last checkpoint;
  * the iteration budget counts m-steps only.

One round is one evaluate with Hessian, one QP, one first-derivative evaluate at the
full-step trial and one grid line search; the d/m-step decisions are masked selects on
per-game state.  The JAX version vmaps a per-game round; here a round updates the whole
batch, every tensor carries the games as its leading dimension, and a game that ends
(or has ended) keeps its carry apart from the status and the convergence measures it
ended on.  (In the JAX version such a game's ``delta``, ``reg`` and ``ck_delta`` may
still fall back to its checkpoint's values, because those selects are not masked;
nothing reads them afterwards.)  The full-step trial and the line search are evaluated
only for the games that use them.
"""
from __future__ import annotations

import math
import time
from typing import List, NamedTuple, Optional

import torch

from dgsqp_torch.solvers.chunked import run_chunked_compacted
from dgsqp_torch.solvers.dgsqp import (CONV_ABS, CONV_REL, DIVERGED, MAX_IT, QP_FAIL, RUNNING,
                                       STALLED, SQPResult, _dot, _HostInterface, _mtv, _mv,
                                       _sel)
from dgsqp_torch.solvers.game_problem import GameProblem
from dgsqp_torch.solvers.qp import solve_qp
from dgsqp_torch.solvers.solver_types import DGSQPV2Params
from dgsqp_torch.types import VehicleState
from dgsqp_torch.utils import profiling
from dgsqp_torch.utils.math import nearest_pd, nearest_pd_ns


class _CarryV2(NamedTuple):
    """Per-game state of the v2 round (leading batch dimension on every field)."""
    u: torch.Tensor
    l: torch.Tensor
    u_im1: torch.Tensor
    l_im1: torch.Tensor
    it: torch.Tensor
    m_it: torch.Tensor
    status: torch.Tensor
    rel_its: torch.Tensor
    qp_solves: torch.Tensor
    delta: torch.Tensor
    reg: torch.Tensor
    # the decay rides in the carry so that a (reg, reg_decay) sweep is one batch
    reg_decay: torch.Tensor
    ck_counter: torch.Tensor
    # checkpoint payload (iterate + step + slack + merit parameter + trust/reg)
    ck_u: torch.Tensor
    ck_l: torch.Tensor
    ck_du: torch.Tensor
    ck_dl: torch.Tensor
    ck_s: torch.Tensor
    ck_mu: torch.Tensor
    ck_delta: torch.Tensor
    ck_reg: torch.Tensor
    # Armijo reference scalars at the checkpoint (merit and its directional derivative
    # along the checkpoint's own step, at the checkpoint's mu): the rollback line search
    # runs Armijo from the loaded checkpoint with the checkpoint's merit parameter
    ck_phi0: torch.Tensor
    ck_dphi0: torch.Tensor
    ck_valid: torch.Tensor
    # checkpoint created last round: its (du, dl, s, mu) payload is completed at the top
    # of this round from the QP step computed at the checkpoint iterate
    ck_fresh: torch.Tensor
    # rolling merit memory (B, nms_memory_size) and its write pointer
    memory: torch.Tensor
    mem_ptr: torch.Tensor
    p_feas: torch.Tensor
    comp: torch.Tensor
    stat: torch.Tensor
    stat_best: torch.Tensor   # best stationarity seen (stagnation escape)
    stall: torch.Tensor       # consecutive m-iterations without 1% improvement


_ChunkResult = NamedTuple('_ChunkResult', [(f, torch.Tensor)
                                            for f in SQPResult._fields + ('m_it',)])


def _rows(P, sel, W: int):
    """Rows ``sel`` of a per-game parameter pytree, each repeated ``W`` times."""
    return torch.utils._pytree.tree_map(
        lambda t: t[sel].repeat_interleave(W, dim=0) if torch.is_tensor(t) else t, P)


class DGSQPV2(_HostInterface):
    """Batched DGSQP v2 solver.

    Entry points run on ``device`` (default the card) in ``dtype``; pass
    ``device='cpu'`` to run the plain CPU path.
    """

    def __init__(self, joint_dynamics, costs, agent_constraints, shared_constraints,
                 bounds, params: DGSQPV2Params = None, print_method=print,
                 dtype=torch.float32, device='cuda'):
        params = params or DGSQPV2Params()
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

        # Optional approximate-game hook: fn(u (B, n_dec), x0 (B, n_q)) -> parameter
        # pytree of per-game tensors, re-evaluated per iteration ('once') or at every
        # trial point as well ('always').  Set by an approximate-game subclass.
        self._approx_update = None

        self._qp_box = self.problem.input_box_structure() if params.qp_box_split else None
        self._qp_pairs = self.problem.state_pair_structure() if params.qp_box_split else None
        if self._qp_pairs is not None and not self._qp_pairs[0]:
            self._qp_pairs = None
        self.last_chunk_history = None
        self.last_m_iters = None     # per-game m-step counts of the last chunked solve

    def _full(self, B: int, v, dtype=None):
        return torch.full((B,), v, dtype=dtype or self.dtype, device=self.device)

    # ------------------------------------------------------------------ pieces
    def _eval_full(self, u, l, x0, up, P):
        evaluate = self.problem.evaluate_dp if self.params.hessian_mode == 'dp' \
            else self.problem.evaluate
        Q, q, G, g, _ = evaluate(u, l, x0, up, P, hessian=True)
        return 0.5 * (Q + Q.transpose(-1, -2)), q, G, g   # v2 symmetrizes

    def _eval_lite(self, u, l, x0, up, P):
        q, G, g, _ = self.problem.evaluate(u, l, x0, up, P, hessian=False)
        return q, G, g

    def _phi(self, l, s, q, G, g, mu, use_l1: bool, obj=None):
        """Merit: 'stat_l1' 1/2||q + G'l||^2 + mu*sum(s); 'sum_obj_l1' sum_a J^a +
        mu*sum(s) (requires ``obj``)."""
        if self.params.merit_function == 'sum_obj_l1':
            return obj + mu * torch.sum(s, dim=-1)
        return self._phi_d(q + _mtv(G, l), s, mu, use_l1)

    def _phi_d(self, d, s, mu, use_l1: bool, obj=None):
        """Merit from precomputed d = q + G'l (Jacobian-free form)."""
        if self.params.merit_function == 'sum_obj_l1':
            return obj + mu * torch.sum(s, dim=-1)
        val = 0.5 * _dot(d, d)
        if use_l1:
            val = val + mu * torch.sum(s, dim=-1)
        return val

    def _dphi(self, du, l, dl, s, Q, q, G, g, mu, use_l1: bool, dobj=None):
        if self.params.merit_function == 'sum_obj_l1':
            return dobj - mu * torch.sum(s, dim=-1)
        F = q + _mtv(G, l)
        d = _dot(F, _mv(Q, du) + _mtv(G, dl))
        if use_l1:
            d = d - mu * torch.sum(s, dim=-1)
        return d

    def _obj_and_grad(self, u, x0, up, P):
        """Sum of the agents' costs and its u-gradient, per game (for the sum_obj_l1
        merit).  Games do not interact, so the gradient of the batch total holds every
        game's own gradient."""
        def total(uu):
            obj = torch.sum(self.problem.eval_costs(uu, x0, up, P), dim=-1)
            return torch.sum(obj), obj
        grad, obj = torch.func.grad(total, has_aux=True)(u)
        return obj, grad

    def _get_mu(self, du, l, dl, s, Q, q, G, g, dobj=None):
        if self.params.merit_parameter is not None:
            return self._full(q.shape[0], self.params.merit_parameter)
        d_c = self._dphi(du, l, dl, s, Q, q, G, g, 0.0, use_l1=True, dobj=dobj)
        vio = torch.sum(s, dim=-1)
        rho = 0.5
        # dtype-aware feasibility noise floor
        thresh = (1e-10 if self.dtype == torch.float64 else 1e-5) * \
            (1.0 + torch.amax(torch.abs(g), dim=-1))
        mu = torch.abs(d_c) / ((1 - rho) * torch.clamp(vio, min=1e-300))
        return torch.where(vio > thresh, mu, 0.0)

    @profiling.traced('qp', 'qp_calls')
    def _qp(self, Q, q, G, g, reg):
        p = self.params
        method = p.conv_method
        with profiling.span('qp.convexify'):
            eye = torch.eye(self.n_dec, dtype=self.dtype, device=self.device)
            shift = reg[:, None, None] * eye
            if method == 'ns':
                Qh = nearest_pd_ns(Q, iters=p.conv_ns_iters, safety=p.conv_ns_safety,
                                   equilibrate=p.conv_ns_equil) + shift
            elif method == 'none':
                # indefinite path: symmetrize + Levenberg shift only, no PSD projection;
                # the QP keeps the exact game Hessian and factorizes by Levenberg-shifted LU
                Qh = 0.5 * (Q + Q.transpose(-1, -2)) + shift
            else:
                Qh = nearest_pd(Q) + shift
        sol = solve_qp(Qh, q, G, -g, tol=p.qp_tol, max_iters=50,
                       indefinite=(method == 'none'), box=self._qp_box,
                       pairs=self._qp_pairs, correctors=p.qp_correctors)
        return sol.x, sol.lam, sol.ok

    @profiling.traced('merit')
    def _line_search(self, enabled, u, du, l, dl, s, mu, mem_max, x0, up, P, P_fn=None,
                     eval0=None, ck_ref=None):
        """v2 backtracking line search as a trial grid alpha = tau^j.

        Returns (u_acc, l_acc, phi_acc_mu1) where phi is evaluated with mu=1 at the
        accepted point (fed into the merit memory); games that are not ``enabled`` get
        (u, l, inf).  ``P_fn(u, x0)`` (approximate game, ``approximation_eval='always'``)
        re-linearizes the parameters at each trial point.

        ``eval0 = (Q0, q0, G0, g0, fresh)``: the round's derivatives at the current
        iterate plus a per-game mask of games whose line-search point is that iterate.
        Fresh games build the Armijo reference from the reused data.  Stale games
        (watchdog rollback, QP-failure recovery) use ``ck_ref = (phi0_ck, dphi0_ck)``,
        the Armijo reference scalars recorded at the checkpoint commit with the
        checkpoint's own step and mu.  Without ``ck_ref`` stale games fall back to the
        non-monotone max-merit reference.

        Only the enabled games are evaluated, all their trials at once; the first
        accepted trial wins, else the last.
        """
        p = self.params
        use_l1 = p.merit_function in ('stat_l1', 'sum_obj_l1')
        sum_obj = p.merit_function == 'sum_obj_l1'
        sigma = p.merit_decrease

        if p.merit_decrease_condition == 'armijo':
            fresh = None
            if eval0 is not None and not sum_obj:
                Q0, q0, G0, g0, fresh = eval0
            else:
                Q0, q0, G0, g0 = self._eval_full(u, l, x0, up, P)
            if sum_obj:
                obj0, gobj0 = self._obj_and_grad(u, x0, up, P)
                dobj0 = _dot(gobj0, du)
            else:
                obj0, dobj0 = None, None
            phi0 = self._phi(l, s, q0, G0, g0, mu, use_l1, obj=obj0)
            dphi0 = self._dphi(du, l, dl, torch.clamp(g0, min=0.0), Q0, q0, G0, g0, mu,
                               use_l1, dobj=dobj0)

            if fresh is not None and ck_ref is not None:
                phi0_ck, dphi0_ck = ck_ref

                def ref(alpha, sel):
                    return torch.where(fresh[sel][:, None],
                                       phi0[sel][:, None] + sigma * alpha * dphi0[sel][:, None],
                                       phi0_ck[sel][:, None]
                                       + sigma * alpha * dphi0_ck[sel][:, None])
            elif fresh is not None:
                def ref(alpha, sel):
                    return torch.where(fresh[sel][:, None],
                                       phi0[sel][:, None] + sigma * alpha * dphi0[sel][:, None],
                                       (1 - sigma * alpha) * mem_max[sel][:, None])
            else:
                def ref(alpha, sel):
                    return phi0[sel][:, None] + sigma * alpha * dphi0[sel][:, None]
        else:  # 'max'
            def ref(alpha, sel):
                return (1 - sigma * alpha) * mem_max[sel][:, None]

        u_t, l_t = u, l
        phi1 = self._full(u.shape[0], math.inf)
        with profiling.sync('merit.select'):
            sel = torch.nonzero(enabled).flatten()
        nb = int(sel.numel())
        W = p.line_search_iters
        profiling.count('merit_games', nb)
        profiling.count('merit_points', nb * W)
        if nb == 0:
            return u_t, l_t, phi1
        alphas = torch.tensor(p.tau, dtype=self.dtype, device=self.device) ** \
            torch.arange(W, dtype=self.dtype, device=self.device)
        a3 = alphas[None, :, None]
        u_try = (u[sel][:, None] + a3 * du[sel][:, None]).reshape(nb * W, -1)
        l_try = (l[sel][:, None] + a3 * dl[sel][:, None]).reshape(nb * W, -1)
        rep = lambda v: v[sel].repeat_interleave(W, dim=0)
        x0_r, up_r = rep(x0), rep(up)
        if P_fn is not None:
            P_t = P_fn(u_try, x0_r)
        elif self._approx_update is not None:
            P_t = _rows(P, sel, W)
        else:
            P_t = P
        d_t, g_t = self.problem.merit_terms(u_try, l_try, x0_r, up_r, P_t)
        s_t = torch.clamp(g_t, min=0.0)
        obj_t = torch.sum(self.problem.eval_costs(u_try, x0_r, up_r, P_t), dim=-1) \
            if sum_obj else None
        phis = self._phi_d(d_t, s_t, rep(mu), use_l1, obj=obj_t).reshape(nb, W)
        phi1s = self._phi_d(d_t, s_t, 1.0, use_l1, obj=obj_t).reshape(nb, W)
        ok = phis <= ref(alphas[None, :], sel)
        first = torch.argmax(ok.to(torch.uint8), dim=-1)
        idx = torch.where(ok.any(-1), first, W - 1)
        alpha_sel = alphas[idx][:, None]
        u_t = u.index_copy(0, sel, u[sel] + alpha_sel * du[sel])
        l_t = l.index_copy(0, sel, l[sel] + alpha_sel * dl[sel])
        phi1 = phi1.index_copy(0, sel, phi1s.gather(1, idx[:, None])[:, 0])
        return u_t, l_t, phi1

    # ----------------------------------------------------------------- core loop
    def _make_body(self, x0, up, P=None):
        """The round ``body(carry) -> carry`` for the batch ``(x0, up)``."""
        p = self.params
        dtype = self.dtype
        use_l1 = p.merit_function in ('stat_l1', 'sum_obj_l1')
        sum_obj = p.merit_function == 'sum_obj_l1'
        xtol, ltol = p.p_tol, p.d_tol
        rel_tol_req = 10
        mem_size = p.nms_memory_size

        def mem_max(memory):
            return torch.amax(memory, dim=-1)

        def mem_push(memory, ptr, val):
            ptr_n = (ptr + 1) % mem_size
            return memory.scatter(1, ptr_n[:, None], val[:, None]), ptr_n

        # approximate-game parameter cadence:
        #   'once'   recompute the linearization once per SQP iteration, at the current
        #            iterate, frozen through that iteration's trials;
        #   'always' additionally recompute it inside every evaluation (full-step trial,
        #            line-search merit trials), i.e. P moves with the trial point.
        approx_always = (self._approx_update is not None
                         and p.approximation_eval == 'always')

        @profiling.traced('round', 'rounds')
        def body(c: _CarryV2) -> _CarryV2:
            B = c.u.shape[0]
            running = c.status == RUNNING
            false = torch.zeros(B, dtype=torch.bool, device=self.device)

            if self._approx_update is not None:
                P_i = self._approx_update(c.u, x0)
            else:
                P_i = P
            Q, q, G, g = self._eval_full(c.u, c.l, x0, up, P_i)
            d = q + _mtv(G, c.l)
            p_feas = torch.clamp(torch.amax(g, dim=-1), min=0.0)
            comp = torch.amax(torch.abs(g * c.l), dim=-1)
            stat = torch.amax(torch.abs(d), dim=-1)

            diverged = stat > 1e10
            if p.conv_scaled_stat:
                # relative KKT test: stat and comp scale with the cost-gradient
                # magnitude, p_feas stays absolute
                kkt_scale = torch.clamp(torch.amax(torch.abs(q), dim=-1), min=1.0)
            else:
                kkt_scale = self._full(B, 1.0)
            converged = (p_feas < xtol) & (comp < ltol * kkt_scale) & \
                        (stat < ltol * kkt_scale)
            max_it = c.m_it >= p.sqp_iters
            finished = diverged | converged | max_it
            keep_going = running & ~finished

            du, lhat, qp_ok = self._qp(Q, q, G, g, c.reg)
            dl = lhat - c.l

            # initialize the trust quantity on the very first iteration (factor <= 0:
            # delta starts at 0, so the first step is an m-step and gets merit-checked)
            step_norm = torch.linalg.vector_norm(torch.cat([du, dl], dim=-1), dim=-1)
            f0 = max(0.0, float(p.nms_initial_step_size_factor))
            delta = torch.where(c.it == 0, f0 * step_norm, c.delta)
            ck_delta = torch.where(c.it == 0, delta, c.ck_delta)

            s = torch.clamp(g, min=0.0)
            if sum_obj:
                obj_c, gobj_c = self._obj_and_grad(c.u, x0, up, P_i)
                dobj_c = _dot(gobj_c, du)
            else:
                obj_c, dobj_c = None, None
            mu = self._get_mu(du, c.l, dl, s, Q, q, G, g, dobj=dobj_c)

            # Commit a checkpoint created last round: its iterate equals the current
            # iterate, so this round's (du, dl, s, mu) is the step computed at the
            # checkpoint.  The point and the step commit together: until this round's
            # QP succeeds the previous consistent (point, step) record stays in force,
            # so a QP failure straight after an m-step rolls back to a matched pair.
            refresh = c.ck_fresh & keep_going & qp_ok
            ck_u_c = _sel(refresh, c.u, c.ck_u)
            ck_l_c = _sel(refresh, c.l, c.ck_l)
            ck_du_c = _sel(refresh, du, c.ck_du)
            ck_dl_c = _sel(refresh, dl, c.ck_dl)
            ck_s_c = _sel(refresh, s, c.ck_s)
            ck_mu_c = torch.where(refresh, mu, c.ck_mu)
            ck_delta_c = torch.where(refresh, delta, ck_delta)
            ck_reg_c = torch.where(refresh, c.reg, c.ck_reg)
            # Armijo reference at the checkpoint, from this round's derivatives at c.u
            # (== the checkpoint on commit rounds) and its fresh step/mu
            phi0_here = self._phi(c.l, s, q, G, g, mu, use_l1, obj=obj_c)
            dphi0_here = self._dphi(du, c.l, dl, s, Q, q, G, g, mu, use_l1, dobj=dobj_c)
            ck_phi0_c = torch.where(refresh, phi0_here, c.ck_phi0)
            ck_dphi0_c = torch.where(refresh, dphi0_here, c.ck_dphi0)
            ck_valid = c.ck_valid | refresh

            if p.nms:
                qp_fail_recover = ~qp_ok & ck_valid
                m_step = (~qp_ok & ck_valid) | (qp_ok & ((c.ck_counter >= p.nms_frequency)
                                                         | (step_norm >= delta)))
                d_step = qp_ok & ~m_step
                plain_ls = false
                hard_qp_fail = ~qp_ok & ~ck_valid
            else:
                qp_fail_recover = m_step = d_step = false
                plain_ls = qp_ok
                hard_qp_fail = ~qp_ok

            # ---------- d-step: accept the full step, shrink delta
            u_d = c.u + du
            l_d = c.l + dl

            # ---------- m-step
            # On QP failure the checkpoint is restored first and the m-step machinery
            # runs from there; otherwise the m-step acts on the current iterate and the
            # fresh QP step.
            src_u = _sel(qp_fail_recover, ck_u_c, c.u)
            src_l = _sel(qp_fail_recover, ck_l_c, c.l)
            src_du = _sel(qp_fail_recover, ck_du_c, du)
            src_dl = _sel(qp_fail_recover, ck_dl_c, dl)
            src_s = _sel(qp_fail_recover, ck_s_c, s)
            src_mu = torch.where(qp_fail_recover, ck_mu_c, mu)

            # full-step trial against the non-monotone reference, for the games that
            # take an m-step this round (nothing reads it for the others)
            u_full = src_u + src_du
            l_full = src_l + src_dl
            phi_full = self._full(B, math.inf)
            with profiling.span('trial'):
                with profiling.sync('trial.select'):
                    sel = torch.nonzero(m_step & keep_going).flatten()
                profiling.count('trial_games', sel.numel())
                if sel.numel():
                    profiling.count('trials')
                    x0_f, up_f = x0[sel], up[sel]
                    if approx_always:
                        P_f = self._approx_update(u_full[sel], x0_f)
                    elif self._approx_update is not None:
                        P_f = _rows(P_i, sel, 1)
                    else:
                        P_f = P_i
                    q_f, G_f, g_f = self._eval_lite(u_full[sel], l_full[sel], x0_f, up_f,
                                                    P_f)
                    s_f = torch.clamp(g_f, min=0.0)
                    obj_f = torch.sum(self.problem.eval_costs(u_full[sel], x0_f, up_f, P_f),
                                      dim=-1) if sum_obj else None
                    phi_full = phi_full.index_copy(
                        0, sel, self._phi(l_full[sel], s_f, q_f, G_f, g_f, 1.0, use_l1,
                                          obj=obj_f))
            R = (1 - p.merit_decrease) * mem_max(c.memory)
            accept_full = m_step & (phi_full <= R)

            # watchdog rollback source (the checkpoint's point, step, slack and mu)
            rollback = m_step & ~accept_full & ck_valid
            ls_u = _sel(rollback, ck_u_c, src_u)
            ls_l = _sel(rollback, ck_l_c, src_l)
            ls_du = _sel(rollback, ck_du_c, src_du)
            ls_dl = _sel(rollback, ck_dl_c, src_dl)
            ls_s = _sel(rollback, ck_s_c, src_s)
            ls_mu = torch.where(rollback, ck_mu_c, src_mu)
            delta = torch.where(rollback, ck_delta_c, delta)
            reg = torch.where(rollback, ck_reg_c, c.reg)

            ls_enabled = (m_step & ~accept_full) | plain_ls
            ls_fresh = ~(rollback | qp_fail_recover)
            u_ls, l_ls, phi_ls = self._line_search(
                ls_enabled & keep_going, ls_u, ls_du, ls_l, ls_dl, ls_s, ls_mu,
                mem_max(c.memory), x0, up, P_i,
                P_fn=self._approx_update if approx_always else None,
                eval0=(Q, q, G, g, ls_fresh), ck_ref=(ck_phi0_c, ck_dphi0_c))

            # ---------- select the next iterate
            u_n = _sel(d_step, u_d, _sel(accept_full, u_full, _sel(ls_enabled, u_ls, c.u)))
            l_n = _sel(d_step, l_d, _sel(accept_full, l_full, _sel(ls_enabled, l_ls, c.l)))
            u_n = _sel(keep_going, u_n, c.u)
            l_n = _sel(keep_going, l_n, c.l)

            # ---------- bookkeeping
            mstep_done = keep_going & (m_step | plain_ls)
            phi_new = torch.where(accept_full, phi_full, phi_ls)

            delta = torch.where(keep_going & d_step, p.delta_decay * delta, delta)
            ck_counter = torch.where(keep_going & d_step, c.ck_counter + 1,
                                     torch.where(mstep_done, 0, c.ck_counter))
            reg = torch.where(mstep_done, reg * c.reg_decay, reg)

            memory, mem_ptr = mem_push(c.memory, c.mem_ptr, phi_new)
            memory = _sel(mstep_done, memory, c.memory)
            mem_ptr = torch.where(mstep_done, mem_ptr, c.mem_ptr)

            # A new checkpoint is pending after every m-step (at the accepted point);
            # its full (point, step) record only commits at the next round's top once
            # the QP at that point succeeds.
            ck_fresh = torch.where(keep_going, mstep_done, c.ck_fresh)

            # relative-tolerance convergence, only checked on m-steps
            small = (torch.linalg.vector_norm(u_n - c.u_im1, dim=-1) < xtol) & \
                    (torch.linalg.vector_norm(l_n - c.l_im1, dim=-1) < ltol)
            rel_its = torch.where(mstep_done & small, c.rel_its + 1,
                                  torch.where(mstep_done, 0, c.rel_its))
            conv_rel = mstep_done & (rel_its >= rel_tol_req) & (p_feas < xtol)
            u_im1 = _sel(mstep_done, u_n, c.u_im1)
            l_im1 = _sel(mstep_done, l_n, c.l_im1)

            m_it = c.m_it + mstep_done.to(c.m_it.dtype)
            it = c.it + keep_going.to(c.it.dtype)
            qp_solves = c.qp_solves + keep_going.to(c.qp_solves.dtype)

            # stagnation escape (deterministic analog of a wall-clock limit)
            improved = stat < 0.99 * c.stat_best
            stat_best = torch.where(keep_going, torch.minimum(stat, c.stat_best),
                                    c.stat_best)
            stall = torch.where(keep_going, torch.where(improved, 0, c.stall + 1), c.stall)
            is_stalled = (stall >= p.stall_its) if p.stall_its is not None else false

            status = self._full(B, RUNNING, torch.int32)
            for cond, code in ((is_stalled, STALLED), (conv_rel, CONV_REL),
                               (hard_qp_fail, QP_FAIL), (max_it, MAX_IT),
                               (diverged, DIVERGED), (converged, CONV_ABS)):
                status = torch.where(cond, code, status)

            new = _CarryV2(u_n, l_n, u_im1, l_im1, it, m_it, status,
                           rel_its, qp_solves, delta, reg, c.reg_decay, ck_counter,
                           ck_u_c, ck_l_c, ck_du_c, ck_dl_c, ck_s_c, ck_mu_c,
                           ck_delta_c, ck_reg_c, ck_phi0_c, ck_dphi0_c,
                           ck_valid, ck_fresh, memory, mem_ptr,
                           p_feas, comp, stat, stat_best, stall)
            # a game that does not go on keeps its carry; one that ends in this round
            # still records its status and the convergence measures it ended on
            out = _CarryV2(*[_sel(keep_going, n, o) for n, o in zip(new, c)])
            return out._replace(**{f: _sel(running, getattr(new, f), getattr(c, f))
                                   for f in ('status', 'p_feas', 'comp', 'stat')})

        return body

    def _init_carry(self, u0, l0, x0, up, P=None) -> _CarryV2:
        p = self.params
        dt, dev = self.dtype, self.device
        use_l1 = p.merit_function in ('stat_l1', 'sum_obj_l1')
        sum_obj = p.merit_function == 'sum_obj_l1'
        z_u = torch.as_tensor(u0, dtype=dt, device=dev)
        z_l = torch.as_tensor(l0, dtype=dt, device=dev)
        B = z_u.shape[0]

        if self._approx_update is not None:
            P = self._approx_update(z_u, x0)

        # initial merit memory entry
        q_i0, G_i0, g_i0 = self._eval_lite(z_u, z_l, x0, up, P)
        obj_0 = torch.sum(self.problem.eval_costs(z_u, x0, up, P), dim=-1) if sum_obj else None
        phi0 = self._phi(z_l, torch.clamp(g_i0, min=0.0), q_i0, G_i0, g_i0, 1.0, use_l1,
                         obj=obj_0)
        memory0 = torch.full((B, p.nms_memory_size), -math.inf, dtype=dt, device=dev)
        memory0[:, 0] = phi0

        full = lambda v, dtype=dt: self._full(B, v, dtype)
        return _CarryV2(u=z_u, l=z_l, u_im1=z_u, l_im1=z_l,
                        it=full(0, torch.long), m_it=full(0, torch.long),
                        status=full(RUNNING, torch.int32),
                        rel_its=full(0, torch.long), qp_solves=full(0, torch.long),
                        delta=full(math.inf), reg=full(p.reg), reg_decay=full(p.reg_decay),
                        ck_counter=full(0, torch.long),
                        ck_u=z_u, ck_l=z_l, ck_du=torch.zeros_like(z_u),
                        ck_dl=torch.zeros_like(z_l), ck_s=torch.zeros_like(z_l),
                        ck_mu=full(0.0), ck_delta=full(math.inf), ck_reg=full(p.reg),
                        ck_phi0=full(math.inf), ck_dphi0=full(0.0),
                        ck_valid=full(False, torch.bool),
                        # the initial iterate is a pending checkpoint: round 0's
                        # successful QP commits (u0, step0) as the first consistent
                        # record, so a QP failure hard-exits only before any
                        # successful QP
                        ck_fresh=full(True, torch.bool),
                        memory=memory0, mem_ptr=full(0, torch.long),
                        p_feas=full(math.inf), comp=full(math.inf), stat=full(math.inf),
                        stat_best=full(math.inf), stall=full(0, torch.long))

    def _finalize(self, c: _CarryV2, x0, up, P=None) -> SQPResult:
        if self._approx_update is not None:
            P = self._approx_update(c.u, x0)
        q, G, g, _ = self.problem.evaluate(c.u, c.l, x0, up, P, hessian=False)
        d = q + _mtv(G, c.l)
        p_feas = torch.clamp(torch.amax(g, dim=-1), min=0.0)
        comp = torch.amax(torch.abs(g * c.l), dim=-1)
        stat = torch.amax(torch.abs(d), dim=-1)
        return SQPResult(c.u, c.l, c.status, c.it, c.qp_solves, p_feas, comp, stat)

    def _run(self, c: _CarryV2, x0, up, P=None, max_rounds: Optional[int] = None):
        """Apply the round until no game is RUNNING (or ``max_rounds`` rounds)."""
        body = self._make_body(x0, up, P)
        rounds = 0
        while profiling.read_bool((c.status == RUNNING).any(), 'round.status') and \
                (max_rounds is None or rounds < max_rounds):
            c = body(c)
            rounds += 1
        return c

    _compact_min_bucket = 16

    @profiling.traced('solve', new_request=True)
    def solve_batch_chunked(self, u0, l0, x0, up, chunk_iters: int = 8,
                            max_chunks: Optional[int] = None, verbose: bool = False,
                            compact: Optional[bool] = None, mesh=None) -> SQPResult:
        """Batched solve as a host loop over chunks of ``chunk_iters`` rounds, with
        straggler compaction between chunks unless ``compact=False``.  Inputs are
        (B, ...) tensors on the solver's device; the result is in the input order.
        With a ``mesh`` of several ranks the inputs are this rank's block and the result
        is the whole batch's, on every rank.

        v2 needs no separate flat machine: its round already has a fixed signature,
        so chunked lockstep execution plus compaction gives it the batch efficiency v1
        gets from the flattened watchdog.
        """
        def chunk_fn(c, x, u_p):
            return self._run(c, x, u_p, None, max_rounds=chunk_iters)

        def final_fn(c, x, u_p):
            # the m-step counts ride along through the compaction's result store
            return _ChunkResult(*self._finalize(c, x, u_p), c.m_it)

        carry = self._init_carry(u0, l0, x0, up)
        # the budget counts m-steps; allow ~6x in raw iterations before giving up
        max_chunks = max_chunks or (6 * self.params.sqp_iters // chunk_iters + 4)
        out, history = run_chunked_compacted(
            carry, x0, up, chunk_fn, final_fn=final_fn, running_status=RUNNING,
            max_chunks=max_chunks, min_bucket=self._compact_min_bucket, verbose=verbose,
            can_compact=compact is None or compact, print_method=self.print_method,
            mesh=mesh)
        self.last_chunk_history = history
        self.last_m_iters = out[-1]
        return SQPResult(*out[:-1])

    # ------------------------------------------------------------- host interface
    def solve(self, states: List[VehicleState], parameters=None):
        """One game from the stored warm start: a batch of one, driven until its status
        leaves RUNNING."""
        t_start = time.time()
        u0, l0, x0, up = self._host_batch(states, parameters)
        c = self._run(self._init_carry(u0, l0, x0, up, parameters), x0, up, parameters)
        res = self._finalize(c, x0, up, parameters)
        info = self._host_info(res, x0, time.time() - t_start)
        info.update(primal_sol=info['u_sol'], dual_sol=info['l_sol'], x_pred=self.q_pred,
                    u_pred=self.u_pred, conds=dict(info['cond']))
        return info
