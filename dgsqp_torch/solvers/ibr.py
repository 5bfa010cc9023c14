"""Iterated best response (IBR): Gauss-Seidel sweeps of single-agent optimal control,
ported from ``dgsqp_tpu/solvers/ibr.py``.

Each best response is a single-agent SQP: the agent's Hessian of its Lagrangian by AD,
convexified, a QP on the agent's own N * n_ua decisions (``solve_qp``, so both kernels run
at that size) and an Armijo search on an l1 exact-penalty merit.  IBR is mostly a
warm-start generator for the game solvers (``ibr_iters=1``).

Every method takes a batch (a leading game dimension).  The JAX version vmaps per-game
``lax.while_loop``s (the best-response SQP loop and its line search); here each loop
advances the whole batch in lockstep with a per-game mask and stops when no game is
left in it.
"""
from __future__ import annotations

import time
from typing import List, NamedTuple

import numpy as np
import torch
from torch.utils._pytree import tree_map

from dgsqp_torch.solvers.backtrack import backtrack
from dgsqp_torch.solvers.game_problem import GameProblem, _jac_fwd, _jac_rev
from dgsqp_torch.solvers.qp import solve_qp
from dgsqp_torch.solvers.solver_types import IBRParams
from dgsqp_torch.types import VehiclePrediction, VehicleState
from dgsqp_torch.utils.math import regularized_convexification


class IBRResult(NamedTuple):
    u: torch.Tensor          # (B, n_dec) agent-stacked joint input
    converged: torch.Tensor
    sweeps: torch.Tensor
    delta: torch.Tensor      # last max input change


def _sel(mask, a, b):
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


class IBR:
    """Batched iterated best response.  Entry points run on ``device`` (default the
    card) in ``dtype``; pass ``device='cpu'`` to run on the CPU."""

    def __init__(self, joint_dynamics, costs, agent_constraints, shared_constraints,
                 bounds, params: IBRParams = None, print_method=print,
                 dtype=torch.float32, device='cuda'):
        params = params or IBRParams()
        self.params = params
        self.device = torch.device(device)
        if self.device.type == 'cuda':
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
        self.n_dec = self.problem.n_dec
        self.br_idxs = [torch.as_tensor(self.problem.constraint_indices_for_agent(a),
                                        device=self.device) for a in range(self.M)]
        self.ua_slices = [(int(self.problem.ua_el_offsets[a]),
                           int(self.problem.ua_el_offsets[a + 1])) for a in range(self.M)]

        self.q_pred = np.zeros((self.N + 1, self.n_q))
        self.u_pred = np.zeros((self.N, self.n_u))
        self.u_ws = np.zeros(self.n_dec)
        self.state_input_predictions = [VehiclePrediction() for _ in range(self.M)]
        # per agent, the BR KKT residual (B,) and SQP iterations (B,) of the last sweep
        self.last_br_kkt = {}
        self.last_br_iters = {}
        self.initialized = True

    def _set_block(self, u_full, a: int, ua):
        """``u_full`` with agent a's block replaced by ``ua`` (differentiable)."""
        s0, s1 = self.ua_slices[a]
        return torch.cat([u_full[:, :s0], ua, u_full[:, s1:]], dim=-1)

    # ------------------------------------------------------------ best response
    def _embed(self, a: int, u_f, ua, ps=None, pick=lambda v: v):
        """``u_f`` with agent a's block set to ``ua``; with ``ps = (sens, base, ua_ref)``
        (``use_ps``) the opponents' blocks move by their linear response
        ``base_o + S_o (ua - ua_ref)``.  ``pick`` maps a per-game tensor onto the rows of
        ``u_f`` (the line search's trials)."""
        out = self._set_block(u_f, a, ua)
        if ps is not None:
            sens, base, ua_ref = ps
            for o, S in sens.items():
                s0o, s1o = self.ua_slices[o]
                out = self._set_block(out, o, pick(base)[:, s0o:s1o]
                                      + _mv(pick(S), ua - pick(ua_ref)))
        return out

    def _br_step(self, a: int, u_full, l_a, x0, up, P, ps=None):
        """One SQP iteration of agent a's best response with the others' inputs frozen
        (or moved by their linear response, ``ps`` of :meth:`_embed`).

        Returns the updated (u_full, l_a, kkt_res)."""
        s0, s1 = self.ua_slices[a]
        idxs = self.br_idxs[a]
        prob = self.problem

        def full(ua):
            return self._embed(a, u_full, ua, ps)

        def cost_and_cons(uf, x0_, up_, P_):
            """J^a and agent a's constraint rows along one shared rollout."""
            x = prob.rollout(uf, x0_)
            return (prob._agent_cost_along(a, x, uf, up_, P_),
                    prob._constraints_along(x, uf, up_, P_)[:, idxs])

        def grad_cost(ua):
            return _jac_rev(lambda v: prob.agent_cost(a, full(v), x0, up, P)[:, None],
                            ua)[:, 0]

        ua = u_full[:, s0:s1]

        # one forward-over-reverse sweep: the reverse gradients of J^a and l'C pushed
        # through the n_a forward tangents give the Lagrangian Hessian Q with G = dC/du
        def grad_and_primal(v):
            def sigma(w):
                J, C = cost_and_cons(full(w), x0, up, P)
                return torch.stack([J, torch.sum(l_a * C, dim=-1)], dim=-1), C
            grad, C = _jac_rev(sigma, v, has_aux=True)
            return (grad[:, 0] + grad[:, 1], C), (C, grad[:, 0])

        (Q, G), (g, q) = _jac_fwd(grad_and_primal, ua, has_aux=True)
        Qh = regularized_convexification(Q, self.params.br_reg)
        sol = solve_qp(Qh, q, G, -g)
        ok = sol.ok[:, None]
        du = torch.where(ok, sol.x, 0.0)
        l_new = torch.where(ok, sol.lam, l_a)

        # Armijo on the l1 exact-penalty merit
        if l_new.shape[-1]:
            mu = torch.clamp(2.0 * torch.amax(torch.abs(l_new), dim=-1), min=10.0)
        else:
            mu = torch.full_like(q[:, 0], 10.0)

        J0, C0 = cost_and_cons(full(ua), x0, up, P)
        phi0 = J0 + mu * torch.sum(torch.clamp(C0, min=0.0), dim=-1)
        dphi = torch.sum(q * du, dim=-1) - mu * torch.sum(torch.clamp(g, min=0.0), dim=-1)

        def accept(sel, a_t):
            n, T = a_t.shape
            rep = lambda v: v[sel][:, None].expand(n, T, *v.shape[1:]).reshape(
                n * T, *v.shape[1:])
            ua_t = (ua[sel][:, None] + a_t[:, :, None] * du[sel][:, None]).reshape(n * T, -1)
            J, C = cost_and_cons(self._embed(a, rep(u_full), ua_t, ps, rep), rep(x0),
                                 rep(up), None if P is None else tree_map(rep, P))
            m_t = J + rep(mu) * torch.sum(torch.clamp(C, min=0.0), dim=-1)
            return m_t.reshape(n, T) <= phi0[sel][:, None] + 1e-4 * a_t * dphi[sel][:, None]

        B = ua.shape[0]
        alpha, _ = backtrack(accept, torch.ones(B, dtype=torch.bool, device=ua.device),
                             self.params.line_search_iters, 0.5, ua.dtype, ua.device)
        ua_new = ua + alpha[:, None] * du
        kkt = torch.amax(torch.abs(grad_cost(ua_new) + _mv(G.transpose(-1, -2), l_new)),
                         dim=-1)
        return self._set_block(u_full, a, ua_new), l_new, kkt

    def _opponent_duals(self, o: int, u_full, x0, up, P):
        """Least-squares multiplier estimate for opponent o's BR KKT at ``u_full``:
        min ||grad J_o + C_u' lam|| over lam supported on the near-active rows of o's
        constraints (the minimum-norm solution, singular values below
        eps * max(dims) * s_max dropped, as ``jnp.linalg.lstsq`` with ``rcond=None``),
        clipped at 0."""
        prob = self.problem
        s0o, s1o = self.ua_slices[o]
        idxs = self.br_idxs[o]

        def cons_o(u_o):
            return prob.eval_constraints(self._set_block(u_full, o, u_o), x0, up, P)[:, idxs]

        u_o = u_full[:, s0o:s1o]
        Gu, g = _jac_fwd(lambda v: (cons_o(v), cons_o(v)), u_o, has_aux=True)
        grad = _jac_rev(lambda uu: prob.agent_cost(o, uu, x0, up, P)[:, None],
                        u_full)[:, 0, s0o:s1o]
        eps_act = 1e-4 * (1.0 + torch.amax(torch.abs(g), dim=-1))
        act = (g > -eps_act[:, None]).to(u_full.dtype)
        Ga = Gu * act[:, :, None]
        lam = _mv(torch.linalg.pinv(Ga.transpose(-1, -2)), -grad)
        return torch.clamp(lam * act, min=0.0)

    def _response_sensitivities(self, a: int, u_full, x0, up, P):
        """Opponent best-response sensitivities S_o = d u_o / d u_a (B, n_o, n_a) by the
        implicit function theorem on each opponent's full BR KKT system

            F(u_o, lam_o; u_a) = [ grad_{u_o}(J_o + lam_o' C_o) ; lam_o o C_o ] = 0
            S_o = -[dF/d(u_o, lam_o)]^{-1} dF/du_a   (u_o rows)

        with the multipliers of :meth:`_opponent_duals`."""
        prob = self.problem
        s0a, s1a = self.ua_slices[a]
        sens = {}
        for o in range(self.M):
            if o == a:
                continue
            s0o, s1o = self.ua_slices[o]
            n_o = s1o - s0o
            idxs = self.br_idxs[o]
            lam_o = self._opponent_duals(o, u_full, x0, up, P)
            m_o = lam_o.shape[-1]

            def F(z):
                u_o, lam, u_a = z[:, :n_o], z[:, n_o:n_o + m_o], z[:, n_o + m_o:]
                uf = self._set_block(self._set_block(u_full, o, u_o), a, u_a)
                C = prob.eval_constraints(uf, x0, up, P)[:, idxs]

                def lag(uu):
                    L = prob.agent_cost(o, uu, x0, up, P) + torch.sum(
                        lam * prob.eval_constraints(uu, x0, up, P)[:, idxs], dim=-1)
                    return L[:, None]
                stat = _jac_rev(lag, uf)[:, 0, s0o:s1o]
                return torch.cat([stat, lam * C], dim=-1)

            z0 = torch.cat([u_full[:, s0o:s1o], lam_o, u_full[:, s0a:s1a]], dim=-1)
            J = _jac_fwd(F, z0)
            Jz, J_ua = J[..., :n_o + m_o], J[..., n_o + m_o:]
            reg = 1e-8 * torch.eye(n_o + m_o, dtype=u_full.dtype, device=u_full.device)
            S_full = -torch.linalg.solve_ex(Jz + reg, J_ua, check_errors=False)[0]
            sens[o] = S_full[:, :n_o]
        return sens

    def _solve_br(self, a: int, u_full, x0, up, P):
        """Solve agent a's best response to tolerance with an inner SQP loop.

        With ``use_ps`` the opponents' inputs respond linearly to agent a's deviation
        through the sensitivities at the loop's start point."""
        p = self.params
        ps = None
        if p.use_ps and self.M > 1:
            s0a, s1a = self.ua_slices[a]
            ps = (self._response_sensitivities(a, u_full, x0, up, P), u_full,
                  u_full[:, s0a:s1a])

        s0, s1 = self.ua_slices[a]
        B = u_full.shape[0]
        dev = u_full.device
        u_f = u_full
        l_a = torch.zeros(B, int(self.br_idxs[a].numel()), dtype=self.dtype, device=dev)
        it = torch.zeros(B, dtype=torch.long, device=dev)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        kkt_last = torch.full((B,), float('inf'), dtype=self.dtype, device=dev)
        while True:
            live = ~done & (it < p.br_sqp_iters)
            if not bool(live.any()):
                break
            u_n, l_n, kkt = self._br_step(a, u_f, l_a, x0, up, P, ps)
            step = torch.amax(torch.abs(u_n[:, s0:s1] - u_f[:, s0:s1]), dim=-1)
            conv = (kkt < p.d_tol) | (step < p.p_tol * 1e-2)
            u_f = _sel(live, u_n, u_f)
            l_a = _sel(live, l_n, l_a)
            kkt_last = torch.where(live, kkt, kkt_last)
            it = it + live.long()
            done = done | (live & conv)
        self.last_br_kkt[a] = kkt_last
        self.last_br_iters[a] = it
        return u_f

    def _solve_core(self, u0, x0, up, P=None) -> IBRResult:
        """``ibr_iters`` Gauss-Seidel sweeps over the agents' best responses."""
        p = self.params
        u = torch.as_tensor(u0, dtype=self.dtype, device=self.device)
        B = u.shape[0]
        delta = torch.full((B,), float('inf'), dtype=self.dtype, device=self.device)
        conv = torch.zeros(B, dtype=torch.bool, device=self.device)
        for _ in range(p.ibr_iters):
            u_prev = u
            for a in range(self.M):
                u = self._solve_br(a, u, x0, up, P)
            delta = torch.amax(torch.abs(u - u_prev), dim=-1)
            conv = conv | (delta < p.p_tol)
        return IBRResult(u, conv, torch.full((B,), p.ibr_iters, dtype=torch.long,
                                             device=self.device), delta)

    # ------------------------------------------------------------- host interface
    def initialize(self):
        pass

    def set_warm_start(self, u_ws):
        """Accepts a list of per-agent (N, n_ua) arrays or one (N, n_u) stage matrix."""
        if isinstance(u_ws, (list, tuple)):
            self.u_ws = np.concatenate([np.asarray(ua).ravel() for ua in u_ws])
        else:
            u_ws = np.asarray(u_ws)
            parts = []
            off = 0
            for a in range(self.M):
                na = self.problem.num_ua_d[a]
                parts.append(u_ws[:, off:off + na].ravel())
                off += na
            self.u_ws = np.concatenate(parts)

    def solve(self, states: List[VehicleState], parameters=None):
        """One game from the stored warm start, as a batch of one."""
        t0 = time.time()
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=self.dtype,
                                      device=self.device)[None]
        x0 = t(self.joint_dynamics.state2q(states))
        up = t(np.zeros(self.n_u))
        res = self._solve_core(t(self.u_ws), x0, up, parameters)
        self.q_pred = self.problem.rollout(res.u, x0)[0].cpu().numpy()
        self.u_pred = self.problem.u_to_stage(res.u)[0].cpu().numpy()
        dur = time.time() - t0
        msg = 'converged' if bool(res.converged[0]) else 'max_it'
        self.print_method(f'IBR status: {msg} | delta: {float(res.delta[0]):.3e}')
        return dict(time=dur, status=bool(res.converged[0]), msg=msg,
                    u_sol=res.u[0].cpu().numpy(), delta=float(res.delta[0]))

    def step(self, states: List[VehicleState], parameters=None):
        info = self.solve(states, parameters)
        self.joint_dynamics.qu2state(states, None, self.u_pred[0])
        self.state_input_predictions = self.joint_dynamics.qu2prediction(
            self.state_input_predictions, self.q_pred, self.u_pred)
        return info

    def get_prediction(self):
        return self.state_input_predictions
