"""Mixed-complementarity baseline (the PATH-role oracle), ported from
``dgsqp_tpu/solvers/mcp.py``.

The game's KKT conditions form the MCP ``F(z) ⊥ lb <= z <= ub`` with ``z = (u, l)``,
``F = [D_{u^a} L^a stacked; -C]``, solved here on the penalized Fischer-Burmeister
reformulation

    Phi(z) = [ F_u(u, l);  phi(l, -C(u)) ]
    phi(a, b) = lam * (a + b - sqrt(a^2 + b^2 + eps^2)) + (1 - lam) * a_+ b_+

whose roots are the MCP solutions.  ``F_u = q + G'l`` and its Jacobian blocks (the
game Hessian Q and G) come from ``GameProblem.evaluate``.  Two cores:

  * ``fbnewton``: a smoothed FB semismooth-Newton step (Schur-reduced to the decision
    size, adaptive Levenberg shift), a steepest-descent safeguard, a nonmonotone Armijo
    search on a backtracking grid, proximal-perturbation restarts from the best point
    and eps continuation;
  * ``josephy``: the linearized MCP solved exactly per iteration as an indefinite QP
    (``solve_qp(indefinite=True, polish_iters=0)``, the Levenberg-LU branch), globalized
    by a nonmonotone watchdog on the sharp residual over a damped grid;

and ``hybrid``: the Josephy phase, then the FB phase from its end point, keeping phase 2
where its residual is no worse or it solved.

The JAX version vmaps a per-game ``lax.while_loop``; here a batch advances in lockstep:
each iteration updates every game, a game whose status left RUNNING keeps its carry
(``torch.where`` per field), and the host reads the statuses once per iteration to stop.
"""
from __future__ import annotations

import math
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_map

from dgsqp_torch.solvers.game_problem import GameProblem
from dgsqp_torch.solvers.qp import solve_qp
from dgsqp_torch.solvers.solver_types import PATHMCPParams
from dgsqp_torch.types import VehiclePrediction, VehicleState

RUNNING, SOLVED, DIVERGED, MAX_IT = 0, 1, 3, 5
STATUS_MSG = {SOLVED: 'MCP_Solved', DIVERGED: 'diverged', MAX_IT: 'max_it',
              RUNNING: 'running'}


class MCPResult(NamedTuple):
    u: torch.Tensor
    l: torch.Tensor
    status: torch.Tensor
    iters: torch.Tensor
    res: torch.Tensor
    p_feas: torch.Tensor
    comp: torch.Tensor
    stat: torch.Tensor


class FBCarry(NamedTuple):
    """Per-game state of the FB-Newton core (leading batch dimension)."""
    u: torch.Tensor
    l: torch.Tensor
    it: torch.Tensor
    status: torch.Tensor
    res: torch.Tensor
    reg: torch.Tensor        # adaptive Levenberg shift
    pert: torch.Tensor       # proximal perturbation strength
    ref_u: torch.Tensor      # proximal center
    ref_l: torch.Tensor
    best_u: torch.Tensor     # best unperturbed residual seen
    best_l: torch.Tensor
    best_res: torch.Tensor
    mem: torch.Tensor        # (B, R) last accepted perturbed merits
    stall: torch.Tensor      # consecutive iterations without material progress
    restarts: torch.Tensor
    eps: torch.Tensor        # FB smoothing (continuation parameter)


class JosephyCarry(NamedTuple):
    """Per-game state of the Josephy-Newton core (leading batch dimension)."""
    u: torch.Tensor
    l: torch.Tensor
    it: torch.Tensor
    status: torch.Tensor
    res: torch.Tensor
    best_u: torch.Tensor
    best_l: torch.Tensor
    best_res: torch.Tensor
    mem: torch.Tensor        # (B, R) last accepted sharp residuals
    stall: torch.Tensor
    restarts: torch.Tensor
    pert: torch.Tensor       # proximal perturbation (set on restart, decays)


def _sel(mask, a, b):
    """``torch.where`` with a per-game mask broadcast over trailing dimensions."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _mtv(M, v):
    return (M.transpose(-1, -2) @ v[..., None])[..., 0]


def _push(mem, v):
    """Drop the oldest entry of each game's memory and append ``v``."""
    return torch.cat([mem[:, 1:], v[:, None]], dim=-1)


class PATHMCP:
    """Semismooth-Newton MCP solver with the reference PATHMCP's interface.

    Entry points run on ``device`` (default the card) in ``dtype``; pass
    ``device='cpu'`` to run on the CPU.
    """

    def __init__(self, joint_dynamics, costs, agent_constraints, shared_constraints,
                 bounds, params: PATHMCPParams = None, print_method=print,
                 dtype=torch.float32, device='cuda'):
        params = params or PATHMCPParams()
        if params.method not in ('fbnewton', 'josephy', 'hybrid'):
            raise ValueError(f'unknown MCP method {params.method!r}')
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
        self.n_c = self.problem.n_c_total
        self.n_dec = self.problem.n_dec

        self.q_pred = np.zeros((self.N + 1, self.n_q))
        self.u_pred = np.zeros((self.N, self.n_u))
        self.l_pred = np.zeros(self.n_c)
        self.u_ws = np.zeros(self.N * self.n_u)
        self.l_ws = None
        self.state_input_predictions = [VehiclePrediction() for _ in range(self.M)]

        # approximate-game hook: fn(u, x0) -> MPCC parameter pytree, re-evaluated at
        # every F/J evaluation point (set by PATHMCPFrenetApprox)
        self._approx_update = None
        self.initialized = True

    # ------------------------------------------------------------- helpers
    @property
    def _f64(self) -> bool:
        return self.dtype == torch.float64

    def _eps_min(self) -> float:
        return 1e-10 if self._f64 else 1e-6

    def _P_of(self, u, x0, P):
        return self._approx_update(u, x0) if self._approx_update is not None else P

    def _phi(self, a, b, eps):
        """Penalized Fischer-Burmeister NCP function (Chen-Chen-Kanzow)."""
        lam = self.params.fb_lambda
        fb = a + b - torch.sqrt(a * a + b * b + eps * eps)
        if lam >= 1.0:
            return fb
        return lam * fb + (1.0 - lam) * torch.clamp(a, min=0.0) * torch.clamp(b, min=0.0)

    def _phi_derivs(self, a, b, eps):
        """Clarke-generalized partial derivatives (D_a, D_b) of the penalized FB."""
        lam = self.params.fb_lambda
        r = torch.sqrt(a * a + b * b + eps * eps)
        Da = 1.0 - a / r
        Db = 1.0 - b / r
        if lam >= 1.0:
            return Da, Db
        ap = torch.clamp(a, min=0.0)
        bp = torch.clamp(b, min=0.0)
        Da = lam * Da + (1.0 - lam) * bp * (a > 0)
        Db = lam * Db + (1.0 - lam) * ap * (b > 0)
        return Da, Db

    def _phi_cheap(self, u, l, x0, up, P, eps):
        """Jacobian-free Phi for the grid trials (``merit_terms``: one shared pass)."""
        d, g = self.problem.merit_terms(u, l, x0, up, self._P_of(u, x0, P))
        return torch.cat([d, self._phi(l, -g, eps)], dim=-1)

    def _grid(self, fn, u, l, du, dl, x0, up, ts):
        """``fn(u_t, l_t, x0_t, up_t, rep)`` of every game's trial points
        ``(u + t du, l + t dl)``, t in ``ts``, evaluated in one call: (B, W) values.
        ``rep`` repeats a per-game tensor over the trials."""
        B, W = u.shape[0], ts.shape[0]
        t3 = ts[None, :, None]
        u_t = (u[:, None] + t3 * du[:, None]).reshape(B * W, -1)
        l_t = (l[:, None] + t3 * dl[:, None]).reshape(B * W, -1)
        rep = lambda v: v[:, None].expand(B, W, *v.shape[1:]).reshape(B * W, *v.shape[1:])
        return fn(u_t, l_t, rep(x0), rep(up), rep).reshape(B, W)

    def _rep_P(self, P, rep):
        """A per-game parameter pytree repeated for the grid's trials (the
        approximate-game hook rebuilds it from the trial points instead)."""
        if P is None or self._approx_update is not None:
            return P
        return tree_map(rep, P)

    def _kkt(self, u, l, x0, up, P):
        """Final KKT conditions at the returned point: (p_feas, comp, stat)."""
        q, G, g, _ = self.problem.evaluate(u, l, x0, up, self._P_of(u, x0, P),
                                           hessian=False)
        d = q + _mtv(G, l)
        if self.n_c > 0:
            p_feas = torch.clamp(torch.amax(g, dim=-1), min=0.0)
            comp = torch.amax(torch.abs(g * l), dim=-1)
        else:
            p_feas = comp = q.new_zeros(q.shape[0])
        stat = torch.amax(torch.abs(d), dim=-1)
        return p_feas, comp, stat

    def _result(self, c, x0, up, P) -> MCPResult:
        """Return the best point seen, not the last iterate (PATH reports its best
        point), with its KKT conditions."""
        take_best = ((c.best_res < c.res) | ~torch.isfinite(c.res)) & (c.status != SOLVED)
        u = _sel(take_best, c.best_u, c.u)
        l = _sel(take_best, c.best_l, c.l)
        res = torch.where(take_best, c.best_res, c.res)
        return MCPResult(u, l, c.status, c.it, res, *self._kkt(u, l, x0, up, P))

    def _run(self, body, c, x0, up, P):
        # one host read of the statuses per iteration: a frozen game's carry is left as
        # it was, so the loop ends when no game runs
        while bool((c.status == RUNNING).any()):
            c = body(c, x0, up, P)
        return c

    # ------------------------------------------------------ FB-Newton core
    def _fb_init(self, u0, l0) -> FBCarry:
        p, dt, dev = self.params, self.dtype, self.device
        u0 = torch.as_tensor(u0, dtype=dt, device=dev)
        l0 = torch.clamp(torch.as_tensor(l0, dtype=dt, device=dev), min=0.0)
        B = u0.shape[0]
        full = lambda v, dtype=dt: torch.full((B,), v, dtype=dtype, device=dev)
        return FBCarry(u=u0, l=l0, it=full(0, torch.long), status=full(RUNNING, torch.int32),
                       res=full(math.inf), reg=full(p.reg), pert=full(0.0),
                       ref_u=u0, ref_l=l0, best_u=u0, best_l=l0, best_res=full(math.inf),
                       mem=torch.full((B, p.nonmono_memory), math.inf, dtype=dt, device=dev),
                       stall=full(0, torch.long), restarts=full(0, torch.long),
                       eps=full(p.eps0))

    def _fb_body(self, c: FBCarry, x0, up, P=None, max_iters: Optional[int] = None) -> FBCarry:
        """One FB-Newton iteration of every game."""
        p = self.params
        dt, dev = self.dtype, self.device
        n_dec = self.n_dec
        max_iters = p.max_iters if max_iters is None else max_iters
        eps_min, eps0 = self._eps_min(), p.eps0
        reg_lo = 1e-12 if self._f64 else 1e-7
        reg_hi = 1e4
        W, R = p.line_search_iters, p.nonmono_memory
        running = c.status == RUNNING
        col = lambda v: v[:, None]

        # full evaluation at the current smoothing; convergence and best-point tracking
        # use the sharp eps_min residual
        Q, q, G, g, _ = self.problem.evaluate(c.u, c.l, x0, up, self._P_of(c.u, x0, P),
                                              hessian=True)
        Fu = q + _mtv(G, c.l)
        b = -g
        phi = self._phi(c.l, b, col(c.eps))
        Da, Db = self._phi_derivs(c.l, b, col(c.eps))
        Phi0 = torch.cat([Fu, phi], dim=-1)
        res = torch.amax(torch.abs(torch.cat([Fu, self._phi(c.l, b, eps_min)], dim=-1)),
                         dim=-1)
        solved = res < p.tol
        diverged = (res > 1e10) | ~torch.isfinite(res)

        # perturbed system: Phi_p = Phi + pert*(z - ref), J_p = J + pert*I
        du_ref = c.u - c.ref_u
        dl_ref = c.l - c.ref_l
        Phi_p = Phi0 + col(c.pert) * torch.cat([du_ref, dl_ref], dim=-1)
        Fu_p = Fu + col(c.pert) * du_ref
        phi_p = phi + col(c.pert) * dl_ref
        merit0 = 0.5 * _dot(Phi_p, Phi_p)

        # Schur-reduced Newton step on the perturbed system:
        #   [[Q + pert I, G'], [-Db G, Da + pert + reg]] [du; dl] = -[Fu_p; phi_p]
        Dd = Da + col(c.pert + c.reg)
        w = Db / Dd
        eye = torch.eye(n_dec, dtype=dt, device=dev)
        Gt = G.transpose(-1, -2)
        K = Q + (c.pert + c.reg)[:, None, None] * eye + (Gt * w[:, None, :]) @ G
        rhs = -Fu_p + _mv(Gt, phi_p / Dd)
        # a singular K gives non-finite entries, which the mask below zeroes
        du = torch.linalg.solve_ex(K, rhs[..., None], check_errors=False)[0][..., 0]
        dl = (-phi_p + Db * _mv(G, du)) / Dd
        dz = torch.cat([du, dl], dim=-1)
        dz = torch.where(torch.isfinite(dz), dz, 0.0)

        # descent safeguard: gradient of the perturbed merit, J_p' Phi_p blockwise
        grad_u = _mtv(Q, Fu_p) + col(c.pert) * Fu_p - _mv(Gt, Db * phi_p)
        grad_l = _mv(G, Fu_p) + (Da + col(c.pert)) * phi_p
        grad = torch.cat([grad_u, grad_l], dim=-1)
        dpsi_newton = _dot(grad, dz)
        # exactly-scaled steepest descent: t* = ||grad||^2 / ||J grad||^2
        Jg_u = _mv(Q, grad_u) + col(c.pert) * grad_u + _mv(Gt, grad_l)
        Jg_l = -Db * _mv(G, grad_u) + (Da + col(c.pert)) * grad_l
        Jg2 = _dot(Jg_u, Jg_u) + _dot(Jg_l, Jg_l)
        g2 = _dot(grad, grad)
        t_star = g2 / torch.clamp(Jg2, min=1e-300)
        dz_grad = -col(t_star) * grad
        use_grad = (dpsi_newton > -1e-9 * _dot(dz, dz)) | ~torch.isfinite(dpsi_newton)
        dz = _sel(use_grad, dz_grad, dz)
        dpsi = torch.where(use_grad, -t_star * g2, dpsi_newton)

        # nonmonotone Armijo on a backtracking grid; unset memory slots (+inf) count as
        # the current merit
        merit_ref = torch.amax(torch.where(torch.isfinite(c.mem), c.mem, col(merit0)), dim=-1)
        alphas = torch.tensor(p.tau, dtype=dt, device=dev) ** \
            torch.arange(W, dtype=dt, device=dev)

        def merit(u_t, l_t, x_t, up_t, rep):
            Phi = self._phi_cheap(u_t, l_t, x_t, up_t, self._rep_P(P, rep),
                                  col(rep(c.eps)))
            Phi = Phi + col(rep(c.pert)) * torch.cat([u_t - rep(c.ref_u), l_t - rep(c.ref_l)],
                                                     dim=-1)
            return 0.5 * _dot(Phi, Phi)

        merits = self._grid(merit, c.u, c.l, dz[:, :n_dec], dz[:, n_dec:], x0, up, alphas)
        ok = merits <= col(merit_ref) + p.beta * alphas[None, :] * col(dpsi)
        any_ok = ok.any(-1)
        idx = torch.where(any_ok, torch.argmax(ok.to(torch.uint8), dim=-1), W - 1)
        alpha = alphas[idx]
        merit_new = merits.gather(1, idx[:, None])[:, 0]

        active = running & ~solved & ~diverged
        u_n = _sel(active, c.u + col(alpha) * dz[:, :n_dec], c.u)
        l_n = _sel(active, c.l + col(alpha) * dz[:, n_dec:], c.l)

        # adaptive regularization + stagnation accounting
        reg_n = torch.where(any_ok, torch.clamp(c.reg * 0.25, min=reg_lo),
                            torch.clamp(c.reg * 10.0, max=reg_hi))
        progressed = any_ok & (merit_new < 0.99 * merit0)
        stall_n = torch.where(progressed, 0, c.stall + 1)
        mem_n = _sel(any_ok, _push(c.mem, merit_new), c.mem)
        pert_n = c.pert * p.pert_decay
        # smoothing continuation toward eps_min as the sharp residual falls
        eps_n = torch.where(any_ok, torch.clamp(torch.minimum(c.eps * p.eps_decay,
                                                              p.eps_frac * res),
                                                eps_min, eps0), c.eps)

        # best-seen (unperturbed residual) tracking
        better = res < c.best_res
        best_u = _sel(better, c.u, c.best_u)
        best_l = _sel(better, c.l, c.best_l)
        best_res = torch.where(better, res, c.best_res)

        # proximal-perturbation restart
        do_restart = active & (stall_n >= p.stall_its) & (c.restarts < p.max_restarts)
        pert_restart = p.pert0 * (3.0 ** c.restarts.to(dt))
        u_n = _sel(do_restart, best_u, u_n)
        l_n = _sel(do_restart, best_l, l_n)
        ref_u_n = _sel(do_restart, best_u, c.ref_u)
        ref_l_n = _sel(do_restart, best_l, c.ref_l)
        pert_n = torch.where(do_restart, pert_restart, pert_n)
        reg_n = torch.where(do_restart, torch.full_like(reg_n, p.reg), reg_n)
        mem_n = _sel(do_restart, torch.full_like(mem_n, math.inf), mem_n)
        stall_n = torch.where(do_restart, 0, stall_n)
        restarts_n = c.restarts + do_restart.long()
        eps_n = torch.where(do_restart, torch.full_like(eps_n, eps0), eps_n)

        # stagnation past the restart budget terminates as max_it
        exhausted = active & (stall_n >= p.stall_its) & (c.restarts >= p.max_restarts)
        it_next = c.it + active.long()
        status_n = self._status(solved, diverged, (it_next >= max_iters) | exhausted)
        new = FBCarry(u_n, l_n, it_next, status_n, res, reg_n, pert_n, ref_u_n, ref_l_n,
                      best_u, best_l, best_res, mem_n, stall_n, restarts_n, eps_n)
        return FBCarry(*[_sel(running, nn, oo) for nn, oo in zip(new, c)])

    @staticmethod
    def _status(solved, diverged, stop):
        st = torch.where(stop, MAX_IT, RUNNING)
        st = torch.where(diverged, DIVERGED, st)
        return torch.where(solved, SOLVED, st).to(torch.int32)

    def _solve_core(self, u0, l0, x0, up, P=None, max_iters: Optional[int] = None) -> MCPResult:
        """The FB-Newton solve of a batch (``method='fbnewton'`` and hybrid phase 2)."""
        body = lambda c, x, u_p, PP: self._fb_body(c, x, u_p, PP, max_iters)
        c = self._run(body, self._fb_init(u0, l0), x0, up, P)
        return self._result(c, x0, up, P)

    # --------------------------------------------------- Josephy-Newton core
    def _jos_init(self, u0, l0) -> JosephyCarry:
        p, dt, dev = self.params, self.dtype, self.device
        u0 = torch.as_tensor(u0, dtype=dt, device=dev)
        l0 = torch.clamp(torch.as_tensor(l0, dtype=dt, device=dev), min=0.0)
        B = u0.shape[0]
        full = lambda v, dtype=dt: torch.full((B,), v, dtype=dtype, device=dev)
        return JosephyCarry(u=u0, l=l0, it=full(0, torch.long),
                            status=full(RUNNING, torch.int32), res=full(math.inf),
                            best_u=u0, best_l=l0, best_res=full(math.inf),
                            mem=torch.full((B, p.nonmono_memory), math.inf, dtype=dt,
                                           device=dev),
                            stall=full(0, torch.long), restarts=full(0, torch.long),
                            pert=full(0.0))

    def _jos_body(self, c: JosephyCarry, x0, up, P=None,
                  max_iters: Optional[int] = None) -> JosephyCarry:
        """One Josephy-Newton iteration of every game: the linearized MCP

            q + Q du + G' l_new = 0,    0 <= l_new  ⊥  -(g + G du) >= 0

        solved exactly as the KKT system of an indefinite QP with the unconvexified game
        matrix, then a nonmonotone watchdog on the sharp residual over a damped grid
        (the largest step whose residual stays below ``jos_gamma`` times the max of the
        last R accepted residuals, else the grid's best residual when it improves);
        stagnation restarts from the best point with a growing proximal shift."""
        p = self.params
        dt, dev = self.dtype, self.device
        max_iters = p.max_iters if max_iters is None else max_iters
        eps_min = self._eps_min()
        qp_tol = p.qp_tol if p.qp_tol is not None else (1e-8 if self._f64 else 3e-7)
        W = p.line_search_iters
        running = c.status == RUNNING
        col = lambda v: v[:, None]

        Q, q, G, g, _ = self.problem.evaluate(c.u, c.l, x0, up, self._P_of(c.u, x0, P),
                                              hessian=True)
        Fu = q + _mtv(G, c.l)
        phi = self._phi(c.l, -g, eps_min)
        res = torch.amax(torch.abs(torch.cat([Fu, phi], dim=-1)), dim=-1)
        solved = res < p.tol
        diverged = (res > 1e10) | ~torch.isfinite(res)

        # proximal perturbation centered at the current point (du = 0)
        Q_eff = Q + c.pert[:, None, None] * torch.eye(self.n_dec, dtype=dt, device=dev)
        sol = solve_qp(Q_eff, q, G, -g, tol=qp_tol, max_iters=p.qp_max_iters,
                       indefinite=True, polish_iters=0)
        du = torch.where(torch.isfinite(sol.x), sol.x, 0.0)
        dl = torch.where(torch.isfinite(sol.lam), sol.lam, c.l) - c.l

        res_ref = torch.amax(torch.where(torch.isfinite(c.mem), c.mem, col(res)), dim=-1)
        thetas = torch.tensor(p.tau, dtype=dt, device=dev) ** \
            torch.arange(W, dtype=dt, device=dev)

        def res_at(u_t, l_t, x_t, up_t, rep):
            Phi = self._phi_cheap(u_t, l_t, x_t, up_t, self._rep_P(P, rep), eps_min)
            return torch.amax(torch.abs(Phi), dim=-1)

        res_grid = self._grid(res_at, c.u, c.l, du, dl, x0, up, thetas)
        res_grid = torch.where(torch.isfinite(res_grid), res_grid, math.inf)
        ok = res_grid <= p.jos_gamma * col(res_ref)
        any_ok = ok.any(-1)
        idx = torch.where(any_ok, torch.argmax(ok.to(torch.uint8), dim=-1),
                          torch.argmin(res_grid, dim=-1))
        theta = thetas[idx]
        res_new = res_grid.gather(1, idx[:, None])[:, 0]
        take_fallback = ~any_ok & (res_new < 0.97 * res)
        step_ok = any_ok | take_fallback

        active = running & ~solved & ~diverged
        u_n = _sel(active & step_ok, c.u + col(theta) * du, c.u)
        l_n = _sel(active & step_ok, c.l + col(theta) * dl, c.l)
        mem_n = _sel(step_ok, _push(c.mem, res_new), c.mem)

        better = res < c.best_res
        best_u = _sel(better, c.u, c.best_u)
        best_l = _sel(better, c.l, c.best_l)
        best_res = torch.where(better, res, c.best_res)
        stall_n = torch.where(better | (res_new < best_res), 0, c.stall + 1)

        do_restart = active & (stall_n >= p.stall_its) & (c.restarts < p.max_restarts)
        u_n = _sel(do_restart, best_u, u_n)
        l_n = _sel(do_restart, best_l, l_n)
        mem_n = _sel(do_restart, torch.full_like(mem_n, math.inf), mem_n)
        stall_n = torch.where(do_restart, 0, stall_n)
        restarts_n = c.restarts + do_restart.long()
        # restart k perturbs with pert0 * 2^k; between restarts the shift decays
        pert_n = torch.where(do_restart, p.pert0 * (2.0 ** c.restarts.to(dt)),
                             c.pert * p.pert_decay)
        exhausted = active & (stall_n >= p.stall_its) & (c.restarts >= p.max_restarts)

        it_next = c.it + active.long()
        status_n = self._status(solved, diverged, (it_next >= max_iters) | exhausted)
        new = JosephyCarry(u_n, l_n, it_next, status_n, res, best_u, best_l, best_res,
                           mem_n, stall_n, restarts_n, pert_n)
        return JosephyCarry(*[_sel(running, nn, oo) for nn, oo in zip(new, c)])

    def _solve_core_josephy(self, u0, l0, x0, up, P=None,
                            max_iters: Optional[int] = None) -> MCPResult:
        """The Josephy-Newton solve of a batch (``method='josephy'``, hybrid phase 1)."""
        body = lambda c, x, u_p, PP: self._jos_body(c, x, u_p, PP, max_iters)
        c = self._run(body, self._jos_init(u0, l0), x0, up, P)
        return self._result(c, x0, up, P)

    # ------------------------------------------------------------ hybrid
    @staticmethod
    def _merge_hybrid(r1: MCPResult, r2: MCPResult) -> MCPResult:
        """Keep whichever phase ended better (the polish never worsens the answer)."""
        take2 = (r2.res <= r1.res) | (r2.status == SOLVED)
        pick = lambda a2, a1: _sel(take2, a2, a1)
        return MCPResult(pick(r2.u, r1.u), pick(r2.l, r1.l),
                         torch.where(take2, r2.status, r1.status).to(torch.int32),
                         r1.iters + r2.iters, pick(r2.res, r1.res),
                         pick(r2.p_feas, r1.p_feas), pick(r2.comp, r1.comp),
                         pick(r2.stat, r1.stat))

    def _solve_batch_hybrid(self, u0, l0, x0, up, P=None,
                            max_iters: Optional[int] = None) -> MCPResult:
        """Josephy-Newton phase, then the FB-Newton polish from its end point; iteration
        counts are summed and phase 2 is kept only where it does not worsen the
        residual (or solved)."""
        r1 = self._solve_core_josephy(u0, l0, x0, up, P, max_iters)
        r2 = self._solve_core(r1.u, r1.l, x0, up, P, max_iters)
        return self._merge_hybrid(r1, r2)

    def solve_batch(self, u0, l0, x0, up, P=None, max_iters: Optional[int] = None) -> MCPResult:
        """Solve a batch by ``params.method``: inputs are (B, ...) tensors on the
        solver's device.  ``max_iters`` caps each phase below ``params.max_iters`` (a
        game reaching it ends ``max_it``)."""
        m = self.params.method
        core = (self._solve_batch_hybrid if m == 'hybrid' else
                self._solve_core_josephy if m == 'josephy' else self._solve_core)
        return core(u0, l0, x0, up, P, max_iters)

    # ------------------------------------------------------------- host interface
    def initialize(self):
        pass

    def set_warm_start(self, u_ws: np.ndarray, l_ws=None):
        u_ws = np.asarray(u_ws)
        if u_ws.shape != (self.N, self.n_u):
            raise RuntimeError(f'Warm start shape {u_ws.shape} != {(self.N, self.n_u)}')
        parts = []
        off = 0
        for a in range(self.M):
            na = self.problem.num_ua_d[a]
            parts.append(u_ws[:, off:off + na].ravel())
            off += na
        self.u_ws = np.concatenate(parts)
        self.l_ws = l_ws

    def solve(self, states: List[VehicleState], parameters=None):
        """One game from the stored warm start, as a batch of one."""
        t0 = time.time()
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=self.dtype,
                                      device=self.device)[None]
        x0 = t(self.joint_dynamics.state2q(states))
        up = t(np.zeros(self.n_u))
        u0 = t(self.u_ws)
        if self.l_ws is not None:
            l0 = t(self.l_ws)
        else:
            l0 = self.problem.dual_warm_start(u0, x0, up, parameters)
        res = self.solve_batch(u0, l0, x0, up, parameters)

        self.q_pred = self.problem.rollout(res.u, x0)[0].cpu().numpy()
        self.u_pred = self.problem.u_to_stage(res.u)[0].cpu().numpy()
        self.l_pred = res.l[0].cpu().numpy()
        status = int(res.status[0])
        msg = STATUS_MSG.get(status, 'unknown')
        dur = time.time() - t0
        self.print_method(f'Solve status: {msg}')
        self.print_method(f'Solve time: {dur:.2f}')
        return dict(time=dur, num_iters=int(res.iters[0]), status=(status == SOLVED),
                    cond=dict(p_feas=float(res.p_feas[0]), comp=float(res.comp[0]),
                              stat=float(res.stat[0])),
                    msg=msg, u_sol=res.u[0].cpu().numpy(), l_sol=self.l_pred)

    def step(self, states: List[VehicleState], parameters=None):
        info = self.solve(states, parameters)
        self.joint_dynamics.qu2state(states, None, self.u_pred[0])
        self.state_input_predictions = self.joint_dynamics.qu2prediction(
            self.state_input_predictions, self.q_pred, self.u_pred)
        u_ws = np.vstack((self.u_pred[1:], self.u_pred[-1:]))
        self.set_warm_start(u_ws)
        return info

    def get_prediction(self):
        return self.state_input_predictions


class PATHMCPFrenetApprox(PATHMCP):
    """MCP baseline on the approximate (MPCC) game: the contouring/boundary
    approximation is re-linearized at every residual/Jacobian evaluation point inside
    the Newton and Josephy loops, so the MCP solved is the self-consistent approximate
    game.  A ``DGSQPV2FrenetApprox`` donor supplies the augmented costs and constraints
    and its ``_evaluate_mpcc``."""

    def __init__(self, joint_dynamics, costs, agent_constraints, shared_constraints,
                 bounds, params=None, print_method=print, q_c: float = 0.1,
                 q_l: float = 1000.0, dtype=torch.float32, device='cuda'):
        from dgsqp_torch.solvers.dgsqp_v2_frenet import DGSQPV2FrenetApprox
        from dgsqp_torch.solvers.solver_types import DGSQPV2Params
        params = params or PATHMCPParams()
        donor = DGSQPV2FrenetApprox(joint_dynamics, costs, agent_constraints,
                                    shared_constraints, bounds,
                                    DGSQPV2Params(N=params.N, dt=params.dt),
                                    print_method=None, q_c=q_c, q_l=q_l, dtype=dtype,
                                    device=device)
        super().__init__(joint_dynamics, donor.problem.costs,
                         donor.problem.agent_constraints,
                         donor.problem.shared_constraints, bounds, params,
                         print_method=print_method, dtype=dtype, device=device)
        self._donor = donor
        self._approx_update = donor._evaluate_mpcc
