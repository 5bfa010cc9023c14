"""ALGAMES baseline: the augmented-Lagrangian game solver (Le Cleac'h et al.), ported
from ``dgsqp_tpu/solvers/algames.py``.

The decision is the full primal-dual trajectory ``y = [q_1..q_N | u_0..u_{N-1} |
m^1..m^M]`` (states, inputs and per-agent dynamics multipliers); inequality constraints
enter an augmented Lagrangian with per-row penalty masking, and each inner problem is
solved by a regularized Newton method with a backtracking search on the residual norm.

Every method takes a batch (a leading game dimension).  The JAX version vmaps three
nested ``lax.while_loop``s (outer AL iterations, inner Newton iterations, the
backtracking search); here each loop advances the batch in lockstep with a per-game mask
at its level and ends when no game is left in it.  The Newton matrix is the Jacobian of
the residual by forward pushes of blocks of basis vectors (every game seeded with the
same vector, as ``game_problem._jac_fwd`` does), and its solve is
``torch.linalg.solve_ex`` (a singular matrix gives non-finite steps, as
``jnp.linalg.solve`` does, never an error).  The backtracking search evaluates several
trials per call (``solvers/backtrack.py``) with the sequential search's outcome.
"""
from __future__ import annotations

import time
from typing import List, NamedTuple

import numpy as np
import torch
from torch.func import jvp, vmap

from dgsqp_torch.solvers.backtrack import backtrack
from dgsqp_torch.solvers.chunked import run_chunked_compacted
from dgsqp_torch.solvers.game_problem import (_as_stage_list, _call_stage, _call_term,
                                              _group_stages, _jac_rev)
from dgsqp_torch.solvers.solver_types import ALGAMESParams
from dgsqp_torch.types import VehiclePrediction, VehicleState

RUNNING, CONV_ABS, CONV_REL, DIVERGED, MAX_IT = 0, 1, 2, 3, 5
STATUS_MSG = {CONV_ABS: 'conv_abs_tol', CONV_REL: 'conv_rel_tol', DIVERGED: 'diverged',
              MAX_IT: 'max_it', RUNNING: 'running'}
# consecutive outer iterations with small (u, lam, m) changes for a conv_rel exit
REL_TOL_REQ = 5
# the Newton matrix's forward pushes are taken in blocks of basis vectors whose tangents
# (block x games x n_y) hold at most this many elements (a push's intermediates scale
# with it)
PUSH_ELEMS = 1 << 24


class ALGAMESResult(NamedTuple):
    q: torch.Tensor        # (B, N+1, n_q) incl. x0
    u: torch.Tensor        # (B, N, n_u)
    lam: torch.Tensor      # (B, n_c)
    m: torch.Tensor        # (B, M, N*n_q)
    status: torch.Tensor
    iters: torch.Tensor
    newton_solves: torch.Tensor
    p_feas: torch.Tensor
    comp: torch.Tensor
    stat: torch.Tensor


class OuterCarry(NamedTuple):
    """Per-game state of the outer AL loop (the chunkable unit)."""
    y: torch.Tensor
    lam: torch.Tensor
    rho_val: torch.Tensor
    i: torch.Tensor
    status: torch.Tensor
    rel_its: torch.Tensor
    newton_total: torch.Tensor
    p_feas: torch.Tensor
    comp: torch.Tensor
    stat: torch.Tensor


def _sel(mask, a, b):
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _jac_fwd_cols(f, y, cols):
    """Columns ``cols`` of the per-game Jacobian of a batch-separable ``f``:
    ``y`` (B, n) -> (B, m, len(cols)), by forward pushes of those basis vectors, as many
    at a time as ``PUSH_ELEMS`` allows; returns the Jacobian and ``f(y)``, the pushes'
    primal output."""
    block = max(1, PUSH_ELEMS // max(1, y.numel()))
    eye = torch.eye(y.shape[-1], dtype=y.dtype, device=y.device)
    parts = []
    for s in range(0, len(cols), block):
        basis = eye[cols[s:s + block]]
        primal, tangents = vmap(lambda e: jvp(f, (y,), (e.expand_as(y),)))(basis)
        parts.append(tangents.movedim(0, -1))
    return torch.cat(parts, dim=-1), primal[0]


class ALGAMES:
    """Batched ALGAMES.  Entry points run on ``device`` (default the card) in ``dtype``;
    pass ``device='cpu'`` to run on the CPU."""

    def __init__(self, joint_dynamics, costs, constraints, bounds,
                 params: ALGAMESParams = None, xy_plot=None, print_method=print,
                 dtype=torch.float32, device='cuda'):
        params = params or ALGAMESParams()
        self.params = params
        self.device = torch.device(device)
        if self.device.type == 'cuda':
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.dtype = dtype
        self.joint_dynamics = joint_dynamics
        self.M = joint_dynamics.n_a
        self.N = params.N
        self.n_q = joint_dynamics.n_q
        self.n_u = joint_dynamics.n_u
        self.num_ua_d = joint_dynamics.num_ua_d
        self.u_offsets = joint_dynamics.u_offsets
        self.print_method = (lambda s: None) if print_method is None else print_method

        if len(costs) != self.M:
            raise ValueError(f'{self.M} agents but {len(costs)} cost specs')
        self.costs = [_as_stage_list(c, self.N) for c in costs]
        self.constraints = _as_stage_list(constraints, self.N)

        # joint box bounds
        st_ub, in_ub = zip(*[m.state2qu(s) for m, s in
                             zip(joint_dynamics.dynamics_models, bounds['ub'])])
        st_lb, in_lb = zip(*[m.state2qu(s) for m, s in
                             zip(joint_dynamics.dynamics_models, bounds['lb'])])
        self.state_ub, self.input_ub = np.concatenate(st_ub), np.concatenate(in_ub)
        self.state_lb, self.input_lb = np.concatenate(st_lb), np.concatenate(in_lb)
        self.state_ub_idxs = np.where(self.state_ub < np.inf)[0]
        self.state_lb_idxs = np.where(self.state_lb > -np.inf)[0]
        self.input_ub_idxs = np.where(self.input_ub < np.inf)[0]
        self.input_lb_idxs = np.where(self.input_lb > -np.inf)[0]

        self._count_constraints()

        self.q_pred = np.zeros((self.N + 1, self.n_q))
        self.u_pred = np.zeros((self.N, self.n_u))
        self.q_ws = None
        self.u_ws = None
        self.u_prev = np.zeros(self.n_u)
        self.state_input_predictions = [VehiclePrediction() for _ in range(self.M)]
        self.last_chunk_history = None
        self.initialized = True

    def _t(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # ------------------------------------------------------------ problem pieces
    def _count_constraints(self):
        """Count the rows and build the assembly plan: stage groups of the nonlinear
        constraints and the gather that puts the pieces into ALGAMES row order (per
        stage k: [nonlinear, input-ub, input-lb, state-ub, state-lb], then the terminal
        [nonlinear, state-ub, state-lb])."""
        N = self.N
        x_z = torch.zeros(self.n_q, dtype=torch.float64)
        u_z = torch.zeros(self.n_u, dtype=torch.float64)
        n_nl = np.zeros(N + 1, dtype=int)
        for k in range(N):
            if self.constraints[k] is not None:
                n_nl[k] = int(_call_stage(self.constraints[k], x_z, u_z, u_z, None, k).numel())
        if self.constraints[N] is not None:
            n_nl[N] = int(_call_term(self.constraints[N], x_z, None, N).numel())

        n_iub, n_ilb = len(self.input_ub_idxs), len(self.input_lb_idxs)
        n_sub, n_slb = len(self.state_ub_idxs), len(self.state_lb_idxs)
        nl_dest = [None] * (N + 1)
        iub_dest = np.zeros((N, n_iub), dtype=int)
        ilb_dest = np.zeros((N, n_ilb), dtype=int)
        sub_dest = np.zeros((N + 1, n_sub), dtype=int)
        slb_dest = np.zeros((N + 1, n_slb), dtype=int)
        off = 0
        for k in range(N):
            nl_dest[k] = np.arange(off, off + n_nl[k]); off += n_nl[k]
            iub_dest[k] = np.arange(off, off + n_iub); off += n_iub
            ilb_dest[k] = np.arange(off, off + n_ilb); off += n_ilb
            sub_dest[k] = np.arange(off, off + n_sub); off += n_sub
            slb_dest[k] = np.arange(off, off + n_slb); off += n_slb
        nl_dest[N] = np.arange(off, off + n_nl[N]); off += n_nl[N]
        sub_dest[N] = np.arange(off, off + n_sub); off += n_sub
        slb_dest[N] = np.arange(off, off + n_slb); off += n_slb
        self.n_c = int(off)

        long = torch.long
        dests = []
        self._nl_groups = []
        for fn, ks in _group_stages(self.constraints[:N]):
            self._nl_groups.append((fn, self._t(ks, long)))
            dests.append(np.stack([nl_dest[k] for k in ks]).reshape(-1))
        for arr in (iub_dest, ilb_dest, sub_dest, slb_dest):
            if arr.shape[1]:
                dests.append(arr.reshape(-1))
        self._nl_term = self.constraints[N] if n_nl[N] else None
        if n_nl[N]:
            dests.append(nl_dest[N])
        dest = np.concatenate(dests) if dests else np.zeros(0, int)
        if not np.array_equal(np.sort(dest), np.arange(self.n_c)):
            raise RuntimeError('constraint plan does not cover every row exactly once')
        self._c_src = self._t(np.argsort(dest), long)

        dt = self.dtype
        self._iub_idx = self._t(self.input_ub_idxs, long)
        self._ilb_idx = self._t(self.input_lb_idxs, long)
        self._sub_idx = self._t(self.state_ub_idxs, long)
        self._slb_idx = self._t(self.state_lb_idxs, long)
        self._iub_v = self._t(self.input_ub[self.input_ub_idxs], dt)
        self._ilb_v = self._t(self.input_lb[self.input_lb_idxs], dt)
        self._sub_v = self._t(self.state_ub[self.state_ub_idxs], dt)
        self._slb_v = self._t(self.state_lb[self.state_lb_idxs], dt)
        self._cost_groups = [[(fn, self._t(ks, long))
                              for fn, ks in _group_stages(self.costs[a][:N])]
                             for a in range(self.M)]

    def _um(self, u_all, u_prev):
        return torch.cat([u_prev[:, None], u_all[:, :-1]], dim=1)

    def _costs_all(self, q_all, u_all, u_prev):
        """Per-agent horizon costs (B, M).  q_all (B, N+1, n_q); u_all (B, N, n_u)."""
        um_mat = self._um(u_all, u_prev)
        J = []
        for a in range(self.M):
            sl = slice(self.u_offsets[a], self.u_offsets[a + 1])
            ua, uma = u_all[:, :, sl], um_mat[:, :, sl]
            Ja = q_all.new_zeros(q_all.shape[0])
            for fn, ks in self._cost_groups[a]:
                Ja = Ja + torch.sum(_call_stage(fn, q_all[:, ks], ua[:, ks], uma[:, ks],
                                                None, ks), dim=-1)
            if self.costs[a][self.N] is not None:
                Ja = Ja + _call_term(self.costs[a][self.N], q_all[:, self.N], None, self.N)
            J.append(Ja)
        return torch.stack(J, dim=-1)

    def _dyn_residual(self, q_all, u_all):
        """D_k = q_{k+1} - fd(q_k, u_k), flattened (B, N*n_q)."""
        pred = self.joint_dynamics.fd(q_all[:, :-1], u_all)
        return (q_all[:, 1:] - pred).reshape(q_all.shape[0], -1)

    def _constraints(self, q_all, u_all, u_prev):
        """Joint inequality stack in ALGAMES row order: (B, n_c)."""
        B = q_all.shape[0]
        um_mat = self._um(u_all, u_prev)
        pieces = []
        for fn, ks in self._nl_groups:
            pieces.append(_call_stage(fn, q_all[:, ks], u_all[:, ks], um_mat[:, ks], None, ks)
                          .reshape(B, -1))
        if len(self.input_ub_idxs):
            pieces.append((u_all[:, :, self._iub_idx] - self._iub_v).reshape(B, -1))
        if len(self.input_lb_idxs):
            pieces.append((self._ilb_v - u_all[:, :, self._ilb_idx]).reshape(B, -1))
        if len(self.state_ub_idxs):
            pieces.append((q_all[:, :, self._sub_idx] - self._sub_v).reshape(B, -1))
        if len(self.state_lb_idxs):
            pieces.append((self._slb_v - q_all[:, :, self._slb_idx]).reshape(B, -1))
        if self._nl_term is not None:
            pieces.append(_call_term(self._nl_term, q_all[:, self.N], None, self.N)
                          .reshape(B, -1))
        if not pieces:
            return q_all.new_zeros(B, 0)
        return torch.cat(pieces, dim=-1)[:, self._c_src]

    # --------------------------------------------------------- stacked gradients
    def _unpack(self, y, x0):
        """y = [q_1..q_N | u_0..u_{N-1} | m^1..m^M] -> (q_all, u_all, m)."""
        N, n_q, n_u = self.N, self.n_q, self.n_u
        B = y.shape[0]
        q = y[:, :N * n_q].reshape(B, N, n_q)
        u = y[:, N * n_q:N * (n_q + n_u)].reshape(B, N, n_u)
        m = y[:, N * (n_q + n_u):].reshape(B, self.M, N * n_q)
        return torch.cat([x0[:, None], q], dim=1), u, m

    def _agent_grad_blocks(self, scalar_fn, y):
        """For each agent a: the gradient of ``scalar_fn(y)[:, a]`` with respect to
        [q_1..q_N, u^a], stacked over the agents (one reverse sweep with M seeds)."""
        N, n_q, n_u = self.N, self.n_q, self.n_u
        g = _jac_rev(scalar_fn, y)                       # (B, M, n_y)
        B = y.shape[0]
        gu = g[:, :, N * n_q:N * (n_q + n_u)].reshape(B, self.M, N, n_u)
        blocks = []
        for a in range(self.M):
            gua = gu[:, a, :, self.u_offsets[a]:self.u_offsets[a + 1]].reshape(B, -1)
            blocks.append(torch.cat([g[:, a, :N * n_q], gua], dim=-1))
        return torch.cat(blocks, dim=-1)

    def _L_full(self, y, x0, u_prev, lam, rho):
        """Every agent's augmented Lagrangian incl. m^a'D: (B, M)."""
        q_all, u, m = self._unpack(y, x0)
        J = self._costs_all(q_all, u, u_prev)
        D = self._dyn_residual(q_all, u)
        C = self._constraints(q_all, u, u_prev)
        return J + _dot(m, D[:, None, :]) + _dot(lam, C)[:, None] \
            + 0.5 * _dot(rho * C, C)[:, None]

    def _L_gn(self, y, x0, u_prev, lam, rho):
        """The Gauss-Newton variant without m'D (drops the dynamics Hessians): (B, M)."""
        q_all, u, m = self._unpack(y, x0)
        J = self._costs_all(q_all, u, u_prev)
        C = self._constraints(q_all, u, u_prev)
        return J + _dot(lam, C)[:, None] + 0.5 * _dot(rho * C, C)[:, None]

    def _G(self, y, x0, u_prev, lam, rho):
        """Full residual: per-agent Lagrangian gradients + dynamics defects (B, n_y)."""
        grads = self._agent_grad_blocks(lambda yy: self._L_full(yy, x0, u_prev, lam, rho), y)
        q_all, u, _ = self._unpack(y, x0)
        return torch.cat([grads, self._dyn_residual(q_all, u)], dim=-1)

    def _G2(self, y, x0, u_prev, lam, rho):
        """The residual with the Gauss-Newton gradients (no m'D term)."""
        grads = self._agent_grad_blocks(lambda yy: self._L_gn(yy, x0, u_prev, lam, rho), y)
        q_all, u, _ = self._unpack(y, x0)
        return torch.cat([grads, self._dyn_residual(q_all, u)], dim=-1)

    def _G_prox(self, y, x0, u_prev, lam, rho, q_reg, u_reg, y_ref):
        """Residual with per-game proximal regularization (q_reg, u_reg (B,)) centered
        at the pre-step point ``y_ref``."""
        N, n_q, n_u = self.N, self.n_q, self.n_u
        B = y.shape[0]
        G = self._G(y, x0, u_prev, lam, rho)
        n_prim_q = N * n_q
        dq = y[:, :n_prim_q] - y_ref[:, :n_prim_q]
        du_all = (y[:, n_prim_q:N * (n_q + n_u)]
                  - y_ref[:, n_prim_q:N * (n_q + n_u)]).reshape(B, N, n_u)
        parts = []
        off = 0
        for a in range(self.M):
            size = n_prim_q + N * self.num_ua_d[a]
            dua = du_all[:, :, self.u_offsets[a]:self.u_offsets[a + 1]].reshape(B, -1)
            prox = torch.cat([q_reg[:, None] * dq, u_reg[:, None] * dua], dim=-1)
            parts.append(G[:, off:off + size] + prox)
            off += size
        parts.append(G[:, off:])
        return torch.cat(parts, dim=-1)

    def _newton_system(self, y, x0, u_prev, lam, rho, q_reg, u_reg):
        """The Newton matrix + diag(reg) (q_reg, u_reg (B,)) and the residual ``_G`` at
        ``y`` (the primal output of the residual's pushes).

        ``dynamics_hessians=False`` (default): the primal columns from the Gauss-Newton
        residual (per-agent gradients without m'D), the dual columns from the full one.
        ``dynamics_hessians=True``: the exact Jacobian of the residual."""
        N, n_q, n_u = self.N, self.n_q, self.n_u
        n_y = y.shape[-1]
        n_prim = N * (n_q + n_u)
        G = lambda yy: self._G(yy, x0, u_prev, lam, rho)
        if self.params.dynamics_hessians:
            H, G_y = _jac_fwd_cols(G, y, np.arange(n_y))
        else:
            G2 = lambda yy: self._G2(yy, x0, u_prev, lam, rho)
            H_m, G_y = _jac_fwd_cols(G, y, np.arange(n_prim, n_y))
            H = torch.cat([_jac_fwd_cols(G2, y, np.arange(n_prim))[0], H_m], dim=-1)
        B = y.shape[0]
        reg = torch.cat([q_reg[:, None].expand(B, N * n_q), u_reg[:, None].expand(B, N * n_u),
                         y.new_zeros(B, n_y - n_prim)], dim=-1)
        return H + torch.diag_embed(reg), G_y

    # ----------------------------------------------------------------- core loop
    def _init_outer_carry(self, q_ws, u_ws) -> OuterCarry:
        p, dt, dev = self.params, self.dtype, self.device
        q_ws = torch.as_tensor(q_ws, dtype=dt, device=dev)
        u_ws = torch.as_tensor(u_ws, dtype=dt, device=dev)
        B = q_ws.shape[0]
        y0 = torch.cat([q_ws[:, 1:].reshape(B, -1), u_ws.reshape(B, -1),
                        torch.zeros(B, self.M * self.N * self.n_q, dtype=dt, device=dev)],
                       dim=-1)
        full = lambda v, dtype=dt: torch.full((B,), v, dtype=dtype, device=dev)
        inf = float('inf')
        return OuterCarry(y=y0, lam=torch.zeros(B, self.n_c, dtype=dt, device=dev),
                          rho_val=full(p.rho), i=full(0, torch.long),
                          status=full(RUNNING, torch.int32), rel_its=full(0, torch.long),
                          newton_total=full(0, torch.long), p_feas=full(inf),
                          comp=full(inf), stat=full(inf))

    def _finalize_outer(self, c: OuterCarry, x0) -> ALGAMESResult:
        q_all, u, m = self._unpack(c.y, x0)
        return ALGAMESResult(q_all, u, c.lam, m, c.status, c.i, c.newton_total,
                             c.p_feas, c.comp, c.stat)

    def _opt_vio(self, y, x0, u_prev, lam, rho):
        grads = self._agent_grad_blocks(lambda yy: self._L_full(yy, x0, u_prev, lam, rho), y)
        return torch.amax(torch.abs(grads), dim=-1)

    def _line_search(self, live, y, dy, norm_G, x0, u_prev, lam, rho_bar, q_reg, u_reg):
        """Backtracking on the proximal residual norm for the games in ``live``: the
        first alpha of 1, tau, tau^2, ... (``line_search_iters`` trials) passing the
        test; when none passes, the alpha after the last trial (the reference accepts
        it).  Returns (alpha, accepted)."""
        p = self.params
        n_y = y.shape[-1]

        def accept(sel, a_t):
            n, T = a_t.shape
            rep = lambda v: v[sel][:, None].expand(n, T, *v.shape[1:]).reshape(
                n * T, *v.shape[1:])
            y_try = (y[sel][:, None] + a_t[:, :, None] * dy[sel][:, None]).reshape(n * T, -1)
            Gt = self._G_prox(y_try, rep(x0), rep(u_prev), rep(lam), rep(rho_bar),
                              rep(q_reg), rep(u_reg), rep(y)).reshape(n, T, -1)
            return torch.sum(torch.abs(Gt), dim=-1) / n_y \
                <= (1 - a_t * p.beta) * norm_G[sel][:, None]

        return backtrack(accept, live, p.line_search_iters, p.tau, y.dtype, y.device)

    def _newton_loop(self, y, lam, rho_val, x0, u_prev, running):
        """The inner regularized-Newton loop of the games in ``running``; returns the
        new y and each game's Newton iteration count."""
        p = self.params
        N, n_q, n_u = self.N, self.n_q, self.n_u
        n_y = y.shape[-1]
        B = y.shape[0]
        j = torch.zeros(B, dtype=torch.long, device=y.device)
        done = ~running
        while True:
            live = ~done & (j < p.newton_iters)
            if not bool(live.any()):
                break
            q_all, u, _ = self._unpack(y, x0)
            C = self._constraints(q_all, u, u_prev)
            rho_bar = torch.where((C < 0) & (lam == 0), 0.0, rho_val[:, None])

            sched = (j + 1).to(self.dtype) ** 4
            q_reg, u_reg = p.q_reg * sched, p.u_reg * sched
            H, G = self._newton_system(y, x0, u_prev, lam, rho_bar, q_reg, u_reg)
            # the stationarity violation: the agents' gradient blocks of the residual
            conv_stat = torch.amax(torch.abs(G[:, :n_y - N * n_q]), dim=-1) < p.opt_tol
            dy = -torch.linalg.solve_ex(H, G[..., None], check_errors=False)[0][..., 0]
            norm_G = torch.sum(torch.abs(G), dim=-1) / n_y

            upd = live & ~conv_stat
            alpha, ls_ok = self._line_search(upd, y, dy, norm_G, x0, u_prev, lam, rho_bar,
                                             q_reg, u_reg)
            y_new = y + alpha[:, None] * dy
            # average step size over the (q, u) blocks
            d = alpha * torch.sum(torch.abs(dy[:, :N * (n_q + n_u)]), dim=-1) / ((n_q + n_u) * N)
            conv_step = d < p.newton_step_tol

            y = _sel(upd, y_new, y)
            done = done | (live & (conv_stat | (upd & (conv_step | ~ls_ok))))
            j = j + live.long()
        return y, j

    def _outer_body(self, c: OuterCarry, x0, u_prev) -> OuterCarry:
        """One outer AL iteration (inner Newton loop + dual ascent) of every game."""
        p = self.params
        N, n_q, n_u = self.N, self.n_q, self.n_u
        running = c.status == RUNNING

        y_prev, lam_prev = c.y, c.lam
        y_new, n_newton = self._newton_loop(c.y, c.lam, c.rho_val, x0, u_prev, running)

        q_all, u, m = self._unpack(y_new, x0)
        C = self._constraints(q_all, u, u_prev)
        D = self._dyn_residual(q_all, u)
        rho_bar = torch.where((C < 0) & (c.lam == 0), 0.0, c.rho_val[:, None])
        max_ineq = torch.amax(torch.clamp(C, min=0.0), dim=-1)
        max_eq = torch.amax(torch.abs(D), dim=-1)
        opt_vio = self._opt_vio(y_new, x0, u_prev, c.lam, rho_bar)
        comp = torch.abs(_dot(c.lam, C))

        converged = (max_ineq < p.ineq_tol) & (max_eq < p.eq_tol) & \
            (comp < p.opt_tol) & (opt_vio < p.opt_tol)
        diverged = opt_vio > 1e5

        # relative-tolerance track on the (u, lam, m) changes
        nrm = lambda v: torch.linalg.vector_norm(v, dim=-1)
        s_u = slice(N * n_q, N * (n_q + n_u))
        s_m = slice(N * (n_q + n_u), None)
        small = (nrm(y_new[:, s_u] - y_prev[:, s_u]) < p.opt_tol / 2) & \
            (nrm(c.lam - lam_prev) < p.opt_tol / 2) & \
            (nrm(y_new[:, s_m] - y_prev[:, s_m]) < p.opt_tol / 2)
        rel_its = torch.where(small, c.rel_its + 1, 0)
        conv_rel = (rel_its >= REL_TOL_REQ) & (max_ineq < p.ineq_tol) & (max_eq < p.eq_tol)

        # dual ascent + penalty schedule
        lam_new = torch.clamp(c.lam + rho_bar * C, 0.0, p.lam_max)
        rho_new = torch.clamp(p.gamma * c.rho_val, max=p.rho_max)

        i_next = c.i + running.long()
        st = torch.where(i_next >= p.outer_iters, MAX_IT, RUNNING)
        st = torch.where(diverged, DIVERGED, st)
        st = torch.where(conv_rel, CONV_REL, st)
        st = torch.where(converged, CONV_ABS, st)
        status = torch.where(running, st, c.status).to(torch.int32)
        keep = running & ~converged & ~diverged & ~conv_rel

        return OuterCarry(y=_sel(running, y_new, c.y), lam=_sel(keep, lam_new, c.lam),
                          rho_val=torch.where(keep, rho_new, c.rho_val),
                          i=i_next, status=status,
                          rel_its=torch.where(running, rel_its, c.rel_its),
                          newton_total=c.newton_total + torch.where(running, n_newton, 0),
                          p_feas=torch.where(running, torch.maximum(max_ineq, max_eq),
                                             c.p_feas),
                          comp=torch.where(running, comp, c.comp),
                          stat=torch.where(running, opt_vio, c.stat))

    def solve_batch_chunked(self, q_ws, u_ws, x0, u_prev, chunk_iters: int = 1,
                            max_chunks=None, verbose: bool = False,
                            mesh=None) -> ALGAMESResult:
        """Batched solve as a host loop over chunks of ``chunk_iters`` outer AL
        iterations with straggler compaction between chunks (across ranks with a
        ``mesh`` of several: the inputs are then this rank's block, the result the whole
        batch's)."""
        def chunk_fn(c, x, u_p):
            for _ in range(chunk_iters):
                if not bool((c.status == RUNNING).any()):
                    break
                c = self._outer_body(c, x, u_p)
            return c

        carry = self._init_outer_carry(q_ws, u_ws)
        max_chunks = max_chunks or (self.params.outer_iters // chunk_iters + 2)
        res, history = run_chunked_compacted(
            carry, x0, u_prev, chunk_fn, final_fn=lambda c, x, u_p: self._finalize_outer(c, x),
            running_status=RUNNING, max_chunks=max_chunks, verbose=verbose,
            print_method=self.print_method, mesh=mesh)
        self.last_chunk_history = history
        return res

    def solve_batch_traced(self, q_ws, u_ws, x0, u_prev, num_iters=None,
                           record_iterates: bool = False):
        """Batched solve with a per-outer-iteration trace, for a fixed ``num_iters``
        outer iterations.  Returns ``(ALGAMESResult, trace)`` where ``trace`` holds (B, T)
        tensors ``status, i, p_feas, comp, stat, newton_solves, rho, du_norm,
        dlam_norm`` (+ ``u, lam`` of shape (B, T, n) with ``record_iterates``).  Frozen
        games repeat their terminal row."""
        T = int(num_iters or self.params.outer_iters)
        N, n_q, n_u = self.N, self.n_q, self.n_u
        s_u = slice(N * n_q, N * (n_q + n_u))
        c = self._init_outer_carry(q_ws, u_ws)
        recs = []
        for _ in range(T):
            c2 = self._outer_body(c, x0, u_prev)
            rec = dict(status=c2.status, i=c2.i, p_feas=c2.p_feas, comp=c2.comp,
                       stat=c2.stat, newton_solves=c2.newton_total, rho=c2.rho_val,
                       du_norm=torch.linalg.vector_norm(c2.y[:, s_u] - c.y[:, s_u], dim=-1),
                       dlam_norm=torch.linalg.vector_norm(c2.lam - c.lam, dim=-1))
            if record_iterates:
                rec['u'] = c2.y[:, s_u]
                rec['lam'] = c2.lam
            recs.append(rec)
            c = c2
        trace = {k: torch.stack([r[k] for r in recs], dim=1) for k in recs[0]}
        return self._finalize_outer(c, x0), trace

    # ------------------------------------------------------------- host interface
    def initialize(self):
        pass

    def set_warm_start(self, q_ws, u_ws, l_ws=None, m_ws=None):
        q_ws = np.asarray(q_ws)
        u_ws = np.asarray(u_ws)
        if q_ws.shape != (self.N + 1, self.n_q):
            raise RuntimeError(f'q warm start shape {q_ws.shape} != {(self.N + 1, self.n_q)}')
        if u_ws.shape != (self.N, self.n_u):
            raise RuntimeError(f'u warm start shape {u_ws.shape} != {(self.N, self.n_u)}')
        self.q_ws = q_ws
        self.u_ws = u_ws

    def solve(self, states: List[VehicleState]):
        """One game from the stored (q, u) warm start, as a batch of one."""
        t0 = time.time()
        if self.q_ws is None or self.u_ws is None:
            raise RuntimeError('ALGAMES requires a (q, u) warm start')
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=self.dtype,
                                      device=self.device)[None]
        x0 = t(self.joint_dynamics.state2q(states))
        c = self._init_outer_carry(t(self.q_ws), t(self.u_ws))
        up = t(self.u_prev)
        while bool((c.status == RUNNING).any()):
            c = self._outer_body(c, x0, up)
        res = self._finalize_outer(c, x0)
        self.q_pred = res.q[0].cpu().numpy()
        self.u_pred = res.u[0].cpu().numpy()
        status = int(res.status[0])
        msg = STATUS_MSG.get(status, 'unknown')
        dur = time.time() - t0
        self.print_method(f'Solve status: {msg}')
        self.print_method(f'Solve time: {dur:.2f}')
        return dict(time=dur, num_iters=int(res.iters[0]),
                    status=(status in (CONV_ABS, CONV_REL)),
                    cond=dict(p_feas=float(res.p_feas[0]), comp=float(res.comp[0]),
                              stat=float(res.stat[0])),
                    newton_solves=int(res.newton_solves[0]),
                    msg=msg, u_sol=res.u[0].cpu().numpy(), l_sol=res.lam[0].cpu().numpy())

    def step(self, states: List[VehicleState], env_state=None):
        info = self.solve(states)
        self.joint_dynamics.qu2state(states, None, self.u_pred[0])
        self.state_input_predictions = self.joint_dynamics.qu2prediction(
            self.state_input_predictions, self.q_pred, self.u_pred)
        for pred in self.state_input_predictions:
            pred.t = states[0].t
        self.u_prev = self.u_pred[0]
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)
        q_next = self.joint_dynamics.fd(t(self.q_pred[-1]), t(self.u_pred[-1])).cpu().numpy()
        q_ws = np.vstack((self.q_pred[1:], q_next[None]))
        u_ws = np.vstack((self.u_pred[1:], self.u_pred[-1:]))
        self.set_warm_start(q_ws, u_ws)
        return info

    def get_prediction(self):
        return self.state_input_predictions
