"""CA-LTV-MPC, the convex-approximation linear-time-varying tracking MPC, ported from
``dgsqp_tpu/solvers/ca_ltv_mpc.py``.

The closed-loop race's trackers: each control step linearizes the dynamics and the
nonlinear constraints and quadratizes the costs around the warm-start rollout, solves
the QP, and damps the iterate, ``qp_iters`` times.  Its structure is the JAX version's:

  * decision vector ``D = [(q_k, u_{k-1})_{k=0..N}, (du_k)_{k=0..N-1}]`` with the
    input-rate coupling ``u_k = u_{k-1} + du_k``;
  * damped SQP iterations ``D <- damping*D + (1-damping)*D_bar``;
  * wrapped states (``np.unwrap`` on track progress), an input-delay buffer, soft
    constraints as slack variables with quadratic and linear penalties.

Two QP backends, as there: ``'riccati'`` (the default, ``'auto'``) solves the stage QP
with the Riccati OCP-QP (``solvers/ocp_qp.py``, soft constraints as slack stage
inputs); ``'dense'`` assembles the whole QP and solves it with ``solve_eq_qp``, the
linearized dynamics as equality rows.  The costs and constraints are torch callables of
one stage (``torch.func`` differentiates them, ``vmap`` over the stages):

    costs = {'state': [fn(q[, P])]*(N+1), 'input': [fn(u[, P])]*(N+1), 'rate': [fn(du)]*N}
    constraints = {'state_input': [fn(q, u[, P]) or None]*(N+1), 'rate': [fn(du) or None]*N}
    bounds = {'qu_ub': VehicleState, 'qu_lb': ..., 'du_ub': ..., 'du_lb': ...}

A callable marked ``stage_indexed`` also takes the stage index k (a tensor under
``vmap``), and ``n_out`` gives a constraint's row count without a probe call.  For the
dynamic bicycles the dynamics' linearization is one ``dyn_step(order=1)`` call over all
stages (``csrc/dyn_step.cu`` on the card); other models go through ``torch.func``.  The
warm-start shift, the progress unwrapping and the damping stay host numpy, as in the
JAX version, so that both packages take the same discrete decisions.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Optional

import numpy as np
import torch
from torch.func import grad, jacfwd, vmap

from dgsqp_torch.ops.dynamics import dyn_step
from dgsqp_torch.solvers.game_problem import _group_stages, _n_args
from dgsqp_torch.solvers.ocp_qp import solve_ocp_qp
from dgsqp_torch.solvers.qp import solve_eq_qp
from dgsqp_torch.solvers.solver_types import CALTVMPCParams
from dgsqp_torch.types import VehiclePrediction, VehicleState


def _call1(fn, x, P, k=None):
    n = _n_args(fn)
    if getattr(fn, 'stage_indexed', False):
        return fn(x, P, k)
    return fn(x, P) if n >= 2 else fn(x)


def _call2(fn, q, u, P, k=None):
    n = _n_args(fn)
    if getattr(fn, 'stage_indexed', False):
        return fn(q, u, P, k)
    return fn(q, u, P) if n >= 3 else fn(q, u)


_COST_REG = 1e-9    # Levenberg term on every quadratized cost block (both backends)


def _quadratize_group(fn, refs, ks, nb, P):
    """Per-stage quadratic model of a cost callable around its reference points:
    (M, m) with cost ~ 1/2 x'Mx + m'x + const.  Shared by both backends, so that their
    subproblems are linearized identically."""
    reg = _COST_REG * torch.eye(nb, dtype=refs.dtype, device=refs.device)

    def quad(x_ref, k):
        g_fn = grad(lambda xx: _call1(fn, xx, P, k))
        M = jacfwd(g_fn)(x_ref) + reg
        return M, g_fn(x_ref) - M @ x_ref

    return vmap(quad)(refs, ks)


def _linearize_group(fn, qs, us, ks, P):
    """Per-stage linearization of a nonlinear constraint callable: (vals, Jq, Ju).
    Shared by both backends."""

    def lin(qk, uk, k):
        c = lambda qq, uu: torch.atleast_1d(_call2(fn, qq, uu, P, k))
        Jq, Ju = jacfwd(c, argnums=(0, 1))(qk, uk)
        return c(qk, uk), Jq, Ju

    return vmap(lin)(qs, us, ks)


class CA_LTV_MPC:
    """The tracking MPC; it runs on ``device`` (default the card) in ``dtype``."""

    def __init__(self, dynamics, costs: Dict, constraints: Dict, bounds: Dict,
                 control_params: CALTVMPCParams = None, print_method=print,
                 dtype=torch.float64, device='cuda'):
        params = control_params or CALTVMPCParams()
        self.params = params
        self.dynamics = dynamics
        self.dt = dynamics.dt
        self.costs = costs
        self.constraints = constraints
        self.print_method = (lambda s: None) if print_method is None else print_method
        self.N = params.N
        self.n_q = dynamics.n_q
        self.n_u = dynamics.n_u
        self.n_z = self.n_q + self.n_u
        self.damping = params.damping
        self.qp_iters = params.qp_iters
        self.dtype = dtype
        self.device = torch.device(device)
        if self.device.type == 'cuda':
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        # box bounds
        self.state_ub, self.input_ub = dynamics.state2qu(bounds['qu_ub'])
        self.state_lb, self.input_lb = dynamics.state2qu(bounds['qu_lb'])
        _, self.du_ub = dynamics.state2qu(bounds['du_ub'])
        _, self.du_lb = dynamics.state2qu(bounds['du_lb'])

        self.soft_state_idxs = params.soft_state_bound_idxs
        self.soft_state_quad = np.array(params.soft_state_bound_quad) \
            if params.soft_state_bound_quad is not None else None
        self.soft_state_lin = np.array(params.soft_state_bound_lin) \
            if params.soft_state_bound_lin is not None else None

        self.wrapped_state_idxs = params.wrapped_state_idxs
        self.wrapped_state_periods = params.wrapped_state_periods

        self.delay = params.delay
        self.delay_buffer = None
        if self.delay is not None:
            self.delay_buffer = [deque([0.0] * int(round(d / self.dt)),
                                       maxlen=max(1, int(round(d / self.dt))))
                                 for d in self.delay]

        # constraint row counts: n_out, or a probe call at zeros (1024 zeros for P)
        self.n_c = [0] * (self.N + 1)
        cs = constraints.get('state_input', [None] * (self.N + 1))
        for k in range(self.N + 1):
            if cs[k] is not None:
                n_out = getattr(cs[k], 'n_out', None)
                if n_out is not None:
                    self.n_c[k] = int(n_out)
                else:
                    z = lambda n: torch.zeros(n, dtype=dtype)
                    out = _call2(cs[k], z(self.n_q), z(self.n_u), z(1024), k)
                    self.n_c[k] = int(torch.as_tensor(out).numel())

        self.u_ws = np.zeros((self.N + 1, self.n_u))
        self.du_ws = np.zeros((self.N, self.n_u))
        self.u_prev = np.zeros(self.n_u)
        self.q_pred = np.zeros((self.N + 1, self.n_q))
        self.u_pred = np.zeros((self.N, self.n_u))
        self.du_pred = np.zeros((self.N, self.n_u))
        self.state_input_prediction = None
        self.t = 0.0

        self._build_plan()
        backend = getattr(params, 'qp_backend', 'auto')
        if backend == 'auto':
            backend = 'riccati'
        self.qp_backend = backend
        if backend == 'riccati':
            self._build_riccati_plan()
            self._qp_step_fn = self._qp_step_riccati
        else:
            self._qp_step_fn = self._qp_step
        self.initialized = True

    def _t(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype or self.dtype, device=self.device)

    def _build_riccati_plan(self):
        """Stage-block layout for the structured backend.

        x~_k = (q_k, u_{k-1}) (the dense layout's z_k), v_k = (du_k, s_k); dynamics
        x~_{k+1} = [[A_k, B_k], [0, I]] x~_k + [[B_k], [I], 0] v_k + [g_k; 0].  Soft
        constraint slacks s_k are extra stage inputs (zero dynamics columns, quadratic
        and linear penalties in the stage cost, -1 coefficients in their constraint
        rows, nonnegativity rows), and a pass-through dynamics stage N (x~_{N+1} =
        x~_N) makes stage N interior so that its slacks exist.
        """
        N, n_q, n_u, n_z = self.N, self.n_q, self.n_u, self.n_z
        soft_state = list(self.soft_state_idxs or [])
        n_ss = len(soft_state)
        soft_c = list(self.params.soft_constraint_idxs or [])
        n_sc = len(soft_c)
        n_s = 2 * n_ss + n_sc
        nv = n_u + n_s
        self._ric_ns = n_s
        self._ric_nv = nv

        finite_ub = np.isfinite(np.concatenate([self.state_ub, self.input_ub]))
        finite_lb = np.isfinite(np.concatenate([self.state_lb, self.input_lb]))
        ub_idx = np.where(finite_ub)[0]
        lb_idx = np.where(finite_lb)[0]
        du_ub_idx = np.where(np.isfinite(self.du_ub))[0]
        du_lb_idx = np.where(np.isfinite(self.du_lb))[0]
        n_box = ub_idx.size + lb_idx.size
        n_du = du_ub_idx.size + du_lb_idx.size
        m_nl = max(self.n_c) if self.n_c else 0
        mi = n_box + n_du + n_s + max(m_nl, 1)
        self._ric_mi = mi
        qu_ub = np.concatenate([self.state_ub, self.input_ub])
        qu_lb = np.concatenate([self.state_lb, self.input_lb])

        # stages 0..N carry constraints; N+1 is the vacuous terminal of the dummy stage
        D0 = np.zeros((N + 2, mi, n_z))
        E0 = np.zeros((N + 2, mi, nv))
        b0 = np.ones((N + 2, mi))
        for k in range(N + 1):
            r = 0
            for j in ub_idx:
                D0[k, r, j], b0[k, r] = 1.0, qu_ub[j]
                if j < n_q and j in soft_state:
                    E0[k, r, n_u + 2 * soft_state.index(j)] = -1.0
                r += 1
            for j in lb_idx:
                D0[k, r, j], b0[k, r] = -1.0, -qu_lb[j]
                if j < n_q and j in soft_state:
                    E0[k, r, n_u + 2 * soft_state.index(j) + 1] = -1.0
                r += 1
            if k < N:
                for j in du_ub_idx:
                    E0[k, r, j], b0[k, r] = 1.0, self.du_ub[j]
                    r += 1
                for j in du_lb_idx:
                    E0[k, r, j], b0[k, r] = -1.0, -self.du_lb[j]
                    r += 1
            else:
                r += n_du
            for i in range(n_s):            # slack nonnegativity: -s_i <= 0
                E0[k, r, n_u + i], b0[k, r] = -1.0, 0.0
                r += 1
        # stage 0's x~ is fixed by the initial condition: boxing it adds nothing when
        # feasible and makes the QP infeasible when the measured state grazes a bound
        D0[0, :n_box] = 0.0
        E0[0, :n_box] = 0.0
        b0[0, :n_box] = 1.0
        nl_row0 = n_box + n_du + n_s      # first nonlinear row within each stage
        self._ric_nl_row0 = nl_row0

        # soft nonlinear rows: static -1 slack coefficient in the stage's nl block
        cs = self.constraints.get('state_input', [None] * (N + 1))
        for k in range(N + 1):
            for jj, c_idx in enumerate(soft_c):
                if cs[k] is not None and c_idx < self.n_c[k]:
                    E0[k, nl_row0 + c_idx, n_u + 2 * n_ss + jj] = -1.0
        self._ric_D0, self._ric_E0, self._ric_b0 = self._t(D0), self._t(E0), self._t(b0)
        # per-slack quadratic / linear penalty diagonals (stage cost on s_k)
        quad = np.zeros(n_s)
        lin = np.zeros(n_s)
        for jj in range(n_ss):
            quad[2 * jj] = quad[2 * jj + 1] = self.soft_state_quad[jj]
            lin[2 * jj] = lin[2 * jj + 1] = self.soft_state_lin[jj]
        for jj in range(n_sc):
            quad[2 * n_ss + jj] = self.params.soft_constraint_quad[jj]
            lin[2 * n_ss + jj] = self.params.soft_constraint_lin[jj]

        # the static parts of the stage cost and dynamics blocks
        eye_z = np.eye(n_z)
        Rv0 = np.zeros((N + 1, nv, nv)) + 1e-10 * np.eye(nv)
        # dummy stage N's du block is unconstrained and costless: pin it with a unit
        # quadratic so that the Riccati H_vv stays well conditioned (its optimum is 0)
        Rv0[N, :n_u, :n_u] += np.eye(n_u)
        rv0 = np.zeros((N + 1, nv))
        if n_s:
            Rv0[:, n_u:, n_u:] += np.diag(quad)
            rv0[:, n_u:] += lin
        At0 = np.zeros((N + 1, n_z, n_z))
        At0[:N, n_q:, n_q:] = np.eye(n_u)
        At0[N] = eye_z
        Bt0 = np.zeros((N + 1, n_z, nv))
        Bt0[:N, n_q:, :n_u] = np.eye(n_u)
        self._ric_Qx0 = self._t(np.zeros((N + 2, n_z, n_z)) + 1e-10 * eye_z)
        self._ric_Rv0, self._ric_rv0 = self._t(Rv0), self._t(rv0)
        self._ric_At0, self._ric_Bt0 = self._t(At0), self._t(Bt0)

    def _linearize_dynamics(self, q, u):
        """(fd, A, B) at the stage points q (K, n_q), u (K, n_u)."""
        if getattr(self.dynamics, 'fused_step', False):
            f, J, _ = dyn_step(self.dynamics, q.contiguous(), u.contiguous(), 1)
            return f, J[..., :self.n_q], J[..., self.n_q:]
        A, B = vmap(jacfwd(self.dynamics.fd, argnums=(0, 1)))(q, u)
        return self.dynamics.fd(q, u), A, B

    def _cost_blocks(self, q_ref, u_ref, du, P):
        x_refs = {'state': q_ref, 'input': u_ref, 'rate': torch.cat([du, du.new_zeros(1, self.n_u)])}
        for kind, fn, ks, nb, r_idx, c_idx, h_idx in self._cost_groups:
            Ms, ms = _quadratize_group(fn, x_refs[kind][ks], ks, nb, P)
            yield kind, ks, nb, Ms, ms, (r_idx, c_idx, h_idx)

    def _qp_step_riccati(self, D, q0, u_prev, P=None):
        """The structured counterpart of :meth:`_qp_step`: the same linearization
        point, the QP solved by the Riccati OCP-QP.  Returns (D_bar, ok)."""
        N, n_q, n_u, n_z = self.N, self.n_q, self.n_u, self.n_z
        qu = D[:n_z * (N + 1)].reshape(N + 1, n_z)
        du = D[n_z * (N + 1):].reshape(N, n_u)
        q_ref = qu[:, :n_q]
        u_ref = qu[:, n_q:]

        # stage cost blocks (dynamics stages 0..N, stage N the dummy pass-through for
        # the s_N slacks; x stages 0..N+1)
        Qx = self._ric_Qx0.clone()
        qx = D.new_zeros(N + 2, n_z)
        Rv = self._ric_Rv0.clone()
        rv = self._ric_rv0.clone()
        Sxv = D.new_zeros(N + 1, self._ric_nv, n_z)
        offs = {'state': 0, 'input': n_q}
        for kind, ks, nb, Ms, ms, _ in self._cost_blocks(q_ref, u_ref, du, P):
            if kind == 'rate':
                Rv[ks, :n_u, :n_u] += Ms
                rv[ks, :n_u] += ms
            else:
                o = offs[kind]
                Qx[ks, o:o + nb, o:o + nb] += Ms
                qx[ks, o:o + nb] += ms

        # dynamics blocks
        fd_all, A_all, B_all = self._linearize_dynamics(q_ref[:-1], u_ref[1:])
        g_all = fd_all - (A_all @ q_ref[:-1, :, None])[..., 0] \
            - (B_all @ u_ref[1:, :, None])[..., 0]
        At = self._ric_At0.clone()
        At[:N, :n_q, :n_q] = A_all
        At[:N, :n_q, n_q:] = B_all
        Bt = self._ric_Bt0.clone()
        Bt[:N, :n_q, :n_u] = B_all
        gt = D.new_zeros(N + 1, n_z)
        gt[:N, :n_q] = g_all

        # inequalities: the static boxes/du/slack template + the linearized nl rows
        Dm = self._ric_D0.clone()
        Em = self._ric_E0
        bm = self._ric_b0.clone()
        r0 = self._ric_nl_row0
        for fn, ks, m, _rows, _rq, _cq, _ru, _cu in self._nl_groups:
            qs, us = q_ref[ks], u_ref[ks]
            vals, Jqs, Jus = _linearize_group(fn, qs, us, ks, P)
            Dm[ks, r0:r0 + m, :n_q] = Jqs
            Dm[ks, r0:r0 + m, n_q:] = Jus
            bm[ks, r0:r0 + m] = (Jqs @ qs[..., None])[..., 0] \
                + (Jus @ us[..., None])[..., 0] - vals

        x0t = torch.cat([q0, u_prev])
        args = (At, Bt, gt, Qx, Sxv, Rv, qx, rv, Dm, Em, bm, x0t)
        sol = solve_ocp_qp(*(a[None] for a in args),
                           tol=1e-8 if self.dtype == torch.float64 else 1e-6)
        D_bar = torch.cat([sol.x[0, :N + 1].reshape(-1), sol.v[0, :N, :n_u].reshape(-1)])
        return D_bar, sol.ok[0]

    def _build_plan(self):
        """The static QP structure of the dense backend (numpy, once): the identity
        parts of the equality matrix, the box/slack inequality block, scatter index
        maps for the stage-dependent pieces, and per-callable stage groups."""
        N, n_q, n_u, n_z = self.N, self.n_q, self.n_u, self.n_z
        n_dec = n_z * (N + 1) + n_u * N
        self.n_dec = n_dec
        idx = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.long, device=self.device)

        soft_state = list(self.soft_state_idxs or [])
        n_ss = len(soft_state)
        n_slack_state = 2 * n_ss * (N + 1)
        soft_c = list(self.params.soft_constraint_idxs or [])
        n_sc = len(soft_c)
        n_slack_c = n_sc * (N + 1)
        n_ext = n_dec + n_slack_state + n_slack_c
        self.n_ext = n_ext

        # static cost base: global diagonal regularization + slack penalty diagonals
        H0 = np.zeros((n_ext, n_ext))
        H0[:n_dec, :n_dec] += 1e-10 * np.eye(n_dec)
        h0 = np.zeros(n_ext)
        for k in range(N + 1):
            for jj in range(n_ss):
                for side in range(2):
                    si = n_dec + 2 * (k * n_ss + jj) + side
                    H0[si, si] += self.soft_state_quad[jj]
                    h0[si] += self.soft_state_lin[jj]
            for jj in range(n_sc):
                si = n_dec + n_slack_state + k * n_sc + jj
                H0[si, si] += self.params.soft_constraint_quad[jj]
                h0[si] += self.params.soft_constraint_lin[jj]
        self._H0 = H0
        self._h0 = h0

        # cost stage groups + scatter grids
        def block_grids(i0s, nb):
            i0s = np.asarray(i0s)
            zeros = np.zeros((1, nb, nb), int)
            r = i0s[:, None, None] + np.arange(nb)[None, :, None] + zeros
            c = i0s[:, None, None] + np.arange(nb)[None, None, :] + zeros
            h_idx = i0s[:, None] + np.arange(nb)[None, :]
            return r.ravel(), c.ravel(), h_idx.ravel()

        self._cost_groups = []
        for kind, nb, off_fn in (
                ('state', n_q, lambda ks: ks * n_z),
                ('input', n_u, lambda ks: ks * n_z + n_q),
                ('rate', n_u, lambda ks: n_z * (N + 1) + ks * n_u)):
            fns = self.costs.get(kind, [None] * (N + 1))
            for fn, ks in _group_stages(fns):
                if kind == 'rate':
                    # only N rate variables du_0..du_{N-1}: a stage-N rate entry has no
                    # decision column (its offset would land in the slack block)
                    ks = ks[ks < N]
                    if ks.size == 0:
                        continue
                r, c, hi = block_grids(off_fn(ks), nb)
                self._cost_groups.append((kind, fn, idx(ks), nb, idx(r), idx(c), idx(hi)))

        # static equality template + A/B scatter grids
        n_eq = n_z + N * n_q + N * n_u
        E0 = np.zeros((n_eq, n_ext))
        E0[:n_z, :n_z] = np.eye(n_z)
        ks = np.arange(N)
        for k in range(N):
            r0 = n_z + k * n_q
            E0[r0:r0 + n_q, (k + 1) * n_z:(k + 1) * n_z + n_q] = np.eye(n_q)
            r1 = n_z + N * n_q + k * n_u
            E0[r1:r1 + n_u, (k + 1) * n_z + n_q:(k + 2) * n_z] = np.eye(n_u)
            E0[r1:r1 + n_u, k * n_z + n_q:(k + 1) * n_z] = -np.eye(n_u)
            E0[r1:r1 + n_u, n_z * (N + 1) + k * n_u:n_z * (N + 1) + (k + 1) * n_u] = \
                -np.eye(n_u)
        self._E0 = E0
        rA = (n_z + ks[:, None, None] * n_q + np.arange(n_q)[None, :, None]
              + np.zeros((1, 1, n_q), int))
        cA = ks[:, None, None] * n_z + np.arange(n_q)[None, None, :] \
            + np.zeros((1, n_q, 1), int)
        rB = (n_z + ks[:, None, None] * n_q + np.arange(n_q)[None, :, None]
              + np.zeros((1, 1, n_u), int))
        cB = (ks[:, None, None] + 1) * n_z + n_q + np.arange(n_u)[None, None, :] \
            + np.zeros((1, n_q, 1), int)
        self._rA, self._cA = idx(rA.ravel()), idx(cA.ravel())
        self._rB, self._cB = idx(rB.ravel()), idx(cB.ravel())

        # static inequality block: boxes, slack non-negativity, du bounds
        A_rows, b_rows = [], []
        finite_ub = np.isfinite(np.concatenate([self.state_ub, self.input_ub]))
        finite_lb = np.isfinite(np.concatenate([self.state_lb, self.input_lb]))
        qu_ub = np.concatenate([self.state_ub, self.input_ub])
        qu_lb = np.concatenate([self.state_lb, self.input_lb])
        for k in range(N + 1):
            i0 = k * n_z
            for j in np.where(finite_ub)[0]:
                row = np.zeros(n_ext)
                row[i0 + j] = 1.0
                if j in soft_state:
                    row[n_dec + 2 * (k * n_ss + soft_state.index(j))] = -1.0
                A_rows.append(row)
                b_rows.append(qu_ub[j])
            for j in np.where(finite_lb)[0]:
                row = np.zeros(n_ext)
                row[i0 + j] = -1.0
                if j in soft_state:
                    row[n_dec + 2 * (k * n_ss + soft_state.index(j)) + 1] = -1.0
                A_rows.append(row)
                b_rows.append(-qu_lb[j])
        for si in range(n_dec, n_ext):
            row = np.zeros(n_ext)
            row[si] = -1.0
            A_rows.append(row)
            b_rows.append(0.0)
        for k in range(N):
            i0 = n_z * (N + 1) + k * n_u
            for j in np.where(np.isfinite(self.du_ub))[0]:
                row = np.zeros(n_ext)
                row[i0 + j] = 1.0
                A_rows.append(row)
                b_rows.append(self.du_ub[j])
            for j in np.where(np.isfinite(self.du_lb))[0]:
                row = np.zeros(n_ext)
                row[i0 + j] = -1.0
                A_rows.append(row)
                b_rows.append(-self.du_lb[j])
        self._A_box = np.stack(A_rows) if A_rows else np.zeros((0, n_ext))
        self._b_box = np.asarray(b_rows)

        # nonlinear constraint groups: static template with soft coefficients + grids
        cs = self.constraints.get('state_input', [None] * (N + 1))
        n_nl = int(sum(self.n_c))
        row_off = np.concatenate([[0], np.cumsum(self.n_c)]).astype(int)
        A_nl0 = np.zeros((n_nl, n_ext))
        for k in range(N + 1):
            for jj, c_idx in enumerate(soft_c):
                if cs[k] is not None and c_idx < self.n_c[k]:
                    A_nl0[row_off[k] + c_idx,
                          n_dec + n_slack_state + k * n_sc + jj] = -1.0
        self._A_nl0 = A_nl0
        self._n_nl = n_nl
        self._nl_groups = []
        for fn, ks in _group_stages(cs):
            m = self.n_c[int(ks[0])]
            rows = np.stack([row_off[k] + np.arange(m) for k in ks])      # (G, m)
            rq = np.repeat(rows[:, :, None], n_q, axis=2)
            cq = (ks[:, None, None] * n_z + np.arange(n_q)[None, None, :]
                  + np.zeros((1, m, 1), int))
            ru = np.repeat(rows[:, :, None], n_u, axis=2)
            cu = (ks[:, None, None] * n_z + n_q + np.arange(n_u)[None, None, :]
                  + np.zeros((1, m, 1), int))
            self._nl_groups.append((fn, idx(ks), m, idx(rows.ravel()), idx(rq.ravel()),
                                    idx(cq.ravel()), idx(ru.ravel()), idx(cu.ravel())))
        # the dense templates on the device, once
        self._H0_t, self._h0_t, self._E0_t = self._t(H0), self._t(h0), self._t(E0)
        self._A_box_t, self._b_box_t = self._t(self._A_box), self._t(self._b_box)
        self._A_nl0_t = self._t(A_nl0)

    def initialize(self):
        pass

    def set_warm_start(self, u_ws: np.ndarray, du_ws: np.ndarray,
                       state: Optional[VehicleState] = None):
        """(N+1, n_u) applied-input warm start (row 0 = previous input) + rate warm
        start."""
        self.u_ws = np.asarray(u_ws)
        self.du_ws = np.asarray(du_ws)
        if state is not None and self.delay_buffer is not None:
            _, u = self.dynamics.state2qu(state)
            for i in range(self.n_u):
                self.delay_buffer[i].extend([u[i]] * self.delay_buffer[i].maxlen)

    def _rollout(self, q0, U):
        """States (len(U)+1, n_q) of the model's discrete step from q0 under inputs U."""
        qs = [q0]
        with torch.no_grad():
            for k in range(U.shape[0]):
                qs.append(self.dynamics.fd(qs[-1], U[k]))
        return torch.stack(qs)

    def _qp_step(self, D, q0, u_prev, P=None):
        """Linearize/quadratize at D's trajectory and solve one QP (one damped
        iteration) with the dense equality-constrained IPM.  Returns (D_bar, ok)."""
        N, n_q, n_u, n_z = self.N, self.n_q, self.n_u, self.n_z
        qu = D[:n_z * (N + 1)].reshape(N + 1, n_z)
        du = D[n_z * (N + 1):].reshape(N, n_u)
        q_ref = qu[:, :n_q]
        u_ref = qu[:, n_q:]          # u_ref[k] = u_{k-1}

        # quadratic cost 1/2 z'Hz + h'z (stage groups + scatter)
        H = self._H0_t.clone()
        h = self._h0_t.clone()
        for _kind, _ks, _nb, Ms, ms, (r_idx, c_idx, h_idx) in \
                self._cost_blocks(q_ref, u_ref, du, P):
            H.index_put_((r_idx, c_idx), Ms.reshape(-1), accumulate=True)
            h.index_put_((h_idx,), ms.reshape(-1), accumulate=True)

        # equality constraints E z = d (template + A/B scatter)
        fd_all, A_all, B_all = self._linearize_dynamics(q_ref[:-1], u_ref[1:])
        g_all = fd_all - (A_all @ q_ref[:-1, :, None])[..., 0] \
            - (B_all @ u_ref[1:, :, None])[..., 0]
        E = self._E0_t.clone()
        E[self._rA, self._cA] = -A_all.reshape(-1)
        E[self._rB, self._cB] = -B_all.reshape(-1)
        d = torch.cat([q0, u_prev, g_all.reshape(-1), D.new_zeros(N * n_u)])

        # inequalities: the static box/slack/du block + the linearized nl rows (soft
        # coefficients live in the static template)
        A_nl = self._A_nl0_t.clone()
        b_nl = D.new_zeros(self._n_nl)
        for fn, ks, m, rows, rq, cq, ru, cu in self._nl_groups:
            qs, us = q_ref[ks], u_ref[ks]   # stage k uses (q_k, u_{k-1})
            vals, Jqs, Jus = _linearize_group(fn, qs, us, ks, P)
            A_nl[rq, cq] = Jqs.reshape(-1)
            A_nl[ru, cu] = Jus.reshape(-1)
            rhs = (Jqs @ qs[..., None])[..., 0] + (Jus @ us[..., None])[..., 0] - vals
            b_nl[rows] = rhs.reshape(-1)

        A_in = torch.cat([self._A_box_t, A_nl], dim=0)
        b_in = torch.cat([self._b_box_t, b_nl])
        sol = solve_eq_qp(H[None], h[None], A_in[None], b_in[None], E[None], d[None],
                          tol=1e-8 if self.dtype == torch.float64 else 1e-6)
        return sol.x[0, :self.n_dec], sol.ok[0]

    # ------------------------------------------------------------- host interface
    def solve(self, state: VehicleState, parameters=None):
        q0, _ = self.dynamics.state2qu(state)
        if self.delay_buffer is not None:
            delay_steps = min(len(b) for b in self.delay_buffer)
            u_delay = np.stack([np.array(list(b))[:delay_steps] for b in self.delay_buffer],
                               axis=1)
            q0 = self._rollout(self._t(q0), self._t(u_delay))[-1].cpu().numpy()

        q_ws = self._rollout(self._t(q0), self._t(self.u_ws[1:])).cpu().numpy()
        if self.wrapped_state_idxs is not None:
            for i, p in zip(self.wrapped_state_idxs, self.wrapped_state_periods):
                q_ws[:, i] = np.unwrap(q_ws[:, i], period=p)

        D = np.concatenate([np.hstack([q_ws, self.u_ws]).ravel(), self.du_ws.ravel()])
        success = True
        for _ in range(self.qp_iters):
            D_bar, ok = self._qp_step_fn(self._t(D), self._t(q0), self._t(self.u_prev),
                                         parameters)
            if not bool(ok):
                success = False
                self.print_method('Warning: LTV-MPC QP failed')
                break
            D = self.damping * D + (1 - self.damping) * D_bar.cpu().numpy()
            D[self.n_z * (self.N + 1) + self.n_u * self.N:] = 0.0

        if success:
            qu_sol = D[:self.n_z * (self.N + 1)].reshape(self.N + 1, self.n_z)
            self.q_pred = qu_sol[:, :self.n_q]
            self.u_pred = qu_sol[1:, self.n_q:]
            self.du_pred = D[self.n_z * (self.N + 1):].reshape(self.N, self.n_u)
        else:
            self.q_pred = q_ws
            self.u_pred = self.u_ws[1:]
            self.du_pred = self.du_ws
        return success

    def step(self, state: VehicleState, parameters=None):
        self.t = state.t
        success = self.solve(state, parameters)
        u = self.u_pred[0]
        self.dynamics.qu2state(state, None, u)
        if self.delay_buffer is not None:
            for i in range(self.n_u):
                self.delay_buffer[i].append(u[i])
        self.u_prev = u
        u_ws = np.vstack([self.u_pred, self.u_pred[-1:]])
        du_ws = np.vstack([self.du_pred[1:], self.du_pred[-1:]])
        self.set_warm_start(u_ws, du_ws)
        return dict(success=success, status=success)

    def get_prediction(self) -> VehiclePrediction:
        if self.state_input_prediction is None:
            self.state_input_prediction = VehiclePrediction()
        self.state_input_prediction.t = self.t
        self.dynamics.qu2prediction(self.state_input_prediction, self.q_pred, self.u_pred)
        return self.state_input_prediction

    def get_prediction_interpolator(self, extrapolate: bool = False):
        """Dense-time interpolator over the current prediction."""
        return self.dynamics.qu2interpolator(self.t, self.q_pred, self.u_pred,
                                             extrapolate=extrapolate)
