"""Dynamic-game problem definition and condensed derivative evaluation, ported from
``dgsqp_tpu/solvers/game_problem.py``.

An M-player open-loop game over horizon N: the input sequence is stacked by agent,
``u = [u^1_0..u^1_{N-1}, u^2_0..u^2_{N-1}, ...]``, the state follows by single shooting,
and the condensed derivatives are

  * ``q``  = stacked per-agent gradients  q^a = D_{u^a} J^a(x(u), u)
  * ``g``  = stacked inequality constraints C(x(u), u) <= 0
  * ``G``  = D_u C
  * ``Q``  = D_u [D_{u^a} (J^a + l'C)]_a, the (non-symmetric) game Hessian,

computed with ``torch.func`` (forward-mode for ``q, G``; forward-over-reverse for
``Q``).  Costs and constraints are per-agent lists of per-stage callables (length N+1,
entry N = terminal, entries may be ``None``) written on tensors with any leading batch
shape, so a group of stages that share a callable is evaluated in one call on the
stacked stage tensors.  Rows are assembled in the reference's canonical order by one
precomputed gather.

Every method takes a batch: each tensor argument has a leading batch dimension, and the
per-game Jacobians are taken by seeding all games with the same tangent or cotangent
(``_jac_fwd``/``_jac_rev``, built on ``torch.func.jvp``/``vjp``/``vmap``).
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
from torch.func import vmap

from dgsqp_torch.dynamics.multi_agent import MultiAgentDynamicsModel


def _n_args(fn: Callable) -> int:
    return len(inspect.signature(fn).parameters)


def _takes_params(fn: Callable) -> bool:
    n = _n_args(fn)
    if getattr(fn, 'stage_indexed', False):
        n -= 1
    return n >= 4


def _takes_params_term(fn: Callable) -> bool:
    n = _n_args(fn)
    if getattr(fn, 'stage_indexed', False):
        n -= 1
    return n >= 2


def _call_stage(fn, x, u, um, P, k=None):
    args = (x, u, um)
    if _takes_params(fn):
        args = args + (P,)
    if getattr(fn, 'stage_indexed', False):
        args = args + (k,)
    return fn(*args)


def _call_term(fn, x, P, k=None):
    args = (x,)
    if _takes_params_term(fn):
        args = args + (P,)
    if getattr(fn, 'stage_indexed', False):
        args = args + (k,)
    return fn(*args)


def _as_stage_list(spec, N: int):
    """Normalize a cost/constraint spec to a list of length N+1: a list of length N+1,
    or a (stage_fn, terminal_fn) tuple (either member may be None)."""
    if spec is None:
        return [None] * (N + 1)
    if isinstance(spec, list):
        if len(spec) != N + 1:
            raise ValueError(f'Expected list of length N+1={N + 1}, got {len(spec)}')
        return list(spec)
    if isinstance(spec, tuple) and len(spec) == 2:
        stage, term = spec
        return [stage] * N + [term]
    raise ValueError('Cost/constraint spec must be a list of length N+1 or a (stage, terminal) tuple')


def _group_stages(fns: Sequence) -> List:
    """Group a length-N list of callables by identity: [(fn, np.array(ks)), ...]."""
    groups = {}
    order = []
    for k, fn in enumerate(fns):
        if fn is None:
            continue
        key = id(fn)
        if key not in groups:
            groups[key] = (fn, [])
            order.append(key)
        groups[key][1].append(k)
    return [(groups[key][0], np.asarray(groups[key][1])) for key in order]


class GameProblem:
    """An M-player open-loop dynamic game over horizon N with shared constraints.

    ``bounds`` is ``{'ub': [VehicleState]*M, 'lb': [VehicleState]*M}``.  Index tables and
    bound tables live on ``device`` in ``dtype``.
    """

    def __init__(self, joint_dynamics: MultiAgentDynamicsModel, costs: Sequence,
                 agent_constraints: Sequence, shared_constraints, bounds: Dict, N: int,
                 dtype=torch.float64, device='cuda'):
        self.joint_dynamics = joint_dynamics
        self.M = joint_dynamics.n_a
        self.N = N
        self.n_q = joint_dynamics.n_q
        self.n_u = joint_dynamics.n_u
        self.dtype = dtype
        self.device = torch.device(device)

        self.num_qa_d = joint_dynamics.num_qa_d
        self.num_ua_d = joint_dynamics.num_ua_d
        self.num_ua_el = [N * n for n in self.num_ua_d]
        self.ua_el_offsets = np.concatenate([[0], np.cumsum(self.num_ua_el)]).astype(int)
        self.q_offsets = joint_dynamics.q_offsets
        self.u_offsets = joint_dynamics.u_offsets
        self.n_dec = N * self.n_u

        if len(costs) != self.M:
            raise ValueError(f'{self.M} agents but {len(costs)} cost specs provided')
        self.costs = [_as_stage_list(c, N) for c in costs]
        self.agent_constraints = [_as_stage_list(c, N)
                                  for c in (agent_constraints or [None] * self.M)]
        self.shared_constraints = _as_stage_list(shared_constraints, N)

        self.state_ub, self.state_lb, self.input_ub, self.input_lb = [], [], [], []
        self.state_ub_idxs, self.state_lb_idxs = [], []
        self.input_ub_idxs, self.input_lb_idxs = [], []
        for a in range(self.M):
            model = joint_dynamics.dynamics_models[a]
            su, iu = model.state2qu(bounds['ub'][a])
            sl, il = model.state2qu(bounds['lb'][a])
            self.state_ub.append(su)
            self.state_lb.append(sl)
            self.input_ub.append(iu)
            self.input_lb.append(il)
            self.state_ub_idxs.append(np.where(su < np.inf)[0])
            self.state_lb_idxs.append(np.where(sl > -np.inf)[0])
            self.input_ub_idxs.append(np.where(iu < np.inf)[0])
            self.input_lb_idxs.append(np.where(il > -np.inf)[0])

        self._count_constraints()
        self._build_plan()

    def _t(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # ------------------------------------------------------------ layout helpers
    def u_to_stage(self, u_flat):
        """Agent-stacked flat u (..., n_dec) -> (..., N, n_u) stage-major matrix."""
        blocks = []
        for a in range(self.M):
            ua = u_flat[..., self.ua_el_offsets[a]:self.ua_el_offsets[a + 1]]
            blocks.append(ua.reshape(*ua.shape[:-1], self.N, self.num_ua_d[a]))
        return torch.cat(blocks, dim=-1)

    def stage_to_u(self, u_mat):
        """(..., N, n_u) stage matrix -> agent-stacked flat (..., n_dec)."""
        parts = []
        for a in range(self.M):
            blk = u_mat[..., :, self.u_offsets[a]:self.u_offsets[a + 1]]
            parts.append(blk.reshape(*blk.shape[:-2], -1))
        return torch.cat(parts, dim=-1)

    def agent_u_block(self, u_flat, a: int):
        return u_flat[..., self.ua_el_offsets[a]:self.ua_el_offsets[a + 1]]

    # ----------------------------------------------------------------- rollout
    def rollout(self, u_flat, x0):
        """State trajectory x(u, x0) by single shooting: (..., N+1, n_q)."""
        u_mat = self.u_to_stage(u_flat)
        fd = self.joint_dynamics.fd
        xs = [x0]
        for k in range(self.N):
            xs.append(fd(xs[-1], u_mat[..., k, :]))
        return torch.stack(xs, dim=-2)

    # -------------------------------------------------- constraint bookkeeping
    def _probe_rows(self, fn, x, u, um, terminal=False):
        n_out = getattr(fn, 'n_out', None)
        if n_out is not None:
            return int(n_out)
        if terminal:
            return int(_call_term(fn, x, None, 0).numel())
        return int(_call_stage(fn, x, u, um, None, 0).numel())

    def _count_constraints(self):
        """Record the reference layout (shared, then per-agent [nonlinear, input-box-ub,
        input-box-lb, state-box-ub, state-box-lb] per stage) and the row offsets."""
        N, M = self.N, self.M
        self.n_cs = [0] * (N + 1)
        self.n_ca = [[0] * (N + 1) for _ in range(M)]
        self.n_c = [0] * (N + 1)
        x_z = torch.zeros(self.n_q, dtype=torch.float64)
        u_z = torch.zeros(self.n_u, dtype=torch.float64)

        self._m_shared = [0] * (N + 1)
        self._m_agent = [[0] * (N + 1) for _ in range(M)]

        for k in range(N):
            if self.shared_constraints[k] is not None:
                self._m_shared[k] = self._probe_rows(self.shared_constraints[k], x_z, u_z, u_z)
            self.n_cs[k] = self._m_shared[k]
            for a in range(M):
                n = 0
                if self.agent_constraints[a][k] is not None:
                    ua_z = torch.zeros(self.num_ua_d[a], dtype=torch.float64)
                    self._m_agent[a][k] = self._probe_rows(self.agent_constraints[a][k],
                                                           x_z, ua_z, ua_z)
                    n += self._m_agent[a][k]
                n += len(self.input_ub_idxs[a]) + len(self.input_lb_idxs[a])
                if k > 0:
                    n += len(self.state_ub_idxs[a]) + len(self.state_lb_idxs[a])
                self.n_ca[a][k] = n
            self.n_c[k] = self.n_cs[k] + sum(self.n_ca[a][k] for a in range(M))
        if self.shared_constraints[N] is not None:
            self._m_shared[N] = self._probe_rows(self.shared_constraints[N], x_z, None, None,
                                                 terminal=True)
        self.n_cs[N] = self._m_shared[N]
        for a in range(M):
            n = 0
            if self.agent_constraints[a][N] is not None:
                self._m_agent[a][N] = self._probe_rows(self.agent_constraints[a][N], x_z,
                                                       None, None, terminal=True)
                n += self._m_agent[a][N]
            n += len(self.state_ub_idxs[a]) + len(self.state_lb_idxs[a])
            self.n_ca[a][N] = n
        self.n_c[N] = self.n_cs[N] + sum(self.n_ca[a][N] for a in range(M))
        self.n_c_total = int(sum(self.n_c))
        self._stage_off = np.concatenate([[0], np.cumsum(self.n_c)]).astype(int)

    def _block_offsets(self, a: int, k: int):
        """Row offsets of agent a's sub-blocks at stage k: (nl, iub, ilb, sub, slb)."""
        base = self._stage_off[k] + self.n_cs[k] + sum(self.n_ca[b][k] for b in range(a))
        nl = base
        iub = nl + self._m_agent[a][k]
        ilb = iub + (len(self.input_ub_idxs[a]) if k < self.N else 0)
        sub = ilb + (len(self.input_lb_idxs[a]) if k < self.N else 0)
        slb = sub + (len(self.state_ub_idxs[a]) if (k > 0 or k == self.N) else 0)
        return nl, iub, ilb, sub, slb

    def input_box_structure(self):
        """Static (rows, cols) of the input-box rows of ``G`` (single ±1 entries)."""
        rows, cols = [], []
        for k in range(self.N):
            for a in range(self.M):
                _, iub, ilb, sub, _ = self._block_offsets(a, k)
                base_col = self.ua_el_offsets[a] + k * self.num_ua_d[a]
                for r, j in enumerate(self.input_ub_idxs[a]):
                    rows.append(iub + r)
                    cols.append(base_col + int(j))
                for r, j in enumerate(self.input_lb_idxs[a]):
                    rows.append(ilb + r)
                    cols.append(base_col + int(j))
        return tuple(int(r) for r in rows), tuple(int(c) for c in cols)

    def state_pair_structure(self):
        """Static (rows_plus, rows_minus) of paired state-bound rows of ``G`` (exact
        negations ``±Du_x_j`` at every iterate)."""
        rows_p, rows_m = [], []
        for k in range(1, self.N + 1):
            for a in range(self.M):
                _, _, _, sub, slb = self._block_offsets(a, k)
                ub_idx = [int(j) for j in self.state_ub_idxs[a]]
                lb_idx = [int(j) for j in self.state_lb_idxs[a]]
                for pu, j in enumerate(ub_idx):
                    if j in lb_idx:
                        rows_p.append(sub + pu)
                        rows_m.append(slb + lb_idx.index(j))
        return tuple(rows_p), tuple(rows_m)

    def _build_plan(self):
        """Stage groups, destination rows of every piece of ``g`` in evaluation order,
        and the gather that puts the concatenated pieces into reference row order."""
        N, M = self.N, self.M
        long = torch.long
        dests = []

        self._shared_groups = []
        for fn, ks in _group_stages(self.shared_constraints[:N]):
            m = self._m_shared[ks[0]]
            dests.append(np.stack([self._stage_off[k] + np.arange(m) for k in ks]).reshape(-1))
            self._shared_groups.append((fn, self._t(ks, long)))

        self._agent_groups = [[] for _ in range(M)]
        for a in range(M):
            for fn, ks in _group_stages(self.agent_constraints[a][:N]):
                m = self._m_agent[a][ks[0]]
                dests.append(np.stack([self._block_offsets(a, k)[0] + np.arange(m)
                                       for k in ks]).reshape(-1))
                self._agent_groups[a].append((fn, self._t(ks, long)))

        late = list(range(1, N)) + [N]
        for a in range(M):
            for idxs, col in ((self.input_ub_idxs[a], 1), (self.input_lb_idxs[a], 2)):
                if len(idxs):
                    dests.append(np.stack([self._block_offsets(a, k)[col] + np.arange(len(idxs))
                                           for k in range(N)]).reshape(-1))
            for idxs, col in ((self.state_ub_idxs[a], 3), (self.state_lb_idxs[a], 4)):
                if len(idxs):
                    dests.append(np.stack([self._block_offsets(a, k)[col] + np.arange(len(idxs))
                                           for k in late]).reshape(-1))

        if self._m_shared[N]:
            dests.append(self._stage_off[N] + np.arange(self._m_shared[N]))
        for a in range(M):
            if self._m_agent[a][N]:
                dests.append(self._block_offsets(a, N)[0] + np.arange(self._m_agent[a][N]))

        dest = np.concatenate(dests) if dests else np.zeros(0, int)
        if not np.array_equal(np.sort(dest), np.arange(self.n_c_total)):
            raise RuntimeError('constraint plan does not cover every row exactly once')
        self._g_src = self._t(np.argsort(dest), long)

        dt = self.dtype
        self._iub_idx = [self._t(i, long) for i in self.input_ub_idxs]
        self._ilb_idx = [self._t(i, long) for i in self.input_lb_idxs]
        self._sub_idx = [self._t(i + self.q_offsets[a], long)
                         for a, i in enumerate(self.state_ub_idxs)]
        self._slb_idx = [self._t(i + self.q_offsets[a], long)
                         for a, i in enumerate(self.state_lb_idxs)]
        self._input_ub_v = [self._t(self.input_ub[a][i], dt)
                            for a, i in enumerate(self.input_ub_idxs)]
        self._input_lb_v = [self._t(self.input_lb[a][i], dt)
                            for a, i in enumerate(self.input_lb_idxs)]
        self._state_ub_v = [self._t(self.state_ub[a][i], dt)
                            for a, i in enumerate(self.state_ub_idxs)]
        self._state_lb_v = [self._t(self.state_lb[a][i], dt)
                            for a, i in enumerate(self.state_lb_idxs)]

        self._cost_groups = []
        for a in range(M):
            self._cost_groups.append([(fn, self._t(ks, long))
                                      for fn, ks in _group_stages(self.costs[a][:N])])

    # ------------------------------------------------------ batched functions
    # Every function below takes a leading batch dimension B: x (B, N+1, n_q),
    # u_flat (B, n_dec), u_prev (B, n_u), l (B, n_c).  Games never interact, so the
    # per-game Jacobians come from seeding every game with the same basis vector
    # (see _jac_fwd/_jac_rev): no transform maps over the games themselves.
    def _constraints_along(self, x, u_flat, u_prev, P):
        """Stacked inequality constraints in reference row order: (B, n_c)."""
        N, M = self.N, self.M
        B = u_flat.shape[0]
        u_mat = self.u_to_stage(u_flat)
        um_mat = torch.cat([u_prev[:, None], u_mat[:, :-1]], dim=1)
        ua = [self.agent_u_block(u_flat, a).reshape(B, N, self.num_ua_d[a]) for a in range(M)]
        uma = [torch.cat([u_prev[:, None, self.u_offsets[a]:self.u_offsets[a + 1]],
                          ua[a][:, :-1]], dim=1) for a in range(M)]

        pieces = []
        for fn, ks in self._shared_groups:
            pieces.append(_call_stage(fn, x[:, ks], u_mat[:, ks], um_mat[:, ks], P, ks)
                          .reshape(B, -1))
        for a in range(M):
            for fn, ks in self._agent_groups[a]:
                pieces.append(_call_stage(fn, x[:, ks], ua[a][:, ks], uma[a][:, ks], P, ks)
                              .reshape(B, -1))
        for a in range(M):
            if len(self.input_ub_idxs[a]):
                pieces.append((ua[a][:, :, self._iub_idx[a]] - self._input_ub_v[a]).reshape(B, -1))
            if len(self.input_lb_idxs[a]):
                pieces.append((self._input_lb_v[a] - ua[a][:, :, self._ilb_idx[a]]).reshape(B, -1))
            if len(self.state_ub_idxs[a]):
                pieces.append((x[:, 1:, self._sub_idx[a]] - self._state_ub_v[a]).reshape(B, -1))
            if len(self.state_lb_idxs[a]):
                pieces.append((self._state_lb_v[a] - x[:, 1:, self._slb_idx[a]]).reshape(B, -1))
        if self._m_shared[N]:
            pieces.append(_call_term(self.shared_constraints[N], x[:, N], P, N).reshape(B, -1))
        for a in range(M):
            if self._m_agent[a][N]:
                pieces.append(_call_term(self.agent_constraints[a][N], x[:, N], P, N)
                              .reshape(B, -1))
        if not pieces:
            return x.new_zeros(B, 0)
        return torch.cat(pieces, dim=-1)[:, self._g_src]

    def _agent_cost_along(self, a, x, u_flat, u_prev, P):
        """J^a for every game: (B,)."""
        B = u_flat.shape[0]
        ua = self.agent_u_block(u_flat, a).reshape(B, self.N, self.num_ua_d[a])
        upa = u_prev[:, self.u_offsets[a]:self.u_offsets[a + 1]]
        uma = torch.cat([upa[:, None], ua[:, :-1]], dim=1)
        J = x.new_zeros(B)
        for fn, ks in self._cost_groups[a]:
            J = J + torch.sum(_call_stage(fn, x[:, ks], ua[:, ks], uma[:, ks], P, ks), dim=-1)
        if self.costs[a][self.N] is not None:
            J = J + _call_term(self.costs[a][self.N], x[:, self.N], P, self.N)
        return J

    def _costs_and_constraints(self, u_flat, x0, u_prev, P):
        """One shared forward pass: rollout + all agent costs + stacked constraints."""
        x = self.rollout(u_flat, x0)
        C = self._constraints_along(x, u_flat, u_prev, P)
        Js = torch.stack([self._agent_cost_along(a, x, u_flat, u_prev, P)
                          for a in range(self.M)], dim=-1)
        return Js, C, x

    def _own_blocks(self, rows):
        """Stack the own-agent u-block of per-agent gradient rows (B, M, n_dec)."""
        return torch.cat([rows[:, a, self.ua_el_offsets[a]:self.ua_el_offsets[a + 1]]
                          for a in range(self.M)], dim=-1)

    def _sigma(self, uu, l, x0, u_prev, P):
        """[J^1..J^M, l'C] (B, M+1) and the by-products (C, Js, x) of the same pass."""
        Js, C, x = self._costs_and_constraints(uu, x0, u_prev, P)
        return torch.cat([Js, torch.sum(l * C, dim=-1, keepdim=True)], dim=-1), (C, Js, x)

    # ------------------------------------------------------- public interface
    def eval_constraints(self, u, x0, u_prev, P=None):
        """g(u): (B, n_c)."""
        return self._constraints_along(self.rollout(u, x0), u, u_prev, P)

    def eval_costs(self, u, x0, u_prev, P=None):
        """All agents' costs: (B, M)."""
        return self._costs_and_constraints(u, x0, u_prev, P)[0]

    def eval_q(self, u, x0, u_prev, P=None):
        """Stacked own-block cost gradients: (B, n_dec), one reverse sweep with M seeds."""
        def Jfn(uu):
            x = self.rollout(uu, x0)
            return torch.stack([self._agent_cost_along(a, x, uu, u_prev, P)
                                for a in range(self.M)], dim=-1)
        return self._own_blocks(_jac_rev(Jfn, u))

    def merit_terms(self, u, l, x0, u_prev, P=None):
        """Merit ingredients (d, g), d = q + G'l, by one reverse sweep with M+1 seeds
        over a shared forward pass (no forward Jacobian)."""
        def sigma(uu):
            s, (C, _, _) = self._sigma(uu, l, x0, u_prev, P)
            return s, C
        Dsig, g = _jac_rev(sigma, u, has_aux=True)
        d = self._own_blocks(Dsig[:, :self.M] + Dsig[:, self.M:self.M + 1])
        return d, g

    def stationarity(self, u, l, x0, u_prev, P=None):
        """Stacked KKT stationarity map F(u, l) = q + G'l."""
        return self.merit_terms(u, l, x0, u_prev, P)[0]

    def evaluate(self, u, l, x0, u_prev, P=None, hessian: bool = True):
        """Condensed derivatives: (Q, q, G, g, x) with hessian=True, else (q, G, g, x).
        Shapes (B, n_dec, n_dec), (B, n_dec), (B, n_c, n_dec), (B, n_c), (B, N+1, n_q)."""
        if not hessian:
            def fc(uu):
                Js, C, x = self._costs_and_constraints(uu, x0, u_prev, P)
                return (Js, C), (C, x)
            (DJ, G), (g, x) = _jac_fwd(fc, u, has_aux=True)
            return self._own_blocks(DJ), G, g, x

        # One forward-over-reverse sweep: its outputs (the M+1 reverse gradients and the
        # primal C, Js) are pushed through the same n_dec forward tangents, which yields
        # the Hessian H together with G = dC/du and DJ = dJs/du.
        def grad_and_primal(uu):
            grad, (C, Js, x) = _jac_rev(lambda v: self._sigma(v, l, x0, u_prev, P), uu,
                                        has_aux=True)
            return (grad, C, Js), (C, x)

        (H, G, DJ), (g, x) = _jac_fwd(grad_and_primal, u, has_aux=True)
        q = self._own_blocks(DJ)
        M = self.M
        Q = torch.cat([(H[:, a] + H[:, M])[:, self.ua_el_offsets[a]:self.ua_el_offsets[a + 1]]
                       for a in range(M)], dim=1)
        return Q, q, G, g, x

    def dual_warm_start(self, u, x0, u_prev, P=None):
        """Least-squares dual initialization l0 = max(0, -argmin_l ||G'l - q||) with the
        minimum-norm solution (pseudo-inverse, singular values below eps*max(dims)*s_max
        dropped, the same cut as ``jnp.linalg.lstsq``)."""
        q, G, _, _ = self.evaluate(u, None, x0, u_prev, P, hessian=False)
        sol = (torch.linalg.pinv(G.transpose(-1, -2)) @ q[..., None])[..., 0]
        return torch.clamp(-sol, min=0.0)


def _jac_fwd(f, u, has_aux: bool = False):
    """Per-game forward-mode Jacobian of a batch-separable ``f``: ``u`` (B, n) -> each
    output (B, ...) gets a Jacobian (B, ..., n).

    Every game is seeded with the same basis vector e_j and the n seeds are mapped with
    ``torch.func.vmap``; since game b's outputs depend on u_b only, output row b of the
    j-th push is J_b e_j.  (A ``vmap`` over the games themselves would make per-game
    scalars 0-d, where PyTorch promotes float32 tangents to float64 in products with
    Python scalars.)
    """
    basis = torch.eye(u.shape[-1], dtype=u.dtype, device=u.device)

    def push(e):
        return torch.func.jvp(f, (u,), (e.expand_as(u),), has_aux=has_aux)

    outs = vmap(push)(basis)
    jac = torch.utils._pytree.tree_map(lambda t: t.movedim(0, -1), outs[1])
    if has_aux:
        aux = torch.utils._pytree.tree_map(lambda t: t[0], outs[2])
        return jac, aux
    return jac


def _jac_rev(f, u, has_aux: bool = False):
    """Per-game reverse-mode Jacobian of a batch-separable ``f``: ``u`` (B, n) ->
    output (B, m) gives a Jacobian (B, m, n), one cotangent e_i per output row, seeded
    in every game at once and mapped with ``torch.func.vmap``."""
    if has_aux:
        out, vjp_fn, aux = torch.func.vjp(f, u, has_aux=True)
    else:
        out, vjp_fn = torch.func.vjp(f, u)
    basis = torch.eye(out.shape[-1], dtype=out.dtype, device=out.device)
    jac = vmap(lambda e: vjp_fn(e.expand_as(out))[0])(basis).movedim(0, 1)
    return (jac, aux) if has_aux else jac
