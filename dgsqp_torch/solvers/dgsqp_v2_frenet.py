"""DGSQP v2 on the approximate (MPCC) game, ported from
``dgsqp_tpu/solvers/dgsqp_v2_frenet.py``.

The game is formulated on progress-augmented global-frame models; the exact Frenet
quantities are replaced, per agent and stage, by

  * a quadratic contouring/lag cost 1/2 x'Q_e x + q_e'x (Gauss-Newton at an iterate;
    contouring weight q_c = 0.1, lag weight q_l = 1000), and
  * two linearised track-boundary half-planes G x + g <= 0,

with (Q_e, q_e, G, g) recomputed from the current rollout once per SQP iteration
(``approximation_eval='once'``) or also at every merit and trial evaluation
(``'always'``).  ``'exact'`` freezes nothing: the cost and the half-planes are evaluated
at the state's own arc position and differentiated through the track splines.

The parameters travel as a pytree ``P = {'Qe', 'qe', 'Gtb', 'gtb'}``, each a per-agent
list of (B, N+1, ...) tensors, read by ``stage_indexed`` closures at their stages
``k``.  The boundary reference ``z`` (interpolation between the track edges) is the
centre line.  The boundary rows live in each agent's nonlinear-constraint slot (before
its box rows), as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from dgsqp_torch.solvers.dgsqp_v2 import DGSQPV2
from dgsqp_torch.solvers.game_problem import _as_stage_list, _call_stage, _call_term
from dgsqp_torch.solvers.solver_types import DGSQPV2Params


def _stage_indexed(fn, n_out=None):
    fn.stage_indexed = True
    if n_out is not None:
        fn.n_out = n_out
    return fn


def _quad(qa, Qe, qe):
    """1/2 qa'Qe qa + qe'qa over leading dimensions."""
    return 0.5 * ((qa[..., None, :] @ Qe)[..., 0, :] * qa).sum(-1) + (qe * qa).sum(-1)


class DGSQPV2FrenetApprox(DGSQPV2):
    def __init__(self, joint_dynamics, costs, agent_constraints, shared_constraints,
                 bounds, params: DGSQPV2Params = None, print_method=print,
                 q_c: float = 0.1, q_l: float = 1000.0, dtype=torch.float32,
                 device='cuda'):
        params = params or DGSQPV2Params()
        M = joint_dynamics.n_a
        N = params.N
        self.q_c, self.q_l = q_c, q_l
        models = joint_dynamics.dynamics_models
        self._f_cl = [m.contouring_lag_quad_approx(q_c, q_l) for m in models]
        self._f_tb = [m.track_boundary_lin_approx() for m in models]
        n_qa = [m.n_q for m in models]
        q_off = joint_dynamics.q_offsets
        exact = params.approximation_eval == 'exact'
        f_cl_x = [m.contouring_lag_cost_exact(q_c, q_l) for m in models]
        f_tb_x = [m.track_boundary_constraint_exact() for m in models]

        def block(x, a):
            return x[..., q_off[a]:q_off[a] + n_qa[a]]

        # the contouring/lag cost: exact (the centre-line reference z = 0) or the
        # P-parameterised quadratic
        def make_cl_cost(a):
            if exact:
                stage = lambda x, u, um, P, k: f_cl_x[a](block(x, a), 0.0)
                term = lambda x, P, k: f_cl_x[a](block(x, a), 0.0)
            else:
                stage = lambda x, u, um, P, k: _quad(block(x, a), P['Qe'][a][:, k],
                                                     P['qe'][a][:, k])
                term = lambda x, P, k: _quad(block(x, a), P['Qe'][a][:, k],
                                             P['qe'][a][:, k])
            return _stage_indexed(stage), _stage_indexed(term)

        # the boundary half-planes, two rows per stage
        def make_tb_constr(a):
            if exact:
                stage = lambda x, u, um, P, k: f_tb_x[a](block(x, a))
                term = lambda x, P, k: f_tb_x[a](block(x, a))
            else:
                def lin(x, P, k):
                    G = P['Gtb'][a][:, k]
                    return (G @ block(x, a)[..., None])[..., 0] + P['gtb'][a][:, k]
                stage = lambda x, u, um, P, k: lin(x, P, k)
                term = lin
            return _stage_indexed(stage, 2), _stage_indexed(term, 2)

        def augment(specs, make, vector):
            out = []
            for a in range(M):
                base = _as_stage_list(specs[a] if specs else None, N)
                extra_stage, extra_term = make(a)
                # one combined closure per distinct base callable, so that the stages
                # keep grouping
                cache = {}
                stage_list = []
                for k in range(N):
                    key = id(base[k])
                    if key not in cache:
                        cache[key] = self._combine_stage(base[k], extra_stage, vector)
                    stage_list.append(cache[key])
                out.append(stage_list + [self._combine_term(base[N], extra_term, vector)])
            return out

        super().__init__(joint_dynamics, augment(costs, make_cl_cost, False),
                         augment(agent_constraints, make_tb_constr, True),
                         shared_constraints, bounds, params, print_method=print_method,
                         dtype=dtype, device=device)

        # boundary interpolation reference: the centre line
        self.reference = [np.zeros(N + 1) for _ in range(M)]
        self._n_qa = n_qa
        self._q_off = q_off
        # exact mode needs no parameter pytree: the closures read the splines directly
        self._approx_update = None if exact else self._evaluate_mpcc

    @staticmethod
    def _combine_stage(base_fn, extra_fn, vector: bool = False):
        if base_fn is None:
            return extra_fn

        def fn(x, u, um, P, k):
            e = extra_fn(x, u, um, P, k)
            b = _call_stage(base_fn, x, u, um, P, k)
            return torch.cat([b, e], dim=-1) if vector else b + e
        fn.stage_indexed = True
        if vector:
            fn.probe_rows = lambda x, u, um: (
                _call_stage(base_fn, x, u, um, None, 0).numel() + int(extra_fn.n_out))
        return fn

    @staticmethod
    def _combine_term(base_fn, extra_fn, vector: bool = False):
        if base_fn is None:
            return extra_fn

        def fn(x, P, k):
            e = extra_fn(x, P, k)
            b = _call_term(base_fn, x, P, k)
            return torch.cat([b, e], dim=-1) if vector else b + e
        fn.stage_indexed = True
        if vector:
            fn.probe_rows = lambda x, u, um: (
                _call_term(base_fn, x, None, 0).numel() + int(extra_fn.n_out))
        return fn

    def _evaluate_mpcc(self, u_flat, x0):
        """The parameter pytree at the iterate's rollout, for every game and stage in one
        batched call per agent: Qe (B, N+1, n_qa, n_qa), qe (B, N+1, n_qa), Gtb
        (B, N+1, 2, n_qa), gtb (B, N+1, 2)."""
        x = self.problem.rollout(u_flat, x0)
        P = {'Qe': [], 'qe': [], 'Gtb': [], 'gtb': []}
        for a in range(self.M):
            qa_traj = x[..., self._q_off[a]:self._q_off[a] + self._n_qa[a]]
            z = torch.as_tensor(self.reference[a], dtype=x.dtype, device=x.device)
            Qe, qe = self._f_cl[a](qa_traj, z)
            Gtb, gtb = self._f_tb[a](qa_traj)
            P['Qe'].append(Qe)
            P['qe'].append(qe)
            P['Gtb'].append(Gtb)
            P['gtb'].append(gtb)
        return P
