"""Joint multi-agent dynamics, ported from ``dgsqp_tpu/dynamics/multi_agent.py``.

The joint state/input are the per-agent states/inputs stacked, and the joint discrete
map applies each agent's ``fd`` to its own block (batch-agnostic, like the models).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from dgsqp_torch.dynamics.model_types import MultiAgentModelConfig
from dgsqp_torch.dynamics.models import DynamicsModel
from dgsqp_torch.types import VehiclePrediction, VehicleState


class MultiAgentDynamicsModel:
    def __init__(self, t0: float, models: List[DynamicsModel],
                 config: MultiAgentModelConfig = None):
        self.t0 = t0
        self.dynamics_models = models
        self.model_config = config or MultiAgentModelConfig()
        self.n_a = len(models)
        self.n_q = sum(m.n_q for m in models)
        self.n_u = sum(m.n_u for m in models)
        self.num_qa_d = [m.n_q for m in models]
        self.num_ua_d = [m.n_u for m in models]
        self.q_offsets = np.concatenate([[0], np.cumsum(self.num_qa_d)]).astype(int)
        self.u_offsets = np.concatenate([[0], np.cumsum(self.num_ua_d)]).astype(int)
        # agents that share one model definition (class, configuration and track) are
        # stepped in one call on (..., n_a, n_q) tensors: the same arithmetic per element
        # with n_a times fewer tensor operations
        m0 = models[0]
        self._shared_model = m0 if all(
            type(m) is type(m0) and m.track is m0.track
            and m.model_config.__dict__ == m0.model_config.__dict__ for m in models) else None

    def split_q(self, q):
        return [q[..., self.q_offsets[a]:self.q_offsets[a + 1]] for a in range(self.n_a)]

    def split_u(self, u):
        return [u[..., self.u_offsets[a]:self.u_offsets[a + 1]] for a in range(self.n_a)]

    def _joint(self, fn_name, q, u):
        m = self._shared_model
        if m is not None:
            out = getattr(m, fn_name)(q.reshape(*q.shape[:-1], self.n_a, m.n_q),
                                      u.reshape(*u.shape[:-1], self.n_a, m.n_u))
            return out.reshape(q.shape)
        qs, us = self.split_q(q), self.split_u(u)
        return torch.cat([getattr(m, fn_name)(qa, ua)
                          for m, qa, ua in zip(self.dynamics_models, qs, us)], dim=-1)

    def fc(self, q, u):
        return self._joint('fc', q, u)

    def fd(self, q, u):
        return self._joint('fd', q, u)

    def state2q(self, states: List[VehicleState]) -> np.ndarray:
        return np.concatenate([m.state2q(s) for m, s in zip(self.dynamics_models, states)])

    def qu2state(self, states: List[VehicleState], q: Optional[np.ndarray] = None,
                 u: Optional[np.ndarray] = None):
        for a, m in enumerate(self.dynamics_models):
            qa = q[self.q_offsets[a]:self.q_offsets[a + 1]] if q is not None else None
            ua = u[self.u_offsets[a]:self.u_offsets[a + 1]] if u is not None else None
            m.qu2state(states[a], qa, ua)

    def qu2prediction(self, predictions: List[Optional[VehiclePrediction]],
                      q: Optional[np.ndarray] = None, u: Optional[np.ndarray] = None):
        out = []
        for a, m in enumerate(self.dynamics_models):
            qa = q[:, self.q_offsets[a]:self.q_offsets[a + 1]] if q is not None else None
            ua = u[:, self.u_offsets[a]:self.u_offsets[a + 1]] if u is not None else None
            pred = predictions[a] if predictions is not None else None
            out.append(m.qu2prediction(pred, qa, ua))
        return out
