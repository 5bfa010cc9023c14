"""Plant simulator with optional per-channel input delay, ported from
``dgsqp_tpu/dynamics/simulator.py``.

It steps a model forward ``T`` seconds through the model's host ``step`` (fine rk4,
one ``dyn_step`` launch a step for the dynamic bicycles on the card), buffering the
actuation commands through deques to model actuation latency, and can add one process
noise sample a step from a numpy ``rng``.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch

from dgsqp_torch.dynamics.models import DynamicsModel
from dgsqp_torch.types import VehicleState


class DynamicsSimulator:
    def __init__(self, t0: float, model: DynamicsModel, delay: Optional[list] = None,
                 track=None, device='cuda', dtype=torch.float64):
        self.model = model
        self.t0 = t0
        self.track = track if track is not None else model.track
        self.device = torch.device(device)
        self.dtype = dtype
        if delay is not None:
            # delay[i] = seconds of latency on input channel i
            self.delay_steps = [max(1, int(round(d / model.dt))) for d in delay]
            self.input_buffer = [deque([0.0] * n, maxlen=n) for n in self.delay_steps]
        else:
            self.input_buffer = None

    def step(self, state: VehicleState, T: Optional[float] = None,
             rng: Optional[np.random.Generator] = None):
        if rng is not None and self.model.noise_sqrt is not None:
            # one additive noise sample per step (fault-injection hook)
            q, u = self.model.state2qu(state)
            w = self.model.noise_sqrt @ rng.standard_normal(self.model.n_q)
            self.model.qu2state(state, q + w, None)
        if self.input_buffer is not None:
            u = self.model.state2qu(state)[1]
            delayed = np.array([buf[0] for buf in self.input_buffer])
            for i, buf in enumerate(self.input_buffer):
                buf.append(u[i])
            self.model.qu2state(state, None, delayed)
        self.model.step(state, T=T, device=self.device, dtype=self.dtype)
        return state
