"""Abstract solver contract, ported from ``dgsqp_tpu/solvers/abstract_solver.py``.

Every controller or solver exposes ``initialize / solve / step / get_prediction``.  The
port's solvers implement the contract without inheriting from it and are registered as
its virtual subclasses.  ``install()`` is a no-op kept for the interface: the port
builds its CUDA kernels on first use.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List

from dgsqp_torch.types import VehiclePrediction


class AbstractSolver(ABC):
    @abstractmethod
    def initialize(self, **kwargs):
        ...

    @abstractmethod
    def solve(self, *args, **kwargs):
        ...

    @abstractmethod
    def step(self, *args, **kwargs):
        ...

    def get_prediction(self) -> List[VehiclePrediction]:
        raise NotImplementedError

    def install(self):
        """No-op (the kernels are built on first use)."""
        return None


def _register():
    from dgsqp_torch.solvers.algames import ALGAMES
    from dgsqp_torch.solvers.ca_ltv_mpc import CA_LTV_MPC
    from dgsqp_torch.solvers.dgsqp import DGSQP
    from dgsqp_torch.solvers.dgsqp_v2 import DGSQPV2
    from dgsqp_torch.solvers.ibr import IBR
    from dgsqp_torch.solvers.mcp import PATHMCP
    for cls in (ALGAMES, CA_LTV_MPC, DGSQP, DGSQPV2, IBR, PATHMCP):
        AbstractSolver.register(cls)


_register()
