"""Port parity for ``DGSQPV2FrenetApprox`` on the CPU in float64 in the frozen-P
modes: ``'once'`` (the linearisation recomputed once per SQP iteration) and ``'always'``
(also at every trial point), as ``check_solver_matches_jax`` of
``test_torch_approx_solver.py`` states.
"""
import pytest

from test_torch_approx_solver import check_solver_matches_jax
from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize('mode', ['once', 'always'])
def test_frozen_mode_solver_matches_jax(mode):
    check_solver_matches_jax(mode)
