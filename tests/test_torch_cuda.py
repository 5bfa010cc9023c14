"""The CUDA wrappers of ``dgsqp_torch.ops.linalg``: launch counting and input checks.

The kernels are held against their plain versions, at every main-path shape, by the
``kernels`` phase of ``chip_smoke.py``; these tests cover what that phase does not.  They
need an NVIDIA GPU and ``nvcc`` (marker ``cuda``) and skip elsewhere.  The file imports
no JAX; on a machine with the port's requirements only, skip the JAX ``conftest.py`` and
the xdist options of ``pytest.ini``:

    python -m pytest --noconftest -o addopts= -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from dgsqp_torch.ops import linalg


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_cuda_wrappers_count_launches_and_reject_bad_layout(dtype):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    A = (torch.eye(8, dtype=dtype, device='cuda') * 4.0).expand(3, 8, 8).contiguous()
    b = torch.ones(3, 8, dtype=dtype, device='cuda')
    n_chol, n_solve = linalg.cholesky.launches, linalg.cho_solve.launches
    by_n = (linalg.cholesky.launches_by_n.get(8, 0), linalg.cho_solve.launches_by_n.get(8, 0))
    L = linalg.cholesky(A)
    x = linalg.cho_solve(L, b)
    assert (linalg.cholesky.launches, linalg.cho_solve.launches) == (n_chol + 1, n_solve + 1)
    assert (linalg.cholesky.launches_by_n[8], linalg.cho_solve.launches_by_n[8]) \
        == (by_n[0] + 1, by_n[1] + 1)
    assert torch.equal(L, 2.0 * torch.eye(8, dtype=dtype, device='cuda').expand(3, 8, 8))
    assert torch.equal(x, torch.full_like(b, 0.25))
    with pytest.raises(ValueError):
        linalg.cholesky(A.transpose(-1, -2))                    # not contiguous
    with pytest.raises(ValueError):
        linalg.cho_solve(L, b.to(torch.float16))                # dtype differs from L
    assert (linalg.cholesky.launches, linalg.cho_solve.launches) == (n_chol + 1, n_solve + 1)


@pytest.mark.cuda
def test_cuda_kernel_rejects_oversized_matrix():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    A = torch.eye(200, dtype=torch.float64, device='cuda')[None]
    with pytest.raises(ValueError):
        linalg.cholesky(A)


@pytest.mark.cuda
def test_shared_memory_attribute_is_set_once_per_instantiation():
    """1000 launches of each kernel at one size raise its shared-memory limit at most
    once (once exactly when this is the size's first use in the process)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    A = (torch.eye(100, device='cuda') * 4.0).expand(4, 100, 100).contiguous()
    b1 = torch.ones(4, 100, device='cuda')
    b64 = torch.ones(4, 100, 64, device='cuda')
    L = linalg.cholesky(A)
    linalg.cho_solve(L, b1)
    linalg.cho_solve(L, b64)
    n_sets = (linalg.cholesky.attr_sets, linalg.cho_solve.attr_sets)
    n_launch = (linalg.cholesky.launches, linalg.cho_solve.launches)
    assert n_sets[0] >= 1 and n_sets[1] >= 2      # chol; warp and column kernels
    for _ in range(1000):
        linalg.cholesky(A)
        linalg.cho_solve(L, b1)
        x = linalg.cho_solve(L, b64)
    torch.cuda.synchronize()
    assert (linalg.cholesky.attr_sets, linalg.cho_solve.attr_sets) == n_sets
    assert (linalg.cholesky.launches, linalg.cho_solve.launches) \
        == (n_launch[0] + 1000, n_launch[1] + 2000)
    assert torch.equal(x, torch.full_like(b64, 0.25))
    # a smaller matrix needs no new limit; a larger one raises it once
    small = (torch.eye(24, device='cuda') * 4.0).expand(4, 24, 24).contiguous()
    big = (torch.eye(120, device='cuda') * 4.0).expand(4, 120, 120).contiguous()
    linalg.cholesky(small)
    assert linalg.cholesky.attr_sets == n_sets[0]
    linalg.cholesky(big)
    linalg.cholesky(big)
    assert linalg.cholesky.attr_sets == n_sets[0] + 1


@pytest.mark.cuda
def test_v2_round_on_the_card_launches_both_kernels_and_matches_cpu_float64():
    """One DGSQP v2 round on 4 games of the bench batch (N = 25): float32 on the card
    against float64 on the CPU, within the tolerances of ``chip_smoke.py``'s parity
    phase (derivative-based measures ``DERIV_RTOL``, the step ``STEP_RTOL``)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    from chip_smoke import DERIV_RTOL, STEP_RTOL, rel_err
    from dgsqp_torch.harness.bench_setup import build_bench_batch, build_bench_solver
    from dgsqp_torch.harness.scenarios import build_chicane_scenario
    sc = build_chicane_scenario(N=25, theta_deg=45.0)
    _, sol_d = build_bench_solver(horizon=25, solver_name='v2', scenario=sc,
                                  dtype=torch.float32, device='cuda')
    _, sol_c = build_bench_solver(horizon=25, solver_name='v2', scenario=sc,
                                  dtype=torch.float64, device='cpu')
    batch_d = build_bench_batch(sc, sol_d, 4, seed=0)
    batch_c = tuple(a.to('cpu', torch.float64) for a in batch_d)
    c_d0 = sol_d._init_carry(*batch_d)
    n_chol, n_solve = linalg.cholesky.launches, linalg.cho_solve.launches
    c_d = sol_d._make_body(batch_d[2], batch_d[3])(c_d0)
    assert linalg.cholesky.launches > n_chol and linalg.cho_solve.launches > n_solve
    c_c = sol_c._make_body(batch_c[2], batch_c[3])(sol_c._init_carry(*batch_c))
    for f in ('status', 'it', 'm_it', 'qp_solves', 'ck_counter', 'ck_valid', 'ck_fresh'):
        assert torch.equal(getattr(c_d, f).cpu(), getattr(c_c, f)), f
    assert int(c_d.it.min()) == 1 and not torch.equal(c_d.u, c_d0.u)
    for f, tol in (('memory', DERIV_RTOL), ('p_feas', DERIV_RTOL), ('comp', DERIV_RTOL),
                   ('stat', DERIV_RTOL), ('u', STEP_RTOL), ('delta', STEP_RTOL)):
        a, b = getattr(c_d, f).to('cpu', torch.float64), getattr(c_c, f)
        finite = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), finite), f
        assert rel_err(a[finite], b[finite]) <= tol, f


@pytest.mark.cuda
def test_approx_round_on_the_card_launches_both_kernels_and_matches_cpu_float64():
    """One round of ``DGSQPV2FrenetApprox`` (the ``approx`` bench solver, n = 150) on 4
    games: float32 on the card against float64 on the CPU, within the tolerances of
    ``chip_smoke.py``'s parity phases."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    from chip_smoke import DERIV_RTOL, STEP_RTOL, rel_err
    from dgsqp_torch.harness.bench_setup import build_bench_batch, build_bench_solver
    sc, sol_d = build_bench_solver(horizon=25, solver_name='approx', dtype=torch.float32,
                                   device='cuda')
    _, sol_c = build_bench_solver(horizon=25, solver_name='approx', scenario=sc,
                                  dtype=torch.float64, device='cpu')
    assert sol_d.n_dec == 150
    batch_d = build_bench_batch(sc, sol_d, 4, seed=0)
    batch_c = tuple(a.to('cpu', torch.float64) for a in batch_d)
    c_d0 = sol_d._init_carry(*batch_d)
    n_chol, n_solve = linalg.cholesky.launches, linalg.cho_solve.launches
    c_d = sol_d._make_body(batch_d[2], batch_d[3])(c_d0)
    assert linalg.cholesky.launches > n_chol and linalg.cho_solve.launches > n_solve
    c_c = sol_c._make_body(batch_c[2], batch_c[3])(sol_c._init_carry(*batch_c))
    for f in ('status', 'it', 'm_it', 'qp_solves', 'ck_counter', 'ck_valid', 'ck_fresh'):
        assert torch.equal(getattr(c_d, f).cpu(), getattr(c_c, f)), f
    assert int(c_d.it.min()) == 1 and not torch.equal(c_d.u, c_d0.u)
    for f, tol in (('memory', DERIV_RTOL), ('p_feas', DERIV_RTOL), ('stat', DERIV_RTOL),
                   ('u', STEP_RTOL)):
        a, b = getattr(c_d, f).to('cpu', torch.float64), getattr(c_c, f)
        finite = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), finite), f
        assert rel_err(a[finite], b[finite]) <= tol, f


@pytest.mark.cuda
def test_frenet_approx_mcp_on_the_card_matches_cpu_float64():
    """A few iterations of the MCP oracle on the approximate game
    (``PATHMCPFrenetApprox``, ``method='hybrid'``, two iterations a phase) on 4 games
    of the approximate duel (N = 10): float64 on the card against float64 on the CPU,
    the same statuses and iterations, ``u``/``l`` within 1e-6 of their scale."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    from chip_smoke import rel_err
    from dgsqp_torch.harness.mc_study import _dual_warm_start, _sample
    from dgsqp_torch.harness.scenarios import build_approximate_duel
    from dgsqp_torch.solvers.mcp import PATHMCPFrenetApprox
    from dgsqp_torch.solvers.solver_types import PATHMCPParams
    sc = build_approximate_duel(N=10)
    params = PATHMCPParams(N=sc.N, dt=sc.dt, tol=1e-3, method='hybrid', max_iters=2)
    solvers = [PATHMCPFrenetApprox(sc.joint_model, sc.costs, sc.agent_constraints,
                                   sc.shared_constraints, sc.bounds, params,
                                   print_method=None, dtype=torch.float64, device=dev)
               for dev in ('cuda', 'cpu')]
    x0, u_ws, _, _ = _sample(sc, 4, 0, torch.float64, 'cpu')
    x0 = torch.as_tensor(x0)
    u0 = solvers[1].problem.stage_to_u(torch.as_tensor(u_ws))
    up = torch.zeros(4, sc.joint_model.n_u, dtype=torch.float64)
    l0 = _dual_warm_start(solvers[1], u0, x0, up)
    res_d = solvers[0].solve_batch(*(a.cuda() for a in (u0, l0, x0, up)))
    res_c = solvers[1].solve_batch(u0, l0, x0, up)
    assert torch.equal(res_d.status.cpu(), res_c.status)
    assert torch.equal(res_d.iters.cpu(), res_c.iters) and int(res_c.iters.min()) > 0
    for f in ('u', 'l', 'res'):
        assert rel_err(getattr(res_d, f).cpu(), getattr(res_c, f)) <= 1e-6, f


@pytest.mark.cuda
def test_dynamic_duel_round_on_the_card_launches_the_kernels_and_matches_cpu_float64():
    """One DGSQP v2 round of the exact dynamic duel (N = 15, 4 games of the study's
    draw) with the study's parameters: float32 on the card, where ``dyn_step`` and both
    linear-algebra kernels launch, against float64 on the CPU, within the parity
    tolerances of ``chip_smoke.py``."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    from chip_smoke import (DERIV_RTOL, STEP_RTOL, dynamic_solver, rel_err,
                            study_batch)
    from dgsqp_torch.harness.dynamic_study import sample_dynamic_duel_initial_conditions
    from dgsqp_torch.harness.scenarios import build_dynamic_duel
    from dgsqp_torch.ops.dynamics import dyn_step
    sc = build_dynamic_duel(N=15)
    sol_d = dynamic_solver(sc, torch.float32, 'cuda')
    sol_c = dynamic_solver(sc, torch.float64, 'cpu')
    batch_d = study_batch(sc, sol_d, 4, sample_dynamic_duel_initial_conditions)
    batch_c = tuple(a.to('cpu', torch.float64) for a in batch_d)
    counts = (linalg.cholesky.launches, linalg.cho_solve.launches, dyn_step.launches)
    c_d0 = sol_d._init_carry(*batch_d)
    c_d = sol_d._make_body(batch_d[2], batch_d[3])(c_d0)
    assert linalg.cholesky.launches > counts[0] and linalg.cho_solve.launches > counts[1]
    assert dyn_step.launches > counts[2]
    c_c = sol_c._make_body(batch_c[2], batch_c[3])(sol_c._init_carry(*batch_c))
    for f in ('status', 'it', 'm_it', 'qp_solves'):
        assert torch.equal(getattr(c_d, f).cpu(), getattr(c_c, f)), f
    assert int(c_d.it.min()) == 1 and not torch.equal(c_d.u, c_d0.u)
    for f, tol in (('p_feas', DERIV_RTOL), ('stat', DERIV_RTOL), ('u', STEP_RTOL)):
        a, b = getattr(c_d, f).to('cpu', torch.float64), getattr(c_c, f)
        assert rel_err(a, b) <= tol, f


@pytest.mark.cuda
def test_dynamic_step_without_kernel_raises_on_the_card():
    """A Frenet dynamic bicycle on a spline track, and a subclass of a dynamic bicycle,
    have no kernel: their step raises on the card instead of running the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    from dgsqp_torch.dynamics import DynamicBicycle, DynamicBicycleConfig, DynamicCLBicycle
    spline = DynamicCLBicycle(0.0, DynamicBicycleConfig(
        dt=0.1, track_name='f1_austin_tenth_scale'))

    class Sub(DynamicBicycle):
        pass
    for m in (spline, Sub(0.0, DynamicBicycleConfig(dt=0.1))):
        q = torch.ones(2, m.n_q, device='cuda')
        u = torch.zeros(2, m.n_u, device='cuda')
        with pytest.raises(ValueError, match='no kernel'):
            m.fd(q, u)


@pytest.mark.cuda
def test_batch_of_one_kernels_match_torch_linalg():
    """The race's planner factors and solves one matrix at a time (B = 1, n = 80 with
    its 56-row polish; k = 1 on the warp path, k = 56 on the column path)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    from chip_smoke import rel_err, spd_batch
    gen = torch.Generator(device='cuda').manual_seed(0)
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        for n, k in ((80, 1), (80, 56), (56, 1)):
            A = spd_batch(1, n, dtype, 'cuda', gen)
            L = linalg.cholesky(A)
            assert rel_err(L.double(), torch.linalg.cholesky(A).double()) <= tol
            b = torch.randn(1, n, k, generator=gen, device='cuda', dtype=dtype)
            b = b[..., 0].contiguous() if k == 1 else b
            x = linalg.cho_solve(L, b)
            ref = torch.cholesky_solve(b[..., None] if k == 1 else b, L)
            assert rel_err(x.double(), ref.reshape(x.shape).double()) <= tol, (n, k)


@pytest.mark.cuda
def test_race_control_step_on_the_card_matches_cpu_float64():
    """One control step of the race (L_track_barc, mpc_N = game_N = 20, float64) on the
    card, where its trackers' rollout and linearization and its plants launch
    ``dyn_step`` and its game planner both linear-algebra kernels, against the same
    step on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    import numpy as np
    from chip_smoke import RACE_ATOL, race_state_vector
    from dgsqp_torch.harness.race import RaceConfig, RaceStack
    from dgsqp_torch.ops.dynamics import dyn_step
    fields = ('x.x', 'x.y', 'v.v_long', 'p.s', 'p.x_tran', 'p.e_psi', 'u.u_a', 'u.u_steer')
    out = {}
    counts = (linalg.cholesky.launches, linalg.cho_solve.launches, dyn_step.launches)
    for device in ('cuda', 'cpu'):
        stack = RaceStack(RaceConfig(), device=device, dtype=torch.float64)
        states = stack.initial_states()
        stack.run(initial_states=states, n_steps=1)
        out[device] = (np.array([race_state_vector(s, fields) for s in states]),
                       [(g['idx'], g['info']['msg']) for g in stack.game_log])
        if device == 'cuda':
            now = (linalg.cholesky.launches, linalg.cho_solve.launches, dyn_step.launches)
            assert all(b > a for a, b in zip(counts, now)), (counts, now)
    np.testing.assert_allclose(out['cuda'][0], out['cpu'][0], rtol=0, atol=RACE_ATOL)
    assert out['cuda'][1] == out['cpu'][1]
