"""Port parity for the whole slice: the bench problem solved by DGSQP v1.

The JAX package's ``build_bench_solver``/``build_bench_batch`` (chicane duel, N=5,
batch 4, seed 0) and the port's, on the same inputs (``dgsqp_torch.interop``), through
``solve_batch_chunked(chunk_iters=4, compact=False)`` as the bench runs it, in float64 on
the CPU: per-game status, iteration and QP-solve counts are equal and the solutions
agree within 1e-6.  A second batch starts from perturbed inputs so that the watchdog's
insurance and fallback modes and a divergence are exercised too.  A diverged game stops
where its stationarity passed 1e5, with duals that grow without bound through QPs the
IPM cannot solve; its status and counts are compared, its iterate is not.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgsqp_tpu.harness.bench_setup import build_bench_batch as jax_batch
from dgsqp_tpu.harness.bench_setup import build_bench_solver as jax_solver
from dgsqp_torch import interop
from dgsqp_torch.harness.bench_setup import build_bench_batch, build_bench_solver
from dgsqp_torch.solvers.dgsqp import CONV_ABS, CONV_REL, FM_FB, FM_INS2, SQPResult

from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

N, BATCH = 5, 4
# perturbation of the warm start that makes these 4 games visit the watchdog's
# insurance (FM_INS2) and fallback (FM_FB) modes and one diverge
SIGMA, NOISE_SEED = 0.5, 2


@pytest.fixture(scope='module')
def jax_bench():
    sc, solver = jax_solver(horizon=N)
    batch = jax_batch(sc, solver, BATCH, seed=0)
    return sc, solver, tuple(np.asarray(a) for a in batch)


@pytest.fixture(scope='module')
def port(jax_bench):
    jsc, _, _ = jax_bench
    sc, solver = build_bench_solver(horizon=N, dtype=torch.float64, device='cpu')
    # both packages query bit-identical track tables
    interop.load_track_tables(sc.track, np.asarray(jsc.track._kp),
                              np.asarray(jsc.track._cum_angle))
    return sc, solver


def _perturbed(batch):
    u0, l0, x0, up = batch
    noise = SIGMA * np.random.default_rng(NOISE_SEED).standard_normal(u0.shape)
    return u0 + noise, l0, x0, up


def test_bench_batch_matches(jax_bench, port):
    """Sampler, PID warm start and least-squares dual warm start agree."""
    _, _, batch_j = jax_bench
    sc, solver = port
    batch_t = build_bench_batch(sc, solver, BATCH, seed=0)
    for a_j, a_t in zip(batch_j, batch_t):
        np.testing.assert_allclose(a_t.numpy(), a_j, rtol=0, atol=1e-10)


@pytest.mark.parametrize('perturb', [False, True])
def test_solve_matches_jax(jax_bench, port, perturb):
    _, jsolver, batch = jax_bench
    _, solver = port
    if perturb:
        batch = _perturbed(batch)
    res_j = jsolver.solve_batch_chunked(*(jnp.asarray(a) for a in batch), chunk_iters=4,
                                        compact=False)
    res_j = interop.to_torch_tuple(res_j, SQPResult, device='cpu')
    res_t = solver.solve_batch_chunked(*interop.bench_batch(*batch, device='cpu'),
                                       chunk_iters=4, compact=False)
    assert torch.equal(res_t.status.long(), res_j.status.long())
    assert torch.equal(res_t.iters.long(), res_j.iters.long())
    assert torch.equal(res_t.qp_solves.long(), res_j.qp_solves.long())
    conv = np.isin(res_j.status.numpy(), (CONV_ABS, CONV_REL))
    assert conv.sum() >= 3
    for f in ('u', 'l', 'stat', 'p_feas', 'comp'):
        np.testing.assert_allclose(getattr(res_t, f).numpy()[conv],
                                   getattr(res_j, f).numpy()[conv], rtol=0, atol=1e-6)
    # the fixed-layout history records the batch each chunk ran at
    assert all(h['batch'] == BATCH for h in solver.last_chunk_history)


def test_perturbed_batch_exercises_the_watchdog(jax_bench, port):
    _, _, batch = jax_bench
    _, solver = port
    modes = set()
    round_fn = solver._round

    def spy(c, x0, up, P=None):
        modes.update(c.mode[c.status == 0].tolist())
        return round_fn(c, x0, up, P)

    solver._round = spy
    try:
        res = solver.solve_batch_chunked(*interop.bench_batch(*_perturbed(batch),
                                                              device='cpu'),
                                         chunk_iters=4, compact=False)
    finally:
        del solver._round
    assert {FM_INS2, FM_FB} <= modes
    assert len(set(res.status.tolist())) > 1


def test_compaction_matches_fixed_layout(jax_bench, port):
    """Straggler compaction (finished games harvested, the rest gathered into a smaller
    bucket) changes no game's result; the history records each chunk's batch size."""
    _, _, batch = jax_bench
    _, solver = port
    args = interop.bench_batch(*_perturbed(batch), device='cpu')
    res_fixed = solver.solve_batch_chunked(*args, chunk_iters=1, compact=False)
    hist_fixed = solver.last_chunk_history
    solver._compact_min_bucket = 1
    try:
        res_comp = solver.solve_batch_chunked(*args, chunk_iters=1, compact=True)
    finally:
        del solver._compact_min_bucket
    hist_comp = solver.last_chunk_history
    for f in SQPResult._fields:
        a, b = getattr(res_fixed, f), getattr(res_comp, f)
        if a.is_floating_point():
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-12)
        else:
            assert torch.equal(a, b), f
    assert all(h['batch'] == BATCH for h in hist_fixed)
    sizes = [h['batch'] for h in hist_comp]
    assert sizes[0] == BATCH and min(sizes) < BATCH
