"""Port parity: processes started apart and joined by ``init_distributed`` (the
counterpart of ``tests/test_multihost.py``), on the CPU in float64.

Two OS processes on 127.0.0.1, each given ``DGSQP_COORDINATOR``,
``DGSQP_NUM_PROCESSES``, ``DGSQP_PROCESS_ID`` and ``DGSQP_DEVICE=cpu``, solve their
blocks of one batch of the coupled integrator game of ``tests/test_multihost.py`` with
DGSQP v1's flat machine through ``solve_batch_chunked``.  The ranks keep the fixed layout
(every chunk at the global batch, where one process compacts), stop on the global
count, and give the statuses, ``u`` (1e-10) and global convergence statistics
(``convergence_stats`` with one ``all_reduce``) of one process; with none of the
variables set ``init_distributed`` joins nothing.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from dgsqp_torch.parallel.mesh import convergence_stats, init_distributed

from test_torch_cpu_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
N, DT, B = 5, 0.1, 8


def _solver():
    """tests/test_multihost.py's game: quadratic targets, a bilinear coupling and the
    shared constraint x_a + x_b <= 1, here on the flat machine (compaction floor 2) with
    6 iterations, so that games far from the constraint run out of them after the
    others converge."""
    from dgsqp_torch.dynamics import DynamicsConfig, IntegratorModel, MultiAgentDynamicsModel
    from dgsqp_torch.solvers.dgsqp import DGSQP
    from dgsqp_torch.solvers.solver_types import DGSQPParams
    from dgsqp_torch.types import VehicleState
    joint = MultiAgentDynamicsModel(0.0, [IntegratorModel(0.0, DynamicsConfig(dt=DT)),
                                          IntegratorModel(0.0, DynamicsConfig(dt=DT))])
    stage = lambda x, u, um: 0.5 * u[..., 0] ** 2
    term0 = lambda x: 50.0 * (x[..., 0] - 1.0) ** 2 + 0.3 * x[..., 0] * x[..., 1]
    term1 = lambda x: 50.0 * (x[..., 1] - 1.0) ** 2 + 0.3 * x[..., 0] * x[..., 1]
    cap = lambda x: (x[..., 0] + x[..., 1] - 1.0)[..., None]
    shared = [None] + [lambda x, u, um: cap(x)] * (N - 1) + [cap]
    ub, lb = VehicleState(), VehicleState()
    ub.v.v_long, ub.u.u_a = np.inf, 5.0
    lb.v.v_long, lb.u.u_a = -np.inf, -5.0
    solver = DGSQP(joint, [(stage, term0), (stage, term1)], [None, None], shared,
                   {'ub': [ub, ub.copy()], 'lb': [lb, lb.copy()]},
                   DGSQPParams(N=N, dt=DT, reg=1e-3, p_tol=1e-6, d_tol=1e-6,
                               sqp_iters=6, nonmono_ls=True, beta=0.01, tau=0.5),
                   print_method=None, dtype=torch.float64, device='cpu')
    solver._compact_min_bucket = 2
    return solver


def _batch(solver):
    rng = np.random.default_rng(0)
    # two starts far beyond the shared constraint run out of iterations
    x0 = np.concatenate([rng.normal(0, 0.3, (B - 2, solver.n_q)), [[2.5, 2.5], [4.0, 4.0]]])
    return [torch.as_tensor(a) for a in (np.zeros((B, solver.n_dec)),
                                         np.zeros((B, solver.n_c)), x0,
                                         np.zeros((B, solver.n_u)))]


def _solve(mesh=None):
    solver = _solver()
    args = _batch(solver)
    if mesh is not None:
        lo, hi = mesh.block(B)
        args = [a[lo:hi] for a in args]
    res = solver.solve_batch_chunked(*args, chunk_iters=1, mesh=mesh)
    hist = solver.last_chunk_history
    stats = convergence_stats(res.status if mesh is None else res.status[lo:hi], mesh)
    return dict(status=res.status.tolist(), u=res.u.tolist(), stats=stats,
                batches=[h['batch'] for h in hist])


def worker():
    """One process of the group: join from the environment, solve, print a JSON line."""
    from dgsqp_torch.parallel.mesh import games_mesh, leave
    torch.set_num_threads(1)
    assert init_distributed(timeout_s=TIMEOUT_S)
    try:
        mesh = games_mesh()
        out = _solve(mesh)
        out.update(size=mesh.size, rank=mesh.rank, multi_host=mesh.multi_host,
                   backend=mesh.backend)
        print(json.dumps(out), flush=True)
    finally:
        leave()


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def test_two_processes_joined_by_the_environment():
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith('DGSQP_')}
    env['PYTHONPATH'] = os.pathsep.join([str(ROOT), str(ROOT / 'tests'),
                                         env.get('PYTHONPATH', '')])
    env.update(DGSQP_COORDINATOR=f'127.0.0.1:{port}', DGSQP_NUM_PROCESSES='2',
               DGSQP_DEVICE='cpu')
    code = 'import test_torch_multihost as t; t.worker()'
    procs = [subprocess.Popen([sys.executable, '-c', code], cwd=ROOT, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env=dict(env, DGSQP_PROCESS_ID=str(i)))
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    one = _solve()
    assert min(one['batches']) < B          # one process compacts
    for r, rec in enumerate(outs):
        assert (rec['size'], rec['rank'], rec['multi_host'], rec['backend']) == \
            (2, r, True, 'gloo')
        assert all(b == B for b in rec['batches'])      # the fixed layout
        assert len(rec['batches']) == len(one['batches'])
        assert rec['status'] == one['status']
        np.testing.assert_allclose(rec['u'], one['u'], rtol=0, atol=1e-10)
        assert rec['stats'] == one['stats']
    assert one['stats']['converged'] > 0


def test_no_environment_joins_nothing(monkeypatch):
    for k in ('DGSQP_COORDINATOR', 'DGSQP_NUM_PROCESSES', 'DGSQP_PROCESS_ID'):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is False
    assert not torch.distributed.is_initialized()
