"""Monte-Carlo study runner, ported from ``dgsqp_tpu/harness/mc_study.py``.

One call samples all initial conditions, warm-starts them as one batch and solves the
whole batch in lockstep on one device, or, with ``n_devices=k``, sharded over the k
ranks of a rank group (``dgsqp_torch.parallel``).  ``analyze_results`` gives the
study's statistics (success rate, iteration counts over converged samples, status
counts).
"""
from __future__ import annotations

import hashlib
import json
import pickle
import subprocess
import time
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from dgsqp_torch.harness.samplers import (sample_agents_initial_conditions,
                                          sample_duel_initial_conditions,
                                          sample_merge_initial_conditions)
from dgsqp_torch.harness.warm_start import seed_virtual_rate_prev
from dgsqp_torch.parallel.mesh import games_mesh, pad_to_multiple, shard_batch
from dgsqp_torch.solvers.dgsqp import CONV_ABS, CONV_REL, DGSQP, STATUS_MSG
from dgsqp_torch.solvers.solver_types import DGSQPParams

# the warm-up that precedes the timed solve (the kernels' build and first launches):
# the shortest chunk, or for a solver without a chunked solve (the MCP oracle) one
# iteration through the batched call's cap, on a few games
_WARMUP_GAMES = 16
_WARMUP_ITERS = 1


@dataclass
class MCResults:
    scenario: str
    solver: str
    num_samples: int
    statuses: np.ndarray
    iters: np.ndarray
    qp_solves: np.ndarray
    p_feas: np.ndarray
    comp: np.ndarray
    stat: np.ndarray
    u_sol: np.ndarray
    x0: np.ndarray
    wall_time_s: float
    # time of the warm-up that precedes the timed solve (the shortest chunk on a few
    # games: the kernels' build and first launches); the JAX package records its
    # compile time
    compile_time_s: float
    # self-describing run metadata (device, dtype, solver params + hash, git rev, seed)
    provenance: Optional[dict] = None


def run_provenance(solver, seed=None, extra: Optional[dict] = None) -> dict:
    """Metadata stamped into every ``MCResults``: device/dtype/params/git rev."""
    params = getattr(solver, 'params', None)
    pdict = {k: (v if isinstance(v, (int, float, str, bool, type(None))) else str(v))
             for k, v in asdict(params).items()} if params is not None else {}
    phash = hashlib.sha256(json.dumps(pdict, sort_keys=True).encode()).hexdigest()[:12]
    try:
        rev = subprocess.run(['git', 'rev-parse', '--short', 'HEAD'],
                             capture_output=True, text=True, timeout=60,
                             cwd=Path(__file__).resolve().parent).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        rev = None
    device = torch.device(getattr(solver, 'device', 'cpu'))
    prov = dict(platform=device.type,
                device_name=(torch.cuda.get_device_name(device) if device.type == 'cuda'
                             else 'cpu'),
                dtype=str(getattr(solver, 'dtype', torch.float32)).split('.')[-1],
                solver_class=type(solver).__name__,
                params=pdict, params_hash=phash, git_rev=rev, seed=seed,
                torch_version=torch.__version__)
    if extra:
        prov.update(extra)
    return prov


def _sample(scenario, num_samples, seed, dtype, device):
    if scenario.name.startswith('dynamic_approx'):
        from dgsqp_torch.harness.dynamic_study import sample_dynamic_pa_initial_conditions
        return sample_dynamic_pa_initial_conditions(scenario, num_samples, seed=seed,
                                                    dtype=dtype, device=device)
    if scenario.name.startswith('dynamic'):
        from dgsqp_torch.harness.dynamic_study import sample_dynamic_duel_initial_conditions
        return sample_dynamic_duel_initial_conditions(scenario, num_samples, seed=seed,
                                                      dtype=dtype, device=device)
    if scenario.name.startswith('merge'):
        return sample_merge_initial_conditions(scenario, num_samples, seed=seed,
                                               dtype=dtype, device=device)
    if scenario.name.startswith('agents'):
        return sample_agents_initial_conditions(scenario, num_samples, seed=seed,
                                                dtype=dtype, device=device)
    return sample_duel_initial_conditions(scenario, num_samples, seed=seed, dtype=dtype,
                                          device=device)


def _dual_warm_start(solver, u0, x0, up):
    # approximate-game solvers need their parameter pytree built from the warm start
    # before any constraint evaluate
    update = getattr(solver, '_approx_update', None)
    P = update(u0, x0) if update is not None else None
    return solver.problem.dual_warm_start(u0, x0, up, P)


def _u_perturb_scale(problem, dtype, device):
    """Per-flat-dim perturbation scale: half the input box width (1.0 where free)."""
    parts = []
    for a in range(problem.M):
        s = 0.5 * (np.asarray(problem.input_ub[a], np.float64)
                   - np.asarray(problem.input_lb[a], np.float64))
        s = np.where(np.isfinite(s), s, 1.0)
        parts.append(np.tile(s, problem.N))
    return torch.as_tensor(np.concatenate(parts), dtype=dtype, device=device)


def solve_with_retries(solver, retry_solvers, u0, l0, x0, up,
                       perturb_sigmas=(), seed: int = 0, chunk_iters=None,
                       res=None):
    """Batched solve with a retry cascade over alternative configurations and/or
    perturbed warm-start restarts.

    Games the primary configuration fails (any status but conv_abs) are re-solved by
    each retry solver in turn; converged retries are merged into the result in place.
    ``perturb_sigmas`` additionally re-solves the remaining failures with the same
    solver from a perturbed warm start (``u0 + sigma * box_scale * N(0,1)`` and a
    recomputed dual warm start).  Retries run on compacted power-of-two sub-batches, so
    their cost scales with the failure count, not the original batch.  ``res``
    (optional): an already-computed primary result to retry from.
    """
    kw = {} if chunk_iters is None else dict(chunk_iters=chunk_iters)
    if res is None:
        res = solver.solve_batch_chunked(u0, l0, x0, up, **kw)
    specs = [(rslv, None) for rslv in retry_solvers or ()]
    specs += [(solver, float(s)) for s in perturb_sigmas]
    if not specs:
        return res
    st = res.status.cpu().numpy().copy()
    out = {f: getattr(res, f).clone() for f in res._fields}
    rng = np.random.default_rng(seed)
    scale = None
    for rslv, sigma in specs:
        fail = np.where(st != CONV_ABS)[0]
        if fail.size == 0:
            break
        n_pad = max(16, 1 << (int(fail.size) - 1).bit_length())
        pad = torch.as_tensor(np.concatenate([fail, np.repeat(fail[:1], n_pad - fail.size)]),
                              device=u0.device)
        u0_s, l0_s, x0_s, up_s = u0[pad], l0[pad], x0[pad], up[pad]
        if sigma is not None:
            if scale is None:
                scale = _u_perturb_scale(rslv.problem, rslv.dtype, u0.device)
            noise = torch.as_tensor(rng.standard_normal((n_pad, int(scale.shape[0]))),
                                    dtype=rslv.dtype, device=u0.device)
            u0_s = u0_s + sigma * scale * noise
            l0_s = _dual_warm_start(rslv, u0_s, x0_s, up_s)

        r2 = rslv.solve_batch_chunked(u0_s, l0_s, x0_s, up_s, **kw)
        st2 = r2.status.cpu().numpy()[:fail.size]
        win = np.where(st2 == CONV_ABS)[0]
        if win.size:
            dst = torch.as_tensor(fail[win], device=u0.device)
            src = torch.as_tensor(win, device=u0.device)
            for f in res._fields:
                out[f][dst] = getattr(r2, f)[src].to(out[f].dtype)
            st[fail[win]] = CONV_ABS
    return type(res)(**out)


def run_mc_study(scenario, solver_params=None, num_samples: int = 200, seed: int = 0,
                 solver_cls=DGSQP, n_devices: Optional[int] = None,
                 solver=None, ibr_ws: bool = False,
                 dgsqp_ws_iters: int = 0, dtype=torch.float32, device='cuda') -> MCResults:
    """Run one Monte-Carlo configuration end to end, batched over all samples, on
    ``device`` in ``dtype`` (or on the device and in the dtype of ``solver`` when one is
    given).

    ``ibr_ws=True`` refines the PID warm start with one batched IBR (Gauss-Seidel
    best-response) sweep before the dual warm start.

    ``dgsqp_ws_iters=K`` (solvers other than DGSQP v1) warm-starts the solver from a
    K-iteration DGSQP v1 prefix, primal and duals.

    A solver with no ``solve_batch_chunked`` (the MCP oracle) runs its whole batched
    solve (``solve_batch``); its warm-up is one iteration on a few games.

    ``n_devices=k`` (k > 1) shards the study over the k ranks of the rank group this
    process belongs to (``spawn_ranks`` or ``init_distributed``; see
    ``dgsqp_torch.parallel``), SPMD: every rank makes the same call, on its rank's device.
    Every rank samples the same full batch (the sampler's PID warm start decides which
    draws it accepts) and pads it to a multiple of k by repeating the last game; each
    rank then warm-starts (IBR, the dual warm start, a DGSQP prefix) and solves its own
    block, the chunked solvers compacting across ranks, and every rank returns the
    results of all games in the original order.  A game's result does not depend on
    the partition.
    """
    mesh = None
    if n_devices not in (None, 1):
        mesh = games_mesh(n_devices)
        device = mesh.device
        if solver is not None and torch.device(solver.device) != mesh.device:
            raise ValueError(f'the solver is on {solver.device}, this rank on '
                             f'{mesh.device}')
    if solver is None:
        if solver_params is None:
            solver_params = DGSQPParams(N=scenario.N, dt=scenario.dt, reg=1e-3,
                                        nonmono_ls=True, line_search_iters=50,
                                        sqp_iters=50, p_tol=1e-3, d_tol=1e-3,
                                        beta=0.01, tau=0.5)
        solver = solver_cls(scenario.joint_model, scenario.costs,
                            scenario.agent_constraints, scenario.shared_constraints,
                            scenario.bounds, solver_params, print_method=None,
                            dtype=dtype, device=device)
    dtype, device = solver.dtype, solver.device

    x0_np, u_ws, _, _ = _sample(scenario, num_samples, seed, dtype, device)
    if mesh is None:
        u_ws = torch.as_tensor(u_ws, dtype=dtype, device=device)
        x0 = torch.as_tensor(x0_np, dtype=dtype, device=device)
    else:
        # this rank's block of the batch padded to a multiple of the ranks
        u_ws = shard_batch(mesh, pad_to_multiple(np.asarray(u_ws), mesh.size)[0]).to(dtype)
        x0 = shard_batch(mesh, pad_to_multiple(np.asarray(x0_np), mesh.size)[0]).to(dtype)
    u0 = solver.problem.stage_to_u(u_ws)
    up = torch.zeros(u_ws.shape[0], scenario.joint_model.n_u, dtype=dtype, device=device)
    up = seed_virtual_rate_prev(up, u_ws[:, 0, :], scenario.joint_model)
    if ibr_ws:
        from dgsqp_torch.solvers.ibr import IBR
        from dgsqp_torch.solvers.solver_types import IBRParams
        ibr = IBR(scenario.joint_model, scenario.costs, scenario.agent_constraints,
                  scenario.shared_constraints, scenario.bounds,
                  IBRParams(N=scenario.N, dt=scenario.dt, ibr_iters=1, p_tol=1e-3,
                            d_tol=1e-3), print_method=None, dtype=dtype, device=device)
        u0 = ibr._solve_core(u0, x0, up).u
    l0 = _dual_warm_start(solver, u0, x0, up)
    if dgsqp_ws_iters > 0 and not isinstance(solver, DGSQP):
        pre_params = DGSQPParams(N=scenario.N, dt=scenario.dt, reg=1e-3,
                                 nonmono_ls=True, line_search_iters=50,
                                 sqp_iters=int(dgsqp_ws_iters),
                                 p_tol=1e-3, d_tol=1e-3, beta=0.01, tau=0.5)
        pre = DGSQP(scenario.joint_model, scenario.costs, scenario.agent_constraints,
                    scenario.shared_constraints, scenario.bounds, pre_params,
                    print_method=None, dtype=dtype, device=device)
        pre_res = pre.solve_batch_chunked(u0, l0, x0, up, mesh=mesh)
        u0 = pre_res.u
        l0 = torch.clamp(pre_res.l, min=0.0)
        if mesh is not None:
            # the prefix returns every rank's games: keep this rank's block
            lo, hi = mesh.block(pre_res.u.shape[0])
            u0, l0 = u0[lo:hi], l0[lo:hi]

    sync = torch.cuda.synchronize if device.type == 'cuda' else (lambda: None)
    w = min(u0.shape[0], _WARMUP_GAMES)
    head = (u0[:w], l0[:w], x0[:w], up[:w])
    if hasattr(solver, 'solve_batch_chunked'):
        warm_up = lambda: solver.solve_batch_chunked(*head, chunk_iters=_WARMUP_ITERS,
                                                     max_chunks=1)
        batch_solve = lambda: solver.solve_batch_chunked(u0, l0, x0, up, mesh=mesh)
    else:
        warm_up = lambda: solver.solve_batch(*head, max_iters=_WARMUP_ITERS)
        if mesh is None:
            batch_solve = lambda: solver.solve_batch(u0, l0, x0, up)
        else:
            # sharded_batch_solve's gather; the blocks are this rank's already
            batch_solve = lambda: mesh.all_gather_rows(solver.solve_batch(u0, l0, x0, up))
    t0 = time.time()
    warm_up()
    sync()
    warmup = time.time() - t0

    t0 = time.time()
    res = batch_solve()
    sync()
    solve_time = time.time() - t0

    host = lambda t: t[:num_samples].cpu().numpy()
    extra = dict(ibr_ws=bool(ibr_ws), dgsqp_ws_iters=int(dgsqp_ws_iters))
    if mesh is not None:
        extra.update(world_size=mesh.size, backend=mesh.backend,
                     rank_devices=list(mesh.devices))
    return MCResults(scenario=scenario.name, solver=type(solver).__name__,
                     num_samples=num_samples,
                     statuses=host(res.status), iters=host(res.iters),
                     qp_solves=host(getattr(res, 'qp_solves', res.iters)),
                     p_feas=host(res.p_feas),
                     comp=host(res.comp), stat=host(res.stat), u_sol=host(res.u),
                     x0=np.asarray(x0_np),
                     wall_time_s=solve_time, compile_time_s=warmup,
                     provenance=run_provenance(solver, seed=seed, extra=extra))


def run_mc_study_algames(scenario, params=None, num_samples: int = 200, seed: int = 0,
                         dtype=torch.float32, device='cuda') -> MCResults:
    """Batched ALGAMES Monte-Carlo run on the same samples as the DGSQP studies, on
    ``device`` in ``dtype``: the state warm start is the rollout of the sampled input
    warm start, and ``qp_solves`` counts Newton solves."""
    from dgsqp_torch.harness.scenarios import joint_constraints_for_algames
    from dgsqp_torch.solvers.algames import ALGAMES
    from dgsqp_torch.solvers.solver_types import ALGAMESParams

    if params is None:
        params = ALGAMESParams(N=scenario.N, dt=scenario.dt, outer_iters=50,
                               newton_iters=50, line_search_iters=50,
                               ineq_tol=1e-3, eq_tol=1e-3, opt_tol=1e-3, rho=1.0,
                               gamma=10.0, beta=0.01, tau=0.5, q_reg=1e-3, u_reg=1e-3)
    solver = ALGAMES(scenario.joint_model, scenario.costs,
                     joint_constraints_for_algames(scenario), scenario.bounds,
                     params, print_method=None, dtype=dtype, device=device)
    device = solver.device

    x0_np, u_ws, _, _ = _sample(scenario, num_samples, seed, dtype, device)
    x0 = torch.as_tensor(x0_np, dtype=dtype, device=device)
    u_ws = torch.as_tensor(u_ws, dtype=dtype, device=device)
    # state warm start: roll the warm-start inputs through the joint dynamics
    qs = [x0]
    for k in range(scenario.N):
        qs.append(scenario.joint_model.fd(qs[-1], u_ws[:, k]))
    q_ws = torch.stack(qs, dim=1)
    up = torch.zeros(num_samples, scenario.joint_model.n_u, dtype=dtype, device=device)

    sync = torch.cuda.synchronize if device.type == 'cuda' else (lambda: None)
    w = min(num_samples, _WARMUP_GAMES)
    t0 = time.time()
    solver.solve_batch_chunked(q_ws[:w], u_ws[:w], x0[:w], up[:w],
                               chunk_iters=_WARMUP_ITERS, max_chunks=1)
    sync()
    warmup = time.time() - t0
    t0 = time.time()
    res = solver.solve_batch_chunked(q_ws, u_ws, x0, up)
    sync()
    solve_time = time.time() - t0

    host = lambda t: t.cpu().numpy()
    return MCResults(scenario=scenario.name, solver='ALGAMES', num_samples=num_samples,
                     statuses=host(res.status), iters=host(res.iters),
                     qp_solves=host(res.newton_solves), p_feas=host(res.p_feas),
                     comp=host(res.comp), stat=host(res.stat),
                     u_sol=host(res.u).reshape(num_samples, -1), x0=np.asarray(x0_np),
                     wall_time_s=solve_time, compile_time_s=warmup,
                     provenance=run_provenance(solver, seed=seed))


def analyze_results(results: MCResults) -> dict:
    """Success-rate and timing statistics."""
    conv = np.isin(results.statuses, (CONV_ABS, CONV_REL))
    out = dict(
        scenario=results.scenario,
        solver=results.solver,
        total=int(results.num_samples),
        converged=int(conv.sum()),
        success_rate=float(conv.mean()) if results.num_samples else 0.0,
        solves_per_s=results.num_samples / results.wall_time_s,
        mean_iters=float(results.iters[conv].mean()) if conv.any() else float('nan'),
        max_iters=int(results.iters.max()) if results.num_samples else 0,
        mean_qp_solves=float(results.qp_solves[conv].mean()) if conv.any() else float('nan'),
        status_counts={STATUS_MSG.get(int(s), str(s)): int((results.statuses == s).sum())
                       for s in np.unique(results.statuses)},
        feas_violation_max=float(np.max(results.p_feas)) if results.num_samples else 0.0,
    )
    prov = getattr(results, 'provenance', None)
    if prov:
        out['provenance'] = {k: prov[k] for k in
                             ('platform', 'device_name', 'dtype', 'solver_class',
                              'params_hash', 'git_rev', 'seed', 'torch_version')
                             if k in prov}
        # tolerance-semantics knobs surfaced at top level so a reader can tell a
        # scaled-KKT run from an absolute one without digging into params
        p = prov.get('params', {})
        for k in ('conv_scaled_stat', 'approximation_eval', 'p_tol', 'd_tol'):
            if k in p:
                out['provenance'][k] = p[k]
    return out


def save_results(results: MCResults, path):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, 'wb') as f:
        pickle.dump(results, f)
    with open(path.with_suffix('.json'), 'w') as f:
        json.dump(analyze_results(results), f, indent=2)
