#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``dgsqp_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with the card:

    python3 chip_smoke.py

Phases, each printing one line on stdout:

1. ``build``: compiles the CUDA kernels from ``dgsqp_torch/ops/csrc`` with ``nvcc`` and
   prints the card's name and power limit (``nvidia-smi``).
2. ``kernels``: holds each kernel against its plain PyTorch version on the card, in
   float32 and float64, at every shape of the paths below (the bench problem's n = 100
   with its 64-row polish, the agents study's n = 36 with its 48-row polish), at the
   shapes that reach the other branches of the kernels (an odd size, n = 150,
   right-hand-side counts on each side of the switch between the two ``cho_solve``
   kernels and off the tile width), the approximate duel's n = 150 with its 96-row
   polish, IBR's best response's n = 50 with its 48-row polish, the merge's n = 120
   with its 80-row polish (float64 there), and on a batch with one matrix that is not
   positive definite; and times the kernel (device time from a replayed CUDA graph, and
   the time per call of a loop of eager calls), the plain version and the library call
   that computes the same function.
3. ``parity``: one round of ``evaluate`` + convexified QP on 16 games of the seed-0
   bench batch, the port on the card in float32 against the port on the CPU in float64.
4. ``main_path``: the bench problem (two-agent chicane duel, N=25, theta=45 deg, batch
   256, seed 0, float32, DGSQP v1) solved with ``solve_batch_chunked(chunk_iters=4,
   compact=False)``, after a warm-up of one chunk on 16 games, with the kernels' launch
   counts.
5. ``v2_path``: the same batch solved by DGSQP v2 (``build_bench_solver(solver_name=
   'v2')``) with ``solve_batch_chunked(chunk_iters=4)``, compaction on, after the same
   warm-up, with the launch counts, the m-step counts and the chunks' bucket sizes.
6. ``mc_study``: ``run_mc_study`` on the agents scenario (M=3, N=6, n=36 decisions), 16
   samples, seed 0, DGSQP v2, float32, with the launch counts and ``analyze_results``.
7. ``approx_parity``: as ``parity``, on 16 games of the approximate duel's bench batch
   (``build_bench_solver(solver_name='approx')``: progress-augmented bicycles, N=25,
   n=150 decisions, ``approximation_eval='exact'``), DGSQP v2's symmetrised Hessian and
   QP with its regularisation.
8. ``approx_path``: that batch (256 games, seed 0, float32) solved by
   ``DGSQPV2FrenetApprox`` with ``solve_batch_chunked(chunk_iters=4)``, compaction on,
   after the same warm-up, with the launch counts, m-step counts and buckets.
9. ``oracle_path``: the equilibrium-match study of the chicane (theta=45 deg, N=25,
   n=100, m=525) in float64, seed 0, 128 games: ``run_mc_study`` with DGSQP v1's study
   defaults and with the PATH-role MCP oracle (``PATHMCP``, ``method='hybrid'``,
   tol 1e-3, 200 iterations, 4 restarts), then ``gne_compare`` of the two (input scale
   2.1/0.436 per agent, match tolerance 0.1, conv_abs only), beside the JAX package's
   record of the same games (``docs/match_dgsqp_mcp_chicane_N25_r5.json``).
10. ``ibr_ws``: one batched IBR sweep (``IBRParams(ibr_iters=1, p_tol=d_tol=1e-3)``, the
   study's ``ibr_ws`` warm start) on the 256-game float32 bench batch: both kernels at
   the best response's n = 50 (and its polish's 48 rows).
11. ``algames_path``: ``run_mc_study_algames`` on the same chicane in float64 (n_y = 1000
   decisions a game) on the first 8 of the ``oracle_path``'s games, compared with its
   DGSQP by ``gne_compare``.
12. ``merge_path``: the equilibrium-match study of the merge (three kinematic unicycles,
   N=20, n = 120 decisions) in float64, seed 0, 128 games: ``run_mc_study`` with DGSQP
   v1's study defaults, the MCP oracle as in ``oracle_path``, then ``gne_compare``
   (input scale 2.1/0.436 per agent, match tolerance 0.1, conv_abs only), beside the
   JAX package's record
   (``docs/match_dgsqp_mcp_merge_N20.json``); both kernels must launch at n = 120 and
   at the polish's 80 rows.  It runs in a process of its own (``chip_smoke.py
   --merge-path``, started by this one), beside ``oracle_path``, ``ibr_ws`` and
   ``algames_path``: every path is host-bound on one CPU core with the card mostly
   idle, so the two share the card and take a core each; its line is printed when it
   ends.
13. ``dp_parity``: the stage-wise game derivatives (``evaluate_dp``) against
   ``evaluate``, both with the Hessian in float32 on the card, on the bench batch (256
   games at the warm start) and on the merge's 128 games: relative differences of Q, q,
   G and g, the median time of a call of each and the CUDA launches of one.

The launch counts are set to 0 just before each path and read just after; each path
that runs the kernels fails if one was not launched in it.  Then one JSON line of
per-kernel numbers (``launches`` is the count of ``v2_path``, ``launches_by_path`` has
every path), and last ``{"ok": true, "device": ...}``.  Every line also goes to
``build/chip_smoke.jsonl`` (the kernels line alone is longer than a caller may see of
the output's tail).
Any failed check raises and the script exits non-zero; without a card it exits
non-zero before printing any result.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and dense arithmetic outside the
# tensor cores (float32 67 TFLOP/s, float64 34 TFLOP/s)
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {'float32': 67e12, 'float64': 34e12}
# kernel vs plain version on inputs of condition number COND: the two repeat the same
# arithmetic up to fused multiply-adds, so they differ by a few COND * eps
COND = 100.0
KERNEL_RTOL = {'float32': 1e-4, 'float64': 1e-10}
# float32 on the card against float64 on the CPU, same inputs: derivatives carry f32
# rounding through a 25-step rollout (~1e-6 relative); the QP step is solved to a 3e-7
# tolerance after Ruiz scaling, so its relative error is ~1e-3
DERIV_RTOL = 1e-4
STEP_RTOL = 2e-2
CONV_ABS_MIN, CONV_ANY_MIN = 0.45, 0.70
# DGSQP v2 on the same batch: the JAX package's float32 record is 0.555 conv_abs with no
# conv_rel exit, so both limits are 0.45
V2_CONV_ABS_MIN, V2_CONV_ANY_MIN = 0.45, 0.45
# the approximate duel: the JAX package's float32 record of its seed-0 batch is 0.094
# conv_abs and 0.961 conv_abs + conv_rel (float32 stationarity plateaus near the O(1e3)
# gradient scale's rounding, so most games exit conv_rel); conv_abs is reported against
# its limit, conv_abs + conv_rel fails below its own
APPROX_CONV_ABS_LIMIT, APPROX_CONV_ANY_MIN = 0.03, 0.85
APPROX_N_DEC = 150
# the sizes both kernels must launch at on that path: the interior-point normal matrix
# (n = 150) and the polish's Schur complement (max(48, 150 // 2 + 14) = 89 rows, padded
# to 96)
APPROX_KERNEL_NS = (150, 96)
WARMUP_GAMES = 16
# the agents study of the mc_study phase: the bench's operating point for the exact game
# (small constant regularization) with a short budget
MC_AGENTS, MC_HORIZON, MC_SAMPLES = 3, 6, 16
MC_PARAMS = dict(sqp_iters=30, p_tol=1e-3, d_tol=1e-3, reg=1e-3, reg_decay=1.0,
                 nms_frequency=5, nms_memory_size=5, stall_its=10, line_search_iters=20)
# the equilibrium-match study: its games, the options of its comparison and the JAX
# package's float64 record of the same games (DGSQP 78 conv_abs, MCP 68, both 63, all
# 63 matched); the limits leave room for rounding flips on ill-posed QPs and sit far
# above what a broken solver reaches (records: 0.609 and 0.531 conv_abs)
ORACLE_GAMES, ORACLE_SEED = 128, 0
ORACLE_COMPARE = dict(N=25, num_ua=[2, 2], input_scale=[2.1, 0.436, 2.1, 0.436],
                      match_tol=0.1, success='abs')
ORACLE_RECORD = dict(converged_a=78, converged_b=68, both_converged=63, match=63,
                     nmse_max=2.926231472253517e-05)
ORACLE_MATCH_MIN, ORACLE_MCP_CONV_MIN, ORACLE_DGSQP_CONV_MIN = 0.95, 0.40, 0.50
# the IBR sweep of the study's warm start: the best response's decisions and polish rows
IBR_KERNEL_NS = (50, 48)
# the merge's equilibrium-match study: three unicycles, N=20, n = 3 x 2 x 20 = 120
# decisions, float64, the games of the JAX package's record (seed 0, 128 games; its
# comparison scaled the inputs by 2.1 / 0.436 per agent, as for every suite of that
# record); the record (the r3 solver, conv incl. rel) has every game converged and
# matched
MERGE_GAMES, MERGE_SEED, MERGE_N = 128, 0, 20
MERGE_COMPARE = dict(N=MERGE_N, num_ua=[2, 2, 2], input_scale=[2.1, 0.436] * 3,
                     match_tol=0.1, success='abs')
MERGE_RECORD = dict(converged_a=128, converged_b=128, both_converged=128, match=128,
                    nmse_median=4.258178923336239e-05, nmse_max=0.05744580368899047)
MERGE_MATCH_MIN, MERGE_DGSQP_CONV_MIN, MERGE_MCP_CONV_MIN = 0.95, 0.85, 0.85
# the decisions and the polish's rows (max(48, 120 // 2 + 14) = 74, padded to 80) the
# kernels must launch at on the merge
MERGE_KERNEL_NS = (120, 80)
# evaluate_dp against evaluate, both float32 on the card on the same inputs: each
# carries float32 rounding through the 25-step rollout (~1e-6 relative, as DERIV_RTOL
# says), summed in another order, so the two differ by about as much
DP_RTOL = 1e-4
DP_GAMES = 256
# ALGAMES on the first games of the oracle study (8: the first cut the time limit asked
# for; a Newton iteration is host-bound, so 16 games cost about 1.6x as long); its match
# with DGSQP is checked when at least ALGAMES_MIN_BOTH games converge in both
ALGAMES_GAMES, ALGAMES_MATCH_MIN, ALGAMES_MIN_BOTH = 8, 0.9, 4


# every emitted line also goes to this file (the output's tail is all a caller may see)
LOG = Path(__file__).resolve().parent / 'build' / 'chip_smoke.jsonl'


def emit(obj):
    line = json.dumps(obj)
    print(line, flush=True)
    with open(LOG, 'a') as f:
        f.write(line + '\n')


def gpu_name_and_limit() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, launches: int = 20, reps: int = 10) -> float:
    """Device time of one launch of ``fn``: ``launches`` of them captured into a CUDA
    graph and replayed, so that the host's time to issue a launch (tens of microseconds
    through a Python wrapper, more than a fast kernel takes) is not in the number."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return time_ms(graph.replay, reps) / launches


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def spd_batch(B, n, dtype, device, gen, cond=COND):
    """Random SPD matrices U diag(s) U' with eigenvalues log-spaced in [1, cond]."""
    import torch
    X = torch.randn(B, n, n, generator=gen, device=device, dtype=torch.float64)
    U, _ = torch.linalg.qr(X)
    s = torch.logspace(0, torch.log10(torch.tensor(cond)).item(), n, dtype=torch.float64,
                       device=device)
    A = (U * s) @ U.transpose(-1, -2)
    return (0.5 * (A + A.transpose(-1, -2))).to(dtype).contiguous()


def phase_build():
    from dgsqp_torch.ops import linalg
    t0 = time.time()
    reports = linalg.build_kernels()
    seconds = time.time() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if 'registers' in ln or 'spill' in ln]
             for name, log in reports.items()}
    card = gpu_name_and_limit()
    print(card, flush=True)
    emit({'phase': 'build', 'seconds': round(seconds, 3), 'card': card, 'ptxas': ptxas})
    spilled = [ln for lines in ptxas.values() for ln in lines
               if 'spill' in ln and not ln.startswith('0 bytes stack frame, 0 bytes spill stores, '
                                                      '0 bytes spill loads')]
    if spilled:
        raise AssertionError(f'ptxas reports register spills: {spilled}')
    return card


def bound(kind, B, n, k, dtype):
    """Least time for the function's work: both functions need only the lower triangle
    of their matrix input; chol writes all of L (its upper triangle as zero)."""
    it = 4 if dtype == 'float32' else 8
    tri = n * (n + 1) // 2
    if kind == 'chol':
        nbytes = B * (tri + n * n) * it
        flops = B * n ** 3 / 3
    else:
        nbytes = B * (tri + 2 * n * k) * it
        flops = 2 * B * n * n * k
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOP_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops else 'operations')


def check_non_pd(dtype, device, gen, B=8, n=100, bad=3):
    """A batch in which matrix ``bad`` is not positive definite: its factor and solution
    turn non-finite, nothing raises, and every other matrix matches the plain version."""
    import torch
    from dgsqp_torch.ops import linalg
    dname = str(dtype).split('.')[-1]
    A = spd_batch(B, n, dtype, device, gen)
    A[bad] = -A[bad]
    b = torch.randn(B, n, generator=gen, device=device, dtype=dtype)
    L, L_ref = linalg.cholesky(A), linalg.cholesky_plain(A)
    x, x_ref = linalg.cho_solve(L, b), linalg.cho_solve_plain(L_ref, b)
    good = [i for i in range(B) if i != bad]
    errs = {'chol': rel_err(L[good].double(), L_ref[good].double()),
            'cho_solve': rel_err(x[good].double(), x_ref[good].double())}
    if torch.isfinite(L[bad]).all() or torch.isfinite(x[bad]).all():
        raise AssertionError(f'non-PD matrix gave a finite factor or solution ({dname})')
    if not all(torch.isfinite(t[good]).all() for t in (L, x)) \
            or not all(e <= KERNEL_RTOL[dname] for e in errs.values()):
        raise AssertionError(f'a non-PD matrix disturbed its neighbours ({dname}): {errs}')
    return dict(kernel='non_pd', dtype=dname, B=B, n=n, bad=bad, rel_err=errs)


def phase_kernels(device='cuda', shapes=None, time_it=True):
    """Kernel against plain version at the main-path shapes; returns per-shape rows."""
    import torch
    from dgsqp_torch.ops import linalg
    gen = torch.Generator(device=device).manual_seed(0)
    shapes = shapes or {
        'chol': [(256, 100, 0), (256, 64, 0), (5, 37, 0), (64, 150, 0),
                 (16, 36, 0), (16, 48, 0), (256, 150, 0), (256, 96, 0), (256, 50, 0),
                 (256, 48, 0), (128, 120, 0), (128, 80, 0)],
        'cho_solve': [(256, 100, 1), (256, 100, 64), (256, 64, 1), (5, 37, 3), (256, 100, 8),
                      (256, 100, linalg.WARP_PATH_MAX_K), (256, 100, linalg.WARP_PATH_MAX_K + 1),
                      (256, 100, 33), (5, 37, 33), (64, 150, 1), (64, 150, 64),
                      (16, 36, 1), (16, 36, 36), (16, 36, 48), (16, 48, 1),
                      (256, 150, 1), (256, 150, 96), (256, 96, 1), (256, 50, 1),
                      (256, 50, 48), (256, 48, 1), (128, 120, 1), (128, 120, 80),
                      (128, 80, 1)]}
    rows = []
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split('.')[-1]
        for kind, shp in shapes.items():
            for B, n, k in shp:
                A = spd_batch(B, n, dtype, device, gen)
                if kind == 'chol':
                    out = linalg.cholesky(A)
                    ref = linalg.cholesky_plain(A)
                    if (torch.triu(out, 1) != 0).any():
                        raise AssertionError(f'chol {B}x{n} {dname}: upper triangle not zero')
                    kern = lambda: linalg.cholesky(A)
                    plain = lambda: linalg.cholesky_plain(A)
                    lib = lambda: torch.linalg.cholesky(A)
                else:
                    L = linalg.cholesky_plain(A)
                    b = torch.randn(B, n, k, generator=gen, device=device, dtype=dtype)
                    b = b[..., 0].contiguous() if k == 1 else b
                    out = linalg.cho_solve(L, b)
                    ref = linalg.cho_solve_plain(L, b)
                    b3 = b[..., None] if k == 1 else b
                    kern = lambda: linalg.cho_solve(L, b)
                    plain = lambda: linalg.cho_solve_plain(L, b)
                    lib = lambda: torch.cholesky_solve(b3, L)
                torch.cuda.synchronize() if device == 'cuda' else None
                err = rel_err(out.double(), ref.double())
                abs_err = float((out.double() - ref.double()).abs().max())
                if not (err <= KERNEL_RTOL[dname]) or not torch.isfinite(out).all():
                    raise AssertionError(f'{kind} B={B} n={n} k={k} {dname}: relative error '
                                         f'{err:.3e} > {KERNEL_RTOL[dname]:.0e}')
                row = dict(kernel=kind, dtype=dname, B=B, n=n, k=k, rel_err=err,
                           max_abs_err=abs_err, tol=KERNEL_RTOL[dname], cond=COND)
                if kind == 'cho_solve':
                    row['path'] = linalg.cho_solve_plan(n, k, A.element_size())[0]
                if time_it:
                    row['ms'] = graph_ms(kern)
                    row['eager_ms'] = time_ms(kern, 50)
                    row['plain_ms'] = time_ms(plain, 3)
                    row['library_ms'] = time_ms(lib, 20)
                    row['bound_ms'], row['bound_by'] = bound(kind, B, n, k, dname)
                rows.append(row)
        rows.append(check_non_pd(dtype, device, gen))
    emit({'phase': 'kernels', 'kernels': ['chol', 'cho_solve'],
          'launches_in_this_phase': {'chol': linalg.cholesky.launches,
                                     'cho_solve': linalg.cho_solve.launches},
          'shapes': rows})
    return [r for r in rows if r['kernel'] != 'non_pd']


def _eval_and_step(sol, u0, l0, x0, up):
    """One evaluate + convexified QP step: v1's ``_qp(Q, q, G, g)`` on the game Hessian,
    or v2's symmetrised Hessian and ``_qp`` with the initial regularisation."""
    import torch
    from dgsqp_torch.solvers.dgsqp_v2 import DGSQPV2
    if isinstance(sol, DGSQPV2):
        out = sol._eval_full(u0, l0, x0, up, None)
        reg = torch.full((u0.shape[0],), sol.params.reg, dtype=sol.dtype, device=sol.device)
        return out, sol._qp(*out, reg)[0]
    out = sol.problem.evaluate(u0, l0, x0, up)[:4]
    return out, sol._qp(*out)[0]


def phase_parity(sc, sol_dev, sol_cpu, batch, n_games=16, phase='parity'):
    """One evaluate + convexified QP: the port on the card (f32) against the port on the
    CPU (f64) on the same inputs."""
    import torch
    u0, l0, x0, up = (a[:n_games] for a in batch)
    out_d, du_d = _eval_and_step(sol_dev, u0, l0, x0, up)
    args_c = [a.detach().to('cpu', torch.float64) for a in (u0, l0, x0, up)]
    out_c, du_c = _eval_and_step(sol_cpu, *args_c)
    diffs = {name: rel_err(a.to('cpu', torch.float64), b)
             for name, a, b in zip('Q q G g'.split(), out_d, out_c)}
    diffs['du'] = rel_err(du_d.to('cpu', torch.float64), du_c)
    line = {'phase': phase, 'scenario': sc.name, 'games': n_games, 'rel_diff': diffs,
            'tol': {'derivatives': DERIV_RTOL, 'du': STEP_RTOL},
            'why': 'f32 on the card vs f64 on the CPU: derivatives carry f32 rounding '
                   'through the rollout; the QP step is solved to 3e-7 after Ruiz scaling'}
    emit(line)
    bad = [k for k, v in diffs.items()
           if not v <= (STEP_RTOL if k == 'du' else DERIV_RTOL)]
    if bad:
        raise AssertionError(f'{phase} outside tolerance: {bad}')
    return diffs


def reset_launches():
    from dgsqp_torch.ops import linalg
    for wrapper in (linalg.cholesky, linalg.cho_solve):
        wrapper.launches = 0
        wrapper.launches_by_n = {}


def read_launches():
    from dgsqp_torch.ops import linalg
    return {'chol': linalg.cholesky.launches, 'cho_solve': linalg.cho_solve.launches}


def read_launches_by_n():
    from dgsqp_torch.ops import linalg
    return {'chol': dict(linalg.cholesky.launches_by_n),
            'cho_solve': dict(linalg.cho_solve.launches_by_n)}


def phase_bench_path(phase, solver_name, sol, batch, conv_min, conv_any_min, chunk=4,
                     metric='chicane_2agent_solves_per_s', n_dec=None, conv_abs_limit=None,
                     kernel_ns=(), **kw):
    """Solve the bench batch with ``sol.solve_batch_chunked(chunk_iters=chunk, **kw)``
    after a warm-up of one chunk on a few games, print the bench's fields and check the
    result.  Every result must be finite; for v2 and the approximate game a game that
    diverged is exempt (it stops with whatever iterate it had).  ``conv_min`` fails the
    phase below it; ``n_dec``, where given, is the decision count the path must run at,
    and both kernels must have launched at every matrix size of ``kernel_ns``."""
    import numpy as np
    import torch
    from dgsqp_torch.ops import linalg
    from dgsqp_torch.solvers.dgsqp import CONV_ABS, CONV_REL, DIVERGED, RUNNING, STATUS_MSG
    u0, l0, x0, up = batch
    B = u0.shape[0]

    t0 = time.time()
    sol.solve_batch_chunked(*(a[:WARMUP_GAMES] for a in batch), chunk_iters=chunk,
                            max_chunks=1, **kw)
    torch.cuda.synchronize()
    warmup_s = time.time() - t0

    # count the batched QP solves (one per round) beside the kernels' launches
    qp_calls = [0]
    inner_qp = sol._qp

    def counted_qp(*a, **k):
        qp_calls[0] += 1
        return inner_qp(*a, **k)

    sol._qp = counted_qp
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    attr_sets = linalg.cholesky.attr_sets + linalg.cho_solve.attr_sets
    t0 = time.time()
    try:
        res = sol.solve_batch_chunked(u0, l0, x0, up, chunk_iters=chunk, **kw)
    finally:
        del sol._qp
    torch.cuda.synchronize()
    dur = time.time() - t0
    launches = read_launches()
    launches_by_n = read_launches_by_n()

    status = res.status.cpu().numpy()
    iters = res.iters.cpu().numpy()
    stat_f = res.stat.double().cpu().numpy()
    p = sol.params
    conv = float(np.isin(status, (CONV_ABS,)).mean())
    conv_any = float(np.isin(status, (CONV_ABS, CONV_REL)).mean())
    conv_ref_abs = float(((res.p_feas.double().cpu().numpy() <= p.p_tol)
                          & (res.comp.double().cpu().numpy() <= p.d_tol)
                          & (stat_f <= p.d_tol)).mean())
    hist = {STATUS_MSG.get(int(s), str(s)): int((status == s).sum()) for s in np.unique(status)}
    chunks = sol.last_chunk_history
    line = {
        'phase': phase,
        'metric': metric,
        'value': B / dur,
        'unit': 'solves/s',
        'solve_s': dur,
        'warmup_s': warmup_s,
        'convergence_rate': conv,
        'convergence_rate_incl_rel': conv_any,
        'convergence_rate_ref_abs': conv_ref_abs,
        'p_tol': p.p_tol, 'd_tol': p.d_tol,
        'status_counts': hist,
        'iters_p50': float(np.median(iters)), 'iters_max': int(iters.max()),
        'stat_p50': float(np.median(stat_f)), 'stat_p90': float(np.percentile(stat_f, 90)),
        'batch': int(B), 'horizon': sol.N, 'n_dec': sol.n_dec, 'n_c': sol.n_c,
        'solver': solver_name, 'dtype': str(sol.dtype),
        'chunks': len(chunks), 'running_after_chunk': [c['running'] for c in chunks],
        'chunk_batch': [c['batch'] for c in chunks],
        'chunk_wall_s': [c['wall_s'] for c in chunks],
        'launches': launches, 'launches_by_n': launches_by_n, 'qp_calls': qp_calls[0],
        'peak_device_mib': torch.cuda.max_memory_allocated() / 2 ** 20,
        'attr_sets_in_this_solve': (linalg.cholesky.attr_sets + linalg.cho_solve.attr_sets
                                    - attr_sets),
        # one digit per game, in batch order: the game's status code
        'status_string': ''.join(str(int(s)) for s in status),
    }
    v2_family = solver_name in ('v2', 'approx')
    if v2_family:
        m_its = sol.last_m_iters.cpu().numpy()
        line['m_steps_p50'] = float(np.median(m_its))
        line['m_steps_max'] = int(m_its.max())
    if conv_abs_limit is not None:
        line['conv_abs_limit'] = conv_abs_limit
        line['conv_abs_at_or_above_limit'] = conv >= conv_abs_limit
    emit(line)
    alive = torch.as_tensor((status != DIVERGED) | (not v2_family), device=res.u.device)
    finite = all(bool(torch.isfinite(t[alive]).all()) for t in (res.u, res.l, res.stat,
                                                                res.p_feas, res.comp))
    problems = []
    if not all(v > 0 for v in launches.values()):
        problems.append(f'a kernel was not launched on {phase}: {launches}')
    if (status == RUNNING).any():
        problems.append('games still running')
    if not finite:
        problems.append('non-finite results')
    if conv < conv_min or conv_any < conv_any_min:
        problems.append(f'convergence {conv:.3f}/{conv_any:.3f} below '
                        f'{conv_min}/{conv_any_min}')
    if n_dec is not None and sol.n_dec != n_dec:
        problems.append(f'the path ran at n = {sol.n_dec}, not {n_dec}')
    missing = [(name, n) for name in launches_by_n for n in kernel_ns
               if not launches_by_n[name].get(n)]
    if missing:
        problems.append(f'kernels not launched at these sizes: {missing}')
    if problems:
        raise AssertionError(f'{phase}: ' + '; '.join(problems))
    return line


def phase_mc_study():
    """The Monte-Carlo entry point at a small depth: the agents study with DGSQP v2."""
    import torch
    from dgsqp_torch.harness.mc_study import analyze_results, run_mc_study
    from dgsqp_torch.harness.scenarios import build_agents_scenario
    from dgsqp_torch.solvers.dgsqp import RUNNING
    from dgsqp_torch.solvers.dgsqp_v2 import DGSQPV2
    from dgsqp_torch.solvers.solver_types import DGSQPV2Params
    sc = build_agents_scenario(M=MC_AGENTS, N=MC_HORIZON)
    params = DGSQPV2Params(N=sc.N, dt=sc.dt, qp_tol=3e-7, **MC_PARAMS)
    reset_launches()
    t0 = time.time()
    res = run_mc_study(sc, solver_params=params, num_samples=MC_SAMPLES, seed=0,
                       solver_cls=DGSQPV2, dtype=torch.float32)
    seconds = time.time() - t0
    launches = read_launches()
    stats = analyze_results(res)
    n_dec = int(res.u_sol.shape[1])
    emit({'phase': 'mc_study', 'scenario': sc.name, 'n_dec': n_dec, 'seconds': seconds,
          'launches': launches, 'analyze_results': stats,
          'status_string': ''.join(str(int(s)) for s in res.statuses)})
    problems = []
    if n_dec != 2 * MC_AGENTS * MC_HORIZON:
        problems.append(f'the study ran at n = {n_dec}')
    if not all(v > 0 for v in launches.values()):
        problems.append(f'a kernel was not launched in the study: {launches}')
    if (res.statuses == RUNNING).any():
        problems.append('games still running')
    prov = res.provenance
    if prov['device_name'] != torch.cuda.get_device_name(0) or prov['platform'] != 'cuda':
        problems.append(f'provenance does not name the card: {prov}')
    if problems:
        raise AssertionError('mc_study: ' + '; '.join(problems))
    return launches


def _pcts(t):
    import numpy as np
    v = t.double().cpu().numpy()
    return {'p50': float(np.median(v)), 'p90': float(np.percentile(v, 90))}


def phase_oracle_path():
    """The DGSQP-vs-MCP equilibrium-match study at full width, float64 on the card."""
    import numpy as np
    import torch
    from dgsqp_torch.harness.analysis import gne_compare
    from dgsqp_torch.harness.mc_study import analyze_results, run_mc_study
    from dgsqp_torch.harness.scenarios import build_chicane_scenario
    from dgsqp_torch.solvers.mcp import PATHMCP
    from dgsqp_torch.solvers.solver_types import PATHMCPParams
    sc = build_chicane_scenario(N=25, theta_deg=45.0)
    reset_launches()
    t0 = time.time()
    dg = run_mc_study(sc, num_samples=ORACLE_GAMES, seed=ORACLE_SEED, dtype=torch.float64)
    dg_s = time.time() - t0
    mcp = PATHMCP(sc.joint_model, sc.costs, sc.agent_constraints, sc.shared_constraints,
                  sc.bounds, PATHMCPParams(N=sc.N, dt=sc.dt, tol=1e-3, method='hybrid',
                                           max_iters=200, max_restarts=4),
                  print_method=None, dtype=torch.float64)
    t0 = time.time()
    mc = run_mc_study(sc, num_samples=ORACLE_GAMES, seed=ORACLE_SEED, solver=mcp)
    mc_s = time.time() - t0
    launches, launches_by_n = read_launches(), read_launches_by_n()
    rep = gne_compare(dg, mc, **ORACLE_COMPARE)
    conv_dg = float(rep['converged_a'] / ORACLE_GAMES)
    conv_mc = float(rep['converged_b'] / ORACLE_GAMES)
    emit({'phase': 'oracle_path', 'scenario': sc.name, 'games': ORACLE_GAMES,
          'n_dec': mcp.n_dec, 'n_c': mcp.n_c, 'dtype': 'float64',
          'dgsqp': analyze_results(dg), 'mcp': analyze_results(mc),
          'dgsqp_seconds': dg_s, 'mcp_seconds': mc_s,
          'dgsqp_solve_s': dg.wall_time_s, 'mcp_solve_s': mc.wall_time_s,
          'mcp_iters_p50': float(np.median(mc.iters)), 'mcp_iters_max': int(mc.iters.max()),
          'dgsqp_conv_abs': conv_dg, 'mcp_conv_abs': conv_mc,
          'gne_compare': rep, 'record': ORACLE_RECORD,
          'limits': {'match_rate_of_both': ORACLE_MATCH_MIN,
                     'mcp_conv_abs': ORACLE_MCP_CONV_MIN,
                     'dgsqp_conv_abs': ORACLE_DGSQP_CONV_MIN},
          'launches': launches, 'launches_by_n': launches_by_n,
          'status_string_dgsqp': ''.join(str(int(s)) for s in dg.statuses),
          'status_string_mcp': ''.join(str(int(s)) for s in mc.statuses)})
    problems = []
    if not np.array_equal(dg.x0, mc.x0):
        problems.append('the two studies sampled different games')
    if not all(v > 0 for v in launches.values()):
        problems.append(f'a kernel was not launched on oracle_path: {launches}')
    if (mc.statuses == 0).any() or (dg.statuses == 0).any():
        problems.append('games still running')
    if not np.isfinite(mc.u_sol).all() or not np.isfinite(dg.u_sol).all():
        problems.append('non-finite solutions')
    if rep['match_rate_of_both'] < ORACLE_MATCH_MIN:
        problems.append(f"match rate {rep['match_rate_of_both']:.3f} < {ORACLE_MATCH_MIN}")
    if conv_mc < ORACLE_MCP_CONV_MIN or conv_dg < ORACLE_DGSQP_CONV_MIN:
        problems.append(f'conv_abs MCP {conv_mc:.3f} / DGSQP {conv_dg:.3f} below '
                        f'{ORACLE_MCP_CONV_MIN} / {ORACLE_DGSQP_CONV_MIN}')
    if problems:
        raise AssertionError('oracle_path: ' + '; '.join(problems))
    return sc, dg, launches


def phase_ibr_ws(sc, batch):
    """One batched IBR sweep of the study's warm start on the bench batch (float32)."""
    import torch
    from dgsqp_torch.solvers.ibr import IBR
    from dgsqp_torch.solvers.solver_types import IBRParams
    u0, _, x0, up = batch
    ibr = IBR(sc.joint_model, sc.costs, sc.agent_constraints, sc.shared_constraints,
              sc.bounds, IBRParams(N=sc.N, dt=sc.dt, ibr_iters=1, p_tol=1e-3, d_tol=1e-3),
              print_method=None, dtype=u0.dtype, device=u0.device)
    reset_launches()
    t0 = time.time()
    res = ibr._solve_core(u0, x0, up)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches, launches_by_n = read_launches(), read_launches_by_n()
    kkt = {a: _pcts(k) for a, k in ibr.last_br_kkt.items()}
    its = {a: {'p50': float(it.double().median()), 'max': int(it.max())}
           for a, it in ibr.last_br_iters.items()}
    emit({'phase': 'ibr_ws', 'games': int(u0.shape[0]), 'dtype': str(u0.dtype),
          'n_br': [s1 - s0 for s0, s1 in ibr.ua_slices], 'seconds': seconds,
          'launches': launches, 'launches_by_n': launches_by_n, 'br_kkt': kkt,
          'br_sqp_iters': its, 'delta': _pcts(res.delta),
          'converged': int(res.converged.sum())})
    problems = []
    missing = [(name, n) for name in launches_by_n for n in IBR_KERNEL_NS
               if not launches_by_n[name].get(n)]
    if missing:
        problems.append(f'kernels not launched at these sizes: {missing}')
    if not bool(torch.isfinite(res.u).all()) or not bool(torch.isfinite(res.delta).all()) \
            or not all(bool(torch.isfinite(k).all()) for k in ibr.last_br_kkt.values()):
        problems.append('non-finite results')
    if problems:
        raise AssertionError('ibr_ws: ' + '; '.join(problems))
    return launches


def phase_algames_path(sc, dg):
    """``run_mc_study_algames`` on the first games of the oracle study's draw (the
    sampler draws in rounds sized by the sample count, so the study samples the oracle's
    128 and keeps the first ``ALGAMES_GAMES``), float64, against its DGSQP."""
    import dataclasses
    import numpy as np
    import torch
    from dgsqp_torch.harness import mc_study
    from dgsqp_torch.harness.analysis import gne_compare
    sample = mc_study._sample

    def oracle_head(scenario, num_samples, seed, dtype, device):
        return tuple(a[:num_samples] for a in sample(scenario, ORACLE_GAMES, seed, dtype,
                                                     device))

    mc_study._sample = oracle_head
    t0 = time.time()
    try:
        al = mc_study.run_mc_study_algames(sc, num_samples=ALGAMES_GAMES, seed=ORACLE_SEED,
                                           dtype=torch.float64)
    finally:
        mc_study._sample = sample
    seconds = time.time() - t0
    head = lambda a: a[:ALGAMES_GAMES]
    dg16 = dataclasses.replace(dg, num_samples=ALGAMES_GAMES, statuses=head(dg.statuses),
                               iters=head(dg.iters), qp_solves=head(dg.qp_solves),
                               p_feas=head(dg.p_feas), comp=head(dg.comp),
                               stat=head(dg.stat), u_sol=head(dg.u_sol), x0=head(dg.x0))
    rep = gne_compare(dg16, al, layout_b='stage', **ORACLE_COMPARE)
    emit({'phase': 'algames_path', 'games': ALGAMES_GAMES, 'dtype': 'float64',
          'n_y': sc.N * (sc.joint_model.n_q + sc.joint_model.n_u)
                 + sc.joint_model.n_a * sc.N * sc.joint_model.n_q,
          'seconds': seconds, 'solve_s': al.wall_time_s, 'warmup_s': al.compile_time_s,
          'statuses': ''.join(str(int(s)) for s in al.statuses),
          'outer_iters': al.iters.tolist(), 'newton_solves': al.qp_solves.tolist(),
          'stat': al.stat.tolist(), 'p_feas': al.p_feas.tolist(),
          'gne_compare_vs_dgsqp': rep})
    problems = []
    if not np.array_equal(al.x0, dg16.x0):
        problems.append('ALGAMES sampled other games than the oracle study')
    if not np.isfinite(al.u_sol).all() or not np.isfinite(al.stat).all():
        problems.append('non-finite results')
    if rep['both_converged'] >= ALGAMES_MIN_BOTH and \
            rep['match_rate_of_both'] < ALGAMES_MATCH_MIN:
        problems.append(f"match rate {rep['match_rate_of_both']:.3f} < {ALGAMES_MATCH_MIN}")
    if problems:
        raise AssertionError('algames_path: ' + '; '.join(problems))


def phase_merge_path(device='cuda'):
    """The merge's DGSQP-vs-MCP equilibrium-match study at full width, float64 on the
    card."""
    import numpy as np
    import torch
    from dgsqp_torch.harness.analysis import gne_compare
    from dgsqp_torch.harness.mc_study import analyze_results, run_mc_study
    from dgsqp_torch.harness.scenarios import build_merge_scenario
    from dgsqp_torch.solvers.mcp import PATHMCP
    from dgsqp_torch.solvers.solver_types import PATHMCPParams
    sc = build_merge_scenario(N=MERGE_N)
    reset_launches()
    t0 = time.time()
    dg = run_mc_study(sc, num_samples=MERGE_GAMES, seed=MERGE_SEED, dtype=torch.float64,
                      device=device)
    dg_s = time.time() - t0
    mcp = PATHMCP(sc.joint_model, sc.costs, sc.agent_constraints, sc.shared_constraints,
                  sc.bounds, PATHMCPParams(N=sc.N, dt=sc.dt, tol=1e-3, method='hybrid',
                                           max_iters=200, max_restarts=4),
                  print_method=None, dtype=torch.float64, device=device)
    t0 = time.time()
    mc = run_mc_study(sc, num_samples=MERGE_GAMES, seed=MERGE_SEED, solver=mcp)
    mc_s = time.time() - t0
    launches, launches_by_n = read_launches(), read_launches_by_n()
    rep = gne_compare(dg, mc, **MERGE_COMPARE)
    conv_dg = float(rep['converged_a'] / MERGE_GAMES)
    conv_mc = float(rep['converged_b'] / MERGE_GAMES)
    line = {'phase': 'merge_path', 'scenario': sc.name, 'horizon': sc.N,
            'n_dec': mcp.n_dec, 'n_c': mcp.n_c, 'dtype': 'float64', 'games': MERGE_GAMES,
            'dgsqp': analyze_results(dg), 'mcp': analyze_results(mc),
            'dgsqp_seconds': dg_s, 'mcp_seconds': mc_s,
            'dgsqp_solve_s': dg.wall_time_s, 'mcp_solve_s': mc.wall_time_s,
            'mcp_iters_p50': float(np.median(mc.iters)), 'mcp_iters_max': int(mc.iters.max()),
            'dgsqp_conv_abs': conv_dg, 'mcp_conv_abs': conv_mc,
            'both': rep['both_converged'], 'match': rep['match'],
            'match_rate_of_both': rep['match_rate_of_both'],
            'nmse_median': rep.get('nmse_median'), 'nmse_max': rep.get('nmse_max'),
            'gne_compare': rep, 'record': MERGE_RECORD,
            'record_counts': 'the r3 solver, conv incl. rel',
            'limits': {'match_rate_of_both': MERGE_MATCH_MIN,
                       'dgsqp_conv_abs': MERGE_DGSQP_CONV_MIN,
                       'mcp_conv_abs': MERGE_MCP_CONV_MIN},
            'launches': launches, 'launches_by_n': launches_by_n,
            'status_string_dgsqp': ''.join(str(int(s)) for s in dg.statuses),
            'status_string_mcp': ''.join(str(int(s)) for s in mc.statuses)}
    emit(line)
    problems = []
    if not np.array_equal(dg.x0, mc.x0):
        problems.append('the two studies sampled different games')
    if mcp.n_dec != 3 * 2 * MERGE_N:
        problems.append(f'the study ran at n = {mcp.n_dec}')
    missing = [(name, n) for name in launches_by_n for n in MERGE_KERNEL_NS
               if not launches_by_n[name].get(n)]
    if missing:
        problems.append(f'kernels not launched at these sizes: {missing}')
    if (mc.statuses == 0).any() or (dg.statuses == 0).any():
        problems.append('games still running')
    if not np.isfinite(mc.u_sol).all() or not np.isfinite(dg.u_sol).all():
        problems.append('non-finite solutions')
    if rep['match_rate_of_both'] < MERGE_MATCH_MIN:
        problems.append(f"match rate {rep['match_rate_of_both']:.3f} < {MERGE_MATCH_MIN}")
    if conv_mc < MERGE_MCP_CONV_MIN or conv_dg < MERGE_DGSQP_CONV_MIN:
        problems.append(f'conv_abs MCP {conv_mc:.3f} / DGSQP {conv_dg:.3f} below '
                        f'{MERGE_MCP_CONV_MIN} / {MERGE_DGSQP_CONV_MIN}')
    if problems:
        raise AssertionError('merge_path: ' + '; '.join(problems))
    return launches


MERGE_CHILD = '--merge-path'


def start_merge_path():
    """Start ``merge_path`` in a process of its own, beside the phases that follow: the
    paths are host-bound (one CPU core each, the card idle most of the time), so the
    merge's study runs on another core.  The child counts its own launches."""
    here = Path(__file__).resolve()
    return subprocess.Popen([sys.executable, str(here), MERGE_CHILD], cwd=here.parent,
                            stdout=subprocess.PIPE, text=True)


def finish_merge_path(proc, timeout=900):
    """Wait for the ``merge_path`` process, emit its line here, fail if it failed."""
    out, _ = proc.communicate(timeout=timeout)
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith('{')]
    line = next((ln for ln in lines if ln.get('phase') == 'merge_path'), None)
    if line is not None:
        emit(line)
    if proc.returncode != 0 or line is None:
        raise AssertionError(f'merge_path failed in its process (exit code {proc.returncode})')
    return line['launches']


def ms_and_launches(fn, reps=3):
    """Median wall time (ms) of ``fn`` with a synchronise after each call, and the
    CUDA kernels (and copies) one call issues, counted by ``torch.profiler``."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    fn()
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    launches = sum(1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    return float(np.median(times)) * 1e3, launches


def merge_dp_batch(games, device='cuda'):
    """The merge study's games (seed 0, warm start all zero, least-squares duals) and
    its game problem, in float32 on the card."""
    import torch
    from dgsqp_torch.harness.samplers import sample_merge_initial_conditions
    from dgsqp_torch.harness.scenarios import build_merge_scenario
    from dgsqp_torch.solvers.game_problem import GameProblem
    dtype = torch.float32
    sc = build_merge_scenario(N=MERGE_N)
    problem = GameProblem(sc.joint_model, sc.costs, sc.agent_constraints,
                          sc.shared_constraints, sc.bounds, sc.N, dtype=dtype, device=device)
    x0, u_ws, _, _ = sample_merge_initial_conditions(sc, games, seed=MERGE_SEED, dtype=dtype,
                                                     device=device)
    u0 = problem.stage_to_u(torch.as_tensor(u_ws, dtype=dtype, device=device))
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    up = torch.zeros(games, sc.joint_model.n_u, dtype=dtype, device=device)
    return problem, (u0, problem.dual_warm_start(u0, x0, up), x0, up)


def phase_dp_parity(cases):
    """``evaluate_dp`` against ``evaluate`` (both with the Hessian, float32, on the card,
    the same inputs) on each batch of ``cases``: relative differences of Q, q, G and g,
    the median time of a call and the CUDA launches of one."""
    rows, bad = {}, []
    for name, (problem, (u0, l0, x0, up)) in cases.items():
        ad = problem.evaluate(u0, l0, x0, up)[:4]
        dp = problem.evaluate_dp(u0, l0, x0, up)[:4]
        diffs = {k: rel_err(a.double(), b.double())
                 for k, a, b in zip('Q q G g'.split(), dp, ad)}
        finite = all(bool(t.isfinite().all()) for t in dp)
        ms_ad, n_ad = ms_and_launches(lambda: problem.evaluate(u0, l0, x0, up))
        ms_dp, n_dp = ms_and_launches(lambda: problem.evaluate_dp(u0, l0, x0, up))
        rows[name] = {'games': int(u0.shape[0]), 'n_dec': problem.n_dec,
                      'n_c': problem.n_c_total, 'dtype': str(u0.dtype), 'rel_diff': diffs,
                      'evaluate_ms': ms_ad, 'evaluate_dp_ms': ms_dp,
                      'evaluate_launches': n_ad, 'evaluate_dp_launches': n_dp}
        bad += [f'{name} {k} {v:.2e}' for k, v in diffs.items() if not v <= DP_RTOL]
        if not finite:
            bad.append(f'{name}: non-finite evaluate_dp')
    emit({'phase': 'dp_parity', 'batches': rows, 'tol': DP_RTOL,
          'why': 'both float32 on the card: each carries f32 rounding through the 25-step '
                 'rollout (~1e-6 relative), summed in another order'})
    if bad:
        raise AssertionError(f'dp_parity outside tolerance: {bad}')
    return rows


def kernel_summary(rows, launches_by_path):
    """The per-kernel line: numbers at the main shape (float32), all shapes beside."""
    meta = {
        'chol': dict(source='dgsqp_torch/ops/csrc/chol.cu',
                     replaces='dgsqp_tpu/ops/linalg_pallas.py:123 (chol_batch)',
                     main=(256, 100, 0)),
        'cho_solve': dict(source='dgsqp_torch/ops/csrc/cho_solve.cu',
                          replaces='dgsqp_tpu/ops/linalg_pallas.py:243 (cho_solve_batch)',
                          main=(256, 100, 1)),
    }
    out = []
    for name, m in meta.items():
        main = next(r for r in rows if r['kernel'] == name and r['dtype'] == 'float32'
                    and (r['B'], r['n'], r['k']) == m['main'])
        out.append({'name': name, 'route': 'cuda', 'source': m['source'],
                    'replaces': m['replaces'],
                    'launches': launches_by_path['v2_path'][name],
                    'launches_by_path': {k: v[name] for k, v in launches_by_path.items()},
                    'max_abs_err': main['max_abs_err'], 'ms': main['ms'],
                    'plain_ms': main['plain_ms'], 'bound_ms': main['bound_ms'],
                    'bound_by': main['bound_by'], 'library_ms': main['library_ms'],
                    'main_shape': list(m['main']),
                    'shapes': [r for r in rows if r['kernel'] == name]})
    return {'kernels': out}


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this script needs the card',
              file=sys.stderr)
        sys.exit(2)
    from dgsqp_torch.harness.bench_setup import build_bench_batch, build_bench_solver
    from dgsqp_torch.harness.scenarios import build_chicane_scenario

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    LOG.parent.mkdir(parents=True, exist_ok=True)
    LOG.write_text('')
    t_start = time.time()
    phase_build()
    rows = phase_kernels()

    sc = build_chicane_scenario(N=25, theta_deg=45.0)
    _, sol = build_bench_solver(horizon=25, scenario=sc, dtype=torch.float32, device='cuda')
    _, sol_cpu = build_bench_solver(horizon=25, scenario=sc, dtype=torch.float64,
                                    device='cpu')
    batch = build_bench_batch(sc, sol, 256, seed=0)
    phase_parity(sc, sol, sol_cpu, batch)
    launches = {}
    launches['main_path'] = phase_bench_path('main_path', 'v1', sol, batch, CONV_ABS_MIN,
                                             CONV_ANY_MIN, compact=False)['launches']
    _, sol_v2 = build_bench_solver(horizon=25, solver_name='v2', scenario=sc,
                                   dtype=torch.float32, device='cuda')
    launches['v2_path'] = phase_bench_path('v2_path', 'v2', sol_v2, batch, V2_CONV_ABS_MIN,
                                           V2_CONV_ANY_MIN)['launches']
    launches['mc_study'] = phase_mc_study()

    sc_ap, sol_ap = build_bench_solver(horizon=25, solver_name='approx',
                                       dtype=torch.float32, device='cuda')
    _, sol_ap_cpu = build_bench_solver(horizon=25, solver_name='approx', scenario=sc_ap,
                                       dtype=torch.float64, device='cpu')
    batch_ap = build_bench_batch(sc_ap, sol_ap, 256, seed=0)
    phase_parity(sc_ap, sol_ap, sol_ap_cpu, batch_ap, phase='approx_parity')
    launches['approx_path'] = phase_bench_path(
        'approx_path', 'approx', sol_ap, batch_ap, 0.0, APPROX_CONV_ANY_MIN,
        metric='approx_duel_solves_per_s', n_dec=APPROX_N_DEC,
        conv_abs_limit=APPROX_CONV_ABS_LIMIT, kernel_ns=APPROX_KERNEL_NS)['launches']

    merge = start_merge_path()
    try:
        sc_or, dg, launches['oracle_path'] = phase_oracle_path()
        launches['ibr_ws'] = phase_ibr_ws(sc, batch)
        phase_algames_path(sc_or, dg)
        launches['merge_path'] = finish_merge_path(merge)
    finally:
        if merge.poll() is None:
            merge.kill()
            merge.wait()
    phase_dp_parity({'bench': (sol.problem, tuple(a[:DP_GAMES] for a in batch)),
                     'merge': merge_dp_batch(MERGE_GAMES)})

    emit(kernel_summary(rows, launches))
    emit({'phase': 'total', 'seconds': time.time() - t_start})
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})


def merge_path_process():
    """The body of the ``merge_path`` process: its line goes to stdout (the parent
    emits it into the log) and to a log of its own."""
    import torch
    global LOG
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    LOG = LOG.with_name('chip_smoke_merge.jsonl')
    LOG.parent.mkdir(parents=True, exist_ok=True)
    LOG.write_text('')
    phase_merge_path()


if __name__ == '__main__':
    if sys.argv[1:] == [MERGE_CHILD]:
        merge_path_process()
    else:
        main()
