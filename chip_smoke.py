#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``dgsqp_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with the card:

    python3 chip_smoke.py

Phases, each printing one line on stdout:

1. ``build``: compiles the CUDA kernels from ``dgsqp_torch/ops/csrc`` with ``nvcc`` and
   prints the card's name and power limit (``nvidia-smi``).
2. ``kernels``: holds each kernel against its plain PyTorch version on the card, in
   float32 and float64, at every shape of the main path plus one odd size, and times
   the kernel, the plain version and the library call that computes the same function.
3. ``parity``: one round of ``evaluate`` + convexified QP on 16 games of the seed-0
   bench batch, the port on the card in float32 against the port on the CPU in float64.
4. ``main_path``: the bench problem (two-agent chicane duel, N=25, theta=45 deg, batch
   256, seed 0, float32, DGSQP v1) solved with ``solve_batch_chunked(chunk_iters=4,
   compact=False)``, once to warm up and once timed, with the kernels' launch counts.

Then one JSON line of per-kernel numbers, and last ``{"ok": true, "device": ...}``.
Any failed check raises and the script exits non-zero; without a card it exits
non-zero before printing any result.
"""
import json
import subprocess
import sys
import time

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


def emit(obj):
    print(json.dumps(obj), flush=True)


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


def phase_kernels(device='cuda', shapes=None, time_it=True):
    """Kernel against plain version at the main-path shapes; returns per-shape rows."""
    import torch
    from dgsqp_torch.ops import linalg
    gen = torch.Generator(device=device).manual_seed(0)
    shapes = shapes or {'chol': [(256, 100, 0), (256, 64, 0), (5, 37, 0)],
                        'cho_solve': [(256, 100, 1), (256, 100, 64), (256, 64, 1), (5, 37, 3)]}
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
                if time_it:
                    row['ms'] = time_ms(kern, 50)
                    row['plain_ms'] = time_ms(plain, 3)
                    row['library_ms'] = time_ms(lib, 20)
                    row['bound_ms'], row['bound_by'] = bound(kind, B, n, k, dname)
                rows.append(row)
    emit({'phase': 'kernels', 'kernels': ['chol', 'cho_solve'],
          'launches_in_this_phase': {'chol': linalg.cholesky.launches,
                                     'cho_solve': linalg.cho_solve.launches},
          'shapes': rows})
    return rows


def phase_parity(sc, sol_dev, sol_cpu, batch, n_games=16):
    """One evaluate + convexified QP: the port on the card (f32) against the port on the
    CPU (f64) on the same inputs."""
    import torch
    u0, l0, x0, up = (a[:n_games] for a in batch)
    out_d = sol_dev.problem.evaluate(u0, l0, x0, up)
    du_d = sol_dev._qp(*out_d[:4])[0]
    args_c = [a.detach().to('cpu', torch.float64) for a in (u0, l0, x0, up)]
    out_c = sol_cpu.problem.evaluate(*args_c)
    du_c = sol_cpu._qp(*out_c[:4])[0]
    diffs = {name: rel_err(a.to('cpu', torch.float64), b)
             for name, a, b in zip('Q q G g'.split(), out_d[:4], out_c[:4])}
    diffs['du'] = rel_err(du_d.to('cpu', torch.float64), du_c)
    line = {'phase': 'parity', 'games': n_games, 'rel_diff': diffs,
            'tol': {'derivatives': DERIV_RTOL, 'du': STEP_RTOL},
            'why': 'f32 on the card vs f64 on the CPU: derivatives carry f32 rounding '
                   'through the rollout; the QP step is solved to 3e-7 after Ruiz scaling'}
    emit(line)
    bad = [k for k, v in diffs.items()
           if not v <= (STEP_RTOL if k == 'du' else DERIV_RTOL)]
    if bad:
        raise AssertionError(f'parity outside tolerance: {bad}')
    return diffs


def phase_main_path(sol, batch, chunk=4):
    import numpy as np
    import torch
    from dgsqp_torch.ops import linalg
    from dgsqp_torch.solvers.dgsqp import CONV_ABS, CONV_REL, RUNNING, STATUS_MSG
    u0, l0, x0, up = batch
    B = u0.shape[0]
    sync = torch.cuda.synchronize if u0.is_cuda else (lambda: None)

    t0 = time.time()
    sol.solve_batch_chunked(u0, l0, x0, up, chunk_iters=chunk, compact=False)
    sync()
    first_s = time.time() - t0

    linalg.cholesky.launches = 0
    linalg.cho_solve.launches = 0
    t0 = time.time()
    res = sol.solve_batch_chunked(u0, l0, x0, up, chunk_iters=chunk, compact=False)
    sync()
    dur = time.time() - t0
    launches = {'chol': linalg.cholesky.launches, 'cho_solve': linalg.cho_solve.launches}

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
        'phase': 'main_path',
        'metric': 'chicane_2agent_solves_per_s',
        'value': B / dur,
        'unit': 'solves/s',
        'solve_s': dur,
        'first_solve_s': first_s,
        'convergence_rate': conv,
        'convergence_rate_incl_rel': conv_any,
        'convergence_rate_ref_abs': conv_ref_abs,
        'p_tol': p.p_tol, 'd_tol': p.d_tol,
        'status_counts': hist,
        'iters_p50': float(np.median(iters)), 'iters_max': int(iters.max()),
        'stat_p50': float(np.median(stat_f)), 'stat_p90': float(np.percentile(stat_f, 90)),
        'batch': int(B), 'horizon': sol.N, 'solver': 'v1', 'dtype': str(sol.dtype),
        'chunks': len(chunks), 'running_after_chunk': [c['running'] for c in chunks],
        'chunk_wall_s': [c['wall_s'] for c in chunks],
        'launches': launches,
    }
    emit(line)
    finite = all(bool(torch.isfinite(t).all()) for t in (res.u, res.l, res.stat,
                                                         res.p_feas, res.comp))
    problems = []
    if not all(v > 0 for v in launches.values()):
        problems.append(f'a kernel was not launched on the main path: {launches}')
    if (status == RUNNING).any():
        problems.append('games still running')
    if not finite:
        problems.append('non-finite results')
    if conv < CONV_ABS_MIN or conv_any < CONV_ANY_MIN:
        problems.append(f'convergence {conv:.3f}/{conv_any:.3f} below '
                        f'{CONV_ABS_MIN}/{CONV_ANY_MIN}')
    if problems:
        raise AssertionError('; '.join(problems))
    return line


def kernel_summary(rows, launches):
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
                    'replaces': m['replaces'], 'launches': launches[name],
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
    phase_build()
    rows = phase_kernels()

    sc = build_chicane_scenario(N=25, theta_deg=45.0)
    _, sol = build_bench_solver(horizon=25, scenario=sc, dtype=torch.float32, device='cuda')
    _, sol_cpu = build_bench_solver(horizon=25, scenario=sc, dtype=torch.float64,
                                    device='cpu')
    batch = build_bench_batch(sc, sol, 256, seed=0)
    phase_parity(sc, sol, sol_cpu, batch)
    line = phase_main_path(sol, batch)

    emit(kernel_summary(rows, line['launches']))
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})


if __name__ == '__main__':
    main()
