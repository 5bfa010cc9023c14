#!/usr/bin/env python3
"""Which alternative configurations rescue the games the standard configuration fails,
the counterpart of ``scripts/retry_probe.py`` on the port.

Solves the bench chicane batch (seed 0, the PID warm start, zero previous inputs) under
the reference configuration (DGSQP v1, watchdog line search, reg 1e-3), collects the
games that do not end conv_abs, pads them to a power of two and re-solves just those
under four variants: v1 with reg 1e-2 and 1e-1, v1 with the ``'stat'`` merit function,
and DGSQP v2 with NMS and the ``'max'`` merit decrease.  What it finds informs the retry
cascade (``solve_with_retries``).

Usage (from the repository root; on the card by default):

    python3 scripts/torch_retry_probe.py [--batch 256] [--horizon 25] [--out FILE]
    python3 scripts/torch_retry_probe.py --device cpu --dtype float64 --batch 8 --horizon 5

Prints a ``#`` line per configuration (as the JAX script does) and one JSON object
last; with ``--out`` also writes the object there.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_solvers(sc, dtype, device):
    """The reference configuration and the four variants, by name."""
    import torch
    from dgsqp_torch.solvers.dgsqp import DGSQP
    from dgsqp_torch.solvers.dgsqp_v2 import DGSQPV2
    from dgsqp_torch.solvers.solver_types import DGSQPParams, DGSQPV2Params
    qp_tol = 1e-8 if dtype == torch.float64 else 3e-7
    base_kw = dict(N=sc.N, dt=sc.dt, nonmono_ls=True, line_search_iters=20,
                   sqp_iters=50, p_tol=1e-3, d_tol=1e-3, beta=0.01, tau=0.5,
                   qp_tol=qp_tol, qp_max_iters=25, qp_solves_limit=100)
    game = (sc.joint_model, sc.costs, sc.agent_constraints, sc.shared_constraints,
            sc.bounds)
    kw = dict(print_method=None, dtype=dtype, device=device)

    def v1(**params):
        return DGSQP(*game, DGSQPParams(**base_kw, **params), **kw)

    base = v1(reg=1e-3)
    variants = {
        'v1 reg=1e-2': v1(reg=1e-2),
        'v1 reg=1e-1': v1(reg=1e-1),
        'v1 merit=stat': v1(reg=1e-3, merit_function='stat'),
        'v2 max': DGSQPV2(*game, DGSQPV2Params(N=sc.N, dt=sc.dt, reg=1e2, reg_decay=0.95,
                                                nms=True, nms_frequency=5,
                                                nms_memory_size=3, sqp_iters=100,
                                                p_tol=1e-3, d_tol=1e-3,
                                                merit_decrease=0.01,
                                                merit_decrease_condition='max',
                                                qp_tol=qp_tol), **kw),
    }
    return base, variants


def probe_variants(variants, batch, fail):
    """Re-solve the games ``fail`` of ``batch`` (padded to a power of two) under each
    variant; returns, a variant, the games it rescued (conv_abs) and its seconds."""
    import numpy as np
    import torch
    from dgsqp_torch.solvers.dgsqp import CONV_ABS
    n_pad = 1 << (int(fail.size) - 1).bit_length()
    pad = torch.as_tensor(np.concatenate([fail, np.repeat(fail[:1], n_pad - fail.size)]),
                          device=batch[0].device)
    sub = tuple(a[pad] for a in batch)
    out = {}
    for name, solver in variants.items():
        t0 = time.time()
        stf = solver.solve_batch_chunked(*sub).status.cpu().numpy()[:fail.size]
        dt_s = time.time() - t0
        rescued = int(np.sum(stf == CONV_ABS))
        print(f'# {name:24s} rescued {rescued}/{fail.size} ({dt_s:.1f}s)', flush=True)
        out[name] = dict(rescued=rescued, of=int(fail.size), seconds=dt_s,
                         rescued_games=fail[stf == CONV_ABS].tolist())
    return out


def run_probe(batch: int = 256, horizon: int = 25, device='cuda', dtype='float32'):
    """The probe; returns its summary (a dict)."""
    import numpy as np
    import torch
    from dgsqp_torch.harness.samplers import sample_duel_initial_conditions
    from dgsqp_torch.harness.scenarios import build_chicane_scenario
    from dgsqp_torch.solvers.dgsqp import CONV_ABS
    dtype = getattr(torch, dtype)
    sc = build_chicane_scenario(N=horizon, theta_deg=45.0)
    base, variants = build_solvers(sc, dtype, device)

    x0, u_ws, _, _ = sample_duel_initial_conditions(sc, batch, seed=0, dtype=dtype,
                                                    device=device)
    u0 = base.problem.stage_to_u(torch.as_tensor(u_ws, dtype=dtype, device=device))
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    up = torch.zeros(batch, sc.joint_model.n_u, dtype=dtype, device=device)
    l0 = base.problem.dual_warm_start(u0, x0, up)

    t0 = time.time()
    st = base.solve_batch_chunked(u0, l0, x0, up).status.cpu().numpy()
    fail = np.where(st != CONV_ABS)[0]
    out = dict(batch=batch, horizon=horizon, device=str(base.device), dtype=str(dtype),
               base=dict(conv_abs=float(np.mean(st == CONV_ABS)), failures=int(fail.size),
                         seconds=time.time() - t0,
                         status_string=''.join(str(int(s)) for s in st)),
               variants={})
    print(f'# base: conv_abs {np.mean(st == CONV_ABS) * 100:.1f}% | {fail.size} failures',
          flush=True)
    if fail.size == 0:
        return out

    out['variants'] = probe_variants(variants, (u0, l0, x0, up), fail)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--batch', type=int, default=256)
    ap.add_argument('--horizon', type=int, default=25)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--dtype', default='float32', choices=['float32', 'float64'])
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    import torch
    if torch.device(args.device).type == 'cuda':
        if not torch.cuda.is_available():
            sys.exit('torch_retry_probe: no card; pass --device cpu for the CPU')
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    out = run_probe(args.batch, args.horizon, args.device, args.dtype)
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
        with open(args.out, 'w') as f:
            f.write(line + '\n')
    print(line)


if __name__ == '__main__':
    main()
