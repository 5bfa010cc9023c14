#!/usr/bin/env python3
"""Check and time the variants of the port's two CUDA kernels on one NVIDIA GPU.

``cho_solve.cu`` has three constants that were chosen by timing: the largest number of
right-hand sides that it solves on its warp path (``linalg.WARP_PATH_MAX_K``), the
fewest warps of a warp-path block (``linalg.WARP_PATH_LOADERS``) and the tile of its
column path (``linalg.COLUMN_TILE``).  This script builds the kernels, holds every
variant against the plain version, and times each at the main path's sizes (batch 256,
n = 100 and 64) and at one odd size, L2 warm: device time per launch from a replayed
CUDA graph of 20 launches, and ``eager_ms``, the time per call of a loop of eager calls,
which is the host's cost of issuing a launch whenever it exceeds the device time.  With
``--parent DIR``, where DIR holds an unpacked earlier tree of the repository, it also
times that tree's kernels on the same inputs in the same process, in turns (parent,
this, this, parent).

Usage (from the repository root, on the machine with the card):

    python3 scripts/torch_tune_kernels.py [--check-only] [--parent DIR] [--out PATH]

Prints one JSON object; with ``--out PATH`` also writes it there.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

RTOL = {'float32': 1e-4, 'float64': 1e-10}


def load_parent(path):
    spec = importlib.util.spec_from_file_location(
        'parent_linalg', os.path.join(path, 'dgsqp_torch', 'ops', 'linalg.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--check-only', action='store_true')
    ap.add_argument('--parent', default=None)
    ap.add_argument('--out', default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit('torch_tune_kernels: needs an NVIDIA GPU')
    from chip_smoke import graph_ms, rel_err, spd_batch, time_ms
    from dgsqp_torch.ops import linalg

    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    reports = linalg.build_kernels()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if 'registers' in ln or 'spill' in ln or 'Compiling' in ln]
             for name, log in reports.items()}
    result = {'card': card, 'ptxas': ptxas, 'checks': [], 'chol': [], 'cho_solve': []}
    gen = torch.Generator(device='cuda').manual_seed(0)
    defaults = (linalg.WARP_PATH_MAX_K, linalg.COLUMN_TILE, linalg.WARP_PATH_LOADERS)

    def set_variant(path=None, tile=None, loaders=None):
        linalg.WARP_PATH_MAX_K, linalg.COLUMN_TILE, linalg.WARP_PATH_LOADERS = defaults
        if loaders is not None:
            linalg.WARP_PATH_LOADERS = loaders
        if path is not None:
            linalg.WARP_PATH_MAX_K = 1 << 30 if path == 'warp' else 0
        if tile is not None:
            linalg.COLUMN_TILE = tile

    # ---------------------------------------------------------------- checks
    bad = []
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split('.')[-1]
        for B, n in ((256, 100), (256, 64), (5, 37), (16, 150), (3, 8), (2, 1), (4, 33)):
            A = spd_batch(B, n, dtype, 'cuda', gen)
            ref = linalg.cholesky_plain(A)
            out = linalg.cholesky(A)
            torch.cuda.synchronize()
            err = rel_err(out.double(), ref.double())
            upper = bool((torch.triu(out, 1) != 0).any())
            row = dict(kernel='chol', dtype=dname, B=B, n=n, rel_err=err, upper_nonzero=upper)
            result['checks'].append(row)
            if not err <= RTOL[dname] or upper:
                bad.append(row)
            for k in (1, 3, 8, 33, 64):
                b = torch.randn(B, n, k, generator=gen, device='cuda', dtype=dtype)
                b = b[..., 0].contiguous() if k == 1 else b
                xref = linalg.cho_solve_plain(ref, b)
                for path, tile, loaders in (('warp', None, 1), ('warp', None, 4),
                                            ('column', 32, None), ('column', 64, None)):
                    set_variant(path=path, tile=tile, loaders=loaders)
                    plan = linalg.cho_solve_plan(n, k, A.element_size())
                    if plan[2] > linalg.SMEM_OPTIN_BYTES:
                        continue
                    out = linalg.cho_solve(ref, b)
                    torch.cuda.synchronize()
                    err = rel_err(out.double(), xref.double())
                    row = dict(kernel='cho_solve', dtype=dname, B=B, n=n, k=k, plan=plan,
                               rel_err=err)
                    result['checks'].append(row)
                    if not err <= RTOL[dname]:
                        bad.append(row)
    result['failed_checks'] = bad

    # ---------------------------------------------------------------- timings
    if not args.check_only and not bad:
        parent = load_parent(args.parent) if args.parent else None
        if parent:
            parent.build_kernels()
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).split('.')[-1]
            for B, n, ks in ((256, 100, (1, 2, 4, 8, 16, 32, 33, 64)), (256, 64, (1,)),
                             (5, 37, (3,))):
                A = spd_batch(B, n, dtype, 'cuda', gen)
                L = linalg.cholesky_plain(A)
                row = dict(dtype=dname, B=B, n=n)
                if parent:
                    row['parent_ms'] = [graph_ms(lambda: parent.cholesky(A))]
                row['ms'] = [graph_ms(lambda: linalg.cholesky(A)) for _ in range(2)]
                if parent:
                    row['parent_ms'].append(graph_ms(lambda: parent.cholesky(A)))
                set_variant()
                row['eager_ms'] = time_ms(lambda: linalg.cholesky(A), 200)
                if parent:
                    row['parent_eager_ms'] = time_ms(lambda: parent.cholesky(A), 200)
                row['library_ms'] = time_ms(lambda: torch.linalg.cholesky(A), 50)
                result['chol'].append(row)
                for k in ks:
                    b = torch.randn(B, n, k, generator=gen, device='cuda', dtype=dtype)
                    b = b[..., 0].contiguous() if k == 1 else b
                    b3 = b[..., None] if k == 1 else b
                    row = dict(dtype=dname, B=B, n=n, k=k)
                    if parent:
                        row['parent_ms'] = [graph_ms(lambda: parent.cho_solve(L, b))]
                    variants = [('warp', None), ('column', 32), ('column', 64)]
                    for path, tile in variants + variants[::-1]:
                        set_variant(path=path, tile=tile)
                        if linalg.cho_solve_plan(n, k, A.element_size())[1] != (tile or min(k, 8)):
                            continue
                        row.setdefault(f'{path}{tile or ""}_ms', []).append(
                            graph_ms(lambda: linalg.cho_solve(L, b)))
                    for loaders in (1, 2, 4, 8) if k <= 4 else ():
                        set_variant(path='warp', loaders=loaders)
                        row[f'warp_loaders{loaders}_ms'] = graph_ms(lambda: linalg.cho_solve(L, b))
                    if parent:
                        row['parent_ms'].append(
                            graph_ms(lambda: parent.cho_solve(L, b)))
                    set_variant()
                    row['eager_ms'] = time_ms(lambda: linalg.cho_solve(L, b), 200)
                    if parent:
                        row['parent_eager_ms'] = time_ms(lambda: parent.cho_solve(L, b), 200)
                    row['library_ms'] = time_ms(lambda: torch.cholesky_solve(b3, L), 50)
                    result['cho_solve'].append(row)
        set_variant()

    line = json.dumps(result)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
        with open(args.out, 'w') as f:
            f.write(line + '\n')
    if bad:
        sys.exit(1)


if __name__ == '__main__':
    main()
