"""The least time each launch of the program's two linear-algebra kernels needs on an
NVIDIA H100 SXM, against the data sheet's peaks at its 700 W limit, and the share of
that bound which the measured device time reaches.

Both kernels need only the lower triangle of their matrix input.  ``chol`` writes all of
L (its upper triangle as zeros) and does n^3/3 operations; ``cho_solve`` reads k
right-hand sides and writes k solutions and does 2 n^2 k operations (a forward and a
backward substitution).  A launch's bound is the larger of its bytes over the memory
bandwidth and its operations over the arithmetic peak outside the tensor cores.
"""
from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {'float32': 67e12, 'float64': 34e12}

# the kernels' names in a device trace (``dgsqp_torch/ops/csrc``)
KERNEL_NAMES = {'chol': ('chol_kernel',),
                'cho_solve': ('cho_solve_warp_kernel', 'cho_solve_col_kernel')}


def bound_s(kind: str, B: int, n: int, k: int, dtype: str) -> float:
    """Least seconds for one launch on B matrices of size n (k right-hand sides)."""
    it = 4 if dtype == 'float32' else 8
    tri = n * (n + 1) // 2
    if kind == 'chol':
        nbytes = B * (tri + n * n) * it
        flops = B * n ** 3 / 3
    else:
        nbytes = B * (tri + 2 * n * k) * it
        flops = 2 * B * n * n * k
    return max(nbytes / PEAK_BYTES_S, flops / PEAK_FLOP_S[dtype])


def kernel_of(name: str):
    """'chol', 'cho_solve' or None for a device event's name."""
    for kind, names in KERNEL_NAMES.items():
        if any(n in name for n in names):
            return kind
    return None


def roofline_pct(kind: str, shapes, kernel_seq):
    """Share (%) of the summed per-launch bounds in the summed device time of ``kind``'s
    launches.  ``shapes``: (B, n, k, dtype) of every launch in launch order, as the
    harness recorded them; ``kernel_seq``: (name, ns) of every device event in start
    order.  None where the launches seen in the trace are not as many as recorded, or
    there are none: the shapes could then not be paired with the times."""
    times = [ns for name, ns in kernel_seq if kernel_of(name) == kind]
    if not times or len(times) != len(shapes):
        return None
    bound = sum(bound_s(kind, *s) for s in shapes)
    return 100.0 * bound / (sum(times) * 1e-9)
