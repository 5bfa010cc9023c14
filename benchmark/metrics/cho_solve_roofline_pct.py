"""Kernels: ``cho_solve``'s share (%) of its roofline over the traced request, warp and
column paths together (each launch's bound from its own shape)."""
import perf_roofline


def read(ctx):
    return perf_roofline.roofline_pct('cho_solve', ctx['shapes']['cho_solve'],
                                      ctx['trace']['kernel_seq'])
