"""Kernels: ``chol``'s share (%) of its roofline over the traced request (the summed
least time of each launch's shape over the summed device time of its launches)."""
import perf_roofline


def read(ctx):
    return perf_roofline.roofline_pct('chol', ctx['shapes']['chol'], ctx['trace']['kernel_seq'])
