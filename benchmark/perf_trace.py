"""Reduction of one ``torch.profiler`` trace of the card's activity to what the
per-layer metrics read: the device's activity intervals and their union, device time by
kernel name, and the idle gaps labelled by the harness's host spans (``bench.*``) that
were open while the device waited.

Device activity is every kernel, memory copy and memory set that ran on the card;
overlapping intervals are merged before they are summed, so that concurrent work is
counted once.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

DEVICE_KINDS = {'kernel', 'gpu_memcpy', 'gpu_memset', 'concurrent_kernel'}


def _kind(e) -> str:
    at = getattr(e, 'activity_type', None)
    if at is None:
        return ''
    at = at() if callable(at) else at
    return str(at).split('.')[-1].lower()


def _ns(e):
    if hasattr(e, 'start_ns'):
        return int(e.start_ns()), int(e.duration_ns())
    return int(e.start_us() * 1000), int(e.duration_us() * 1000)


def merge_intervals(starts, ends):
    """Union of [start, end) intervals: (merged starts, merged ends), sorted."""
    starts = np.asarray(starts, dtype=np.int64)
    ends = np.asarray(ends, dtype=np.int64)
    if starts.size == 0:
        return starts, ends
    order = np.argsort(starts, kind='stable')
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(s.size, dtype=bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.append(run_end[idx[1:] - 1], run_end[-1])


def busy_ns(starts, ends, lo=None, hi=None) -> int:
    """Length of the union of the intervals, clipped to [lo, hi] where given."""
    s, e = merge_intervals(starts, ends)
    if lo is not None:
        s, e = np.maximum(s, lo), np.maximum(e, lo)
    if hi is not None:
        s, e = np.minimum(s, hi), np.minimum(e, hi)
    return int(np.sum(e - s))


def summarize(events, spans, window: str = 'bench.request'):
    """Everything the readers need from a kineto event list and the harness's host
    spans ``(start_ns, end_ns, name)`` on the same clock.

    Returns a dict: ``window_ns`` (the traced request's span), ``busy_ns`` (union of
    device activity inside it), ``device_events`` (count inside it), ``kernel_ns``
    (device time by name), ``kernel_seq`` (name and duration of every device event in
    start order), ``idle_by_host`` (idle device time inside the request by the
    innermost host span it fell in) and ``kinds`` (event counts by activity type)."""
    dev_s, dev_e, dev_n = [], [], []
    kinds = defaultdict(int)
    for e in events:
        kind = _kind(e)
        kinds[kind] += 1
        name = e.name()
        if 'cuda' not in str(e.device_type()).lower():
            continue
        if kind in DEVICE_KINDS or (not kind and not name.startswith('bench.')):
            start, dur = _ns(e)
            dev_s.append(start)
            dev_e.append(start + dur)
            dev_n.append(name)
    req = [sp for sp in spans if sp[2] == window]
    if not req:
        raise RuntimeError('trace: the request span is missing')
    lo, hi = req[0][0], req[0][1]
    dev_s, dev_e = np.asarray(dev_s, np.int64), np.asarray(dev_e, np.int64)
    inside = (dev_e > lo) & (dev_s < hi)
    order = np.argsort(dev_s, kind='stable')
    kernel_ns = defaultdict(int)
    for n, s, e in zip(dev_n, dev_s, dev_e):
        kernel_ns[n] += int(e - s)
    ms, me = merge_intervals(dev_s[inside], dev_e[inside])
    return dict(window_ns=int(hi - lo), busy_ns=busy_ns(ms, me, lo, hi),
                device_events=int(inside.sum()), kernel_ns=dict(kernel_ns),
                kernel_seq=[(dev_n[i], int(dev_e[i] - dev_s[i])) for i in order],
                idle_by_host=idle_by_span(ms, me, lo, hi, [sp for sp in spans if sp[2] != window]),
                kinds=dict(kinds))


def idle_by_span(ms, me, lo, hi, spans):
    """Idle device time inside [lo, hi] (the gaps between the merged intervals
    ``ms``/``me``), summed by the innermost host span covering each gap's middle
    ('rest' where none does)."""
    gs = np.concatenate([[lo], me])
    ge = np.concatenate([ms, [hi]])
    gs, ge = np.maximum(gs, lo), np.minimum(ge, hi)
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    mid = (gs + ge) // 2
    labels = np.full(mid.size, 'rest', dtype=object)
    best = np.full(mid.size, np.iinfo(np.int64).max, dtype=np.int64)
    for s, e, n in spans:
        i0, i1 = np.searchsorted(mid, s), np.searchsorted(mid, e)
        if i1 > i0:
            sl = slice(i0, i1)
            shorter = (e - s) < best[sl]
            best[sl] = np.where(shorter, e - s, best[sl])
            labels[sl] = np.where(shorter, n.split('.', 1)[-1], labels[sl])
    acc = defaultdict(int)
    for lab, d in zip(labels, ge - gs):
        acc[lab] += int(d)
    return dict(acc)


def top(d: dict, n: int = 10):
    """The n largest entries of {name: ns} as [[name, seconds], ...]."""
    return [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
