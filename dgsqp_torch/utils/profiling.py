"""The port's tracer, and a ``torch.profiler`` export of a region; ported from
``dgsqp_tpu/utils/profiling.py``.

``Timers`` records spans (id, the id of the span open when it started, request id, name,
start and end in nanoseconds since the epoch, ``time.time_ns()``: the clock of
``torch.profiler``'s trace, so that a device event falls inside the host span that was
open when it ran) and counters added on the host, kept by request.  ``TRACER`` is the
process's one recorder.  The solvers reach it through this module's functions (``span``,
``traced``, ``count``, ``count_true``, ``sync``, ``read_bool``, ``read_numpy``), which
test one flag and do nothing else while tracing is off, the default: no clock read, no
allocation, no device work, no read.  ``enable()``/``disable()`` or ``with tracing():``
switch it, ``snapshot()`` hands out what it recorded and ``reset()`` clears it.  A read
is timed where the program makes it; tracing adds no device work and no read of its own
but ``count_true``'s, a sum and its read taken for the tracer alone while it is on.

The spans (a dotted name lies inside the span named before its dot):

* ``solve``: one ``solve_batch_chunked`` call of DGSQP v1 or v2; it opens a new request.
* ``chunk``: one trip of the chunk driver (the chunk's rounds, its status read and any
  compaction); ``chunk.compact``: the compaction.
* ``round``: one round of v1's flat machine, of v1's nested machine or of v2.
* ``evaluate``: ``GameProblem.evaluate`` or ``evaluate_dp``.
* ``qp``: the solver's ``_qp``; ``qp.convexify``, ``qp.ipm`` (the interior-point loop) and
  ``qp.polish`` (the active-set polish) inside it.
* ``merit``: the grid line search.
* ``trial``: v2's full-step trial of the games that take an m-step, from the read that
  selects them to their merit at the full step.
* ``sync``: a device-to-host read (the host waits for the device there).

The counters: ``rounds``, ``qp_calls``, ``ipm_iters`` (trips of the interior-point loop,
each advancing every active game), ``host_syncs`` and ``host_syncs.<site>``,
``evaluates`` and ``evaluates.<ad|dp>.<hessian|first>``, ``chunks`` and ``compactions``;
v2's ``trials`` (trials that evaluated at least one game) and ``trial_games`` (games in
them); v1's and v2's ``merit_games`` (games the line search's grid decides for, read at
the site ``merit.games`` while tracing is on) and ``merit_points`` (the trial points the
grid evaluates: the batch's width times ``line_search_iters``); a CUDA-graph cache's
``<counter>.eager``, ``.capture``, ``.replay``, ``.signatures`` and ``.captured_bytes``
(``utils/cuda_graphs.py``; ``evaluate``'s counter is ``evaluates.graph``, the grid's
``merits.graph``).
"""
from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

SPAN_FIELDS = ('id', 'parent', 'request', 'name', 'start_ns', 'end_ns')


class _Span:
    __slots__ = ('rec', 'name', 'new_request', 'id', 'parent', 'request', 'outer', 't0')

    def __init__(self, rec: 'Timers', name: str, new_request: bool):
        self.rec, self.name, self.new_request = rec, name, new_request

    def __enter__(self):
        rec = self.rec
        rec._last_id += 1
        self.id, self.parent, self.outer = rec._last_id, rec._open, rec.request
        if self.new_request:
            rec._last_request += 1
            rec.request = rec._last_request
        self.request = rec.request
        rec._open = self.id
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        rec = self.rec
        rec._open, rec.request = self.parent, self.outer
        rec.spans.append((self.id, self.parent, self.request, self.name, self.t0, t1))
        return False


class Timers:
    """Spans and counters: ``with timers.span('qp'): ...``, ``timers.count('rounds')``.
    Spans opened with ``new_request=True`` start a request: they and everything inside
    them carry its id, and the counters added meanwhile are kept under it (request 0
    outside any)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.spans = []         # finished spans, tuples in SPAN_FIELDS' order
        self.counters: Dict[int, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
        self.request = 0
        self._open = 0          # id of the innermost open span (0: none)
        self._last_id = 0
        self._last_request = 0

    def span(self, name: str, new_request: bool = False) -> _Span:
        return _Span(self, name, new_request)

    def count(self, name: str, k: int = 1):
        self.counters[self.request][name] += k

    def summary(self) -> Dict[str, dict]:
        """Total, count and mean seconds of the finished spans, by name."""
        totals, counts = defaultdict(int), defaultdict(int)
        for s in self.spans:
            totals[s[3]] += s[5] - s[4]
            counts[s[3]] += 1
        return {k: dict(total_s=totals[k] / 1e9, count=counts[k],
                        mean_s=totals[k] / 1e9 / counts[k]) for k in sorted(totals)}

    def snapshot(self) -> dict:
        """``spans``: a dict a finished span, in the order they started; ``counters``:
        {request id: {name: total}}."""
        return dict(spans=[dict(zip(SPAN_FIELDS, s)) for s in sorted(self.spans)],
                    counters={r: dict(c) for r, c in self.counters.items()})


TRACER = Timers()
_NO_SPAN = contextlib.nullcontext()
_on = False


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


@contextlib.contextmanager
def tracing():
    """Tracing on inside the block (and left on after it if it was on before)."""
    was = _on
    enable()
    try:
        yield TRACER
    finally:
        if not was:
            disable()


def snapshot() -> dict:
    return TRACER.snapshot()


def reset():
    TRACER.reset()


def span(name: str, counter: Optional[str] = None, new_request: bool = False):
    """A span of ``TRACER`` (adding 1 to ``counter``) while tracing is on, else one
    shared no-op context."""
    if not _on:
        return _NO_SPAN
    if counter:
        TRACER.count(counter)
    return TRACER.span(name, new_request)


def count(name: str, k: int = 1):
    if _on:
        TRACER.count(name, k)


def traced(name: str, counter: Optional[str] = None, new_request: bool = False):
    """Decorator: each call is a span ``name`` (and adds 1 to ``counter``) while tracing
    is on."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with span(name, counter, new_request):
                return fn(*args, **kwargs)
        return call
    return wrap


def sync(site: str):
    """The context of a device-to-host read at ``site``: a ``sync`` span, counted in
    ``host_syncs`` and ``host_syncs.<site>``, while tracing is on."""
    if not _on:
        return _NO_SPAN
    TRACER.count('host_syncs.' + site)
    return span('sync', 'host_syncs')


def count_true(name: str, mask: torch.Tensor, site: str):
    """Add the number of true entries of ``mask`` to ``name`` while tracing is on, by a
    read at ``site`` taken for that count alone; nothing, and no read, while off."""
    if _on:
        with sync(site):
            TRACER.count(name, int(mask.sum()))


def read_bool(t: torch.Tensor, site: str) -> bool:
    if not _on:
        return bool(t)
    with sync(site):
        return bool(t)


def read_numpy(t: torch.Tensor, site: str):
    if not _on:
        return t.cpu().numpy()
    with sync(site):
        return t.cpu().numpy()


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Trace a region with ``torch.profiler`` (the CPU, and the card when there is
    one) into ``log_dir`` as a TensorBoard trace; a no-op when ``log_dir`` is None.
    Yields the profiler (None when off)."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) \
            as prof:
        yield prof
