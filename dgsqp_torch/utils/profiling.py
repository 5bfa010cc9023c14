"""Timing and profiling helpers, ported from ``dgsqp_tpu/utils/profiling.py``.

Named wall-clock spans (``Timers``), a ``torch.profiler`` trace of a region
(``device_trace``, for a device timeline in TensorBoard or Perfetto), and a call timed
to the end of its device work (``block_and_time``).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class Timers:
    """Named wall-clock accumulators: ``with timers.span('qp'): ...``."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {k: dict(total_s=self.totals[k], count=self.counts[k],
                        mean_s=self.totals[k] / max(self.counts[k], 1))
                for k in sorted(self.totals)}


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


def _devices(out, found):
    if isinstance(out, torch.Tensor):
        found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _devices(v, found)
    return found


def block_and_time(fn, *args, **kwargs):
    """Run ``fn``, wait for the device work of the tensors it returns (every CUDA
    device among them is synchronised), and return (result, seconds)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    for dev in _devices(out, set()):
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0
