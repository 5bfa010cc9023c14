"""CUDA graphs of a function of tensors, one per input signature.

A ``GraphCache`` stands between callers and a function ``fn(*args, *flags)`` whose
``args`` are a pytree of tensors and ``None`` and whose ``flags`` are a few plain values.
On the card, the first call at an input signature (:func:`signature`) runs ``fn``
eagerly: that call is the warm-up a capture needs (library handles, ``torch.func``'s
caches, each kernel's first use and the tables it builds).  The second call at that
signature captures ``fn`` into a CUDA graph on a side stream, in one private memory pool
that the cache's graphs share, and replays it; every later call copies its inputs into
the graph's static buffers, replays the graph once and returns clones of its outputs, so
that no caller holds a buffer that a later replay overwrites.  A signature seen once
never pays for a capture.

What ``fn`` reads besides its arguments (its object's tables, its closures' constants) is
baked into the graph when it is captured, and must not change afterwards.

A call runs eagerly, and is never captured, when its tensors are not all on one CUDA
device, when a leaf of ``args`` is neither a tensor nor ``None``, when it is made inside a
``torch.func`` transform or with autograd recording on an input, when the current stream
is already capturing (its operations then land in the outer graph), or when a capture at
its signature raised once (a host read, an operation that cannot be captured).

A replay adds to the hand-written kernels' host-side launch counters (those that
``ops/linalg.py`` ``launch_counts`` reads) what its capture added, so that they count what
ran.  Each call adds 1 to one of the tracer's counters ``<counter>.eager``,
``<counter>.capture`` and ``<counter>.replay`` (``utils/profiling.py``), ``counter`` being
the cache's; a signature seen for the first time adds 1 to ``<counter>.signatures``, and a
capture adds the bytes of the static input and output buffers its graph pins to
``<counter>.captured_bytes`` (the intermediates it keeps in the shared pool are not
counted).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from dgsqp_torch.ops.linalg import add_launches, launch_counts
from dgsqp_torch.utils import profiling

_SEEN, _EAGER = 'seen', 'eager'


def _key(leaves, spec, flags) -> Optional[tuple]:
    sig = []
    for x in leaves:
        if x is None:
            sig.append(None)
        elif isinstance(x, torch.Tensor):
            sig.append((tuple(x.shape), x.stride(), x.dtype, x.device))
        else:
            return None
    return flags, spec, tuple(sig)


def signature(args, *flags) -> Optional[tuple]:
    """The key of a call: ``flags``, the pytree structure of ``args`` and each leaf's
    shape, strides, dtype and device (``None`` for a ``None`` leaf); never the values.
    ``None`` when a leaf is neither a tensor nor ``None``."""
    leaves, spec = tree_flatten(args)
    return _key(leaves, spec, flags)


def _graphable(tensors) -> bool:
    if not tensors or any(t.device.type != 'cuda' or t.device != tensors[0].device
                          for t in tensors):
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return False
    if torch._C._functorch.peek_interpreter_stack() is not None:
        return False
    return not torch.cuda.is_current_stream_capturing()


def _since(before: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in launch_counts().items()
            if n != before.get(k, 0)}


class _Graph:
    """One captured call: the graph, the static buffers of its tensor inputs (in
    ``tree_flatten`` order) and outputs, and the launch counts its capture added."""

    def __init__(self, graph, inputs, outputs, out_spec, launches: dict):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.out_spec, self.launches = out_spec, launches

    def nbytes(self) -> int:
        """Bytes of the static input and output buffers."""
        return sum(t.nbytes for t in self.inputs + self.outputs)

    def replay(self, tensors):
        for s, t in zip(self.inputs, tensors):
            s.copy_(t)
        self.graph.replay()
        return tree_unflatten([o.clone() for o in self.outputs], self.out_spec)


class GraphCache:
    """CUDA graphs of one function by input signature (module docstring); ``counter``
    prefixes the tracer's counters."""

    def __init__(self, counter: str):
        self.counter = counter
        self._entries = {}      # signature -> _SEEN, _EAGER or a _Graph
        self._pool = None       # the graphs' private memory pool, made at the first capture
        # graphs whose capture raised, kept alive: a capture that fails before its end
        # leaves the caching allocator a pool filter that refers to its graph
        self._failed = []

    def __call__(self, fn: Callable, args, *flags):
        """``fn(*args, *flags)``: eager, or from the graph of this call's signature."""
        leaves, spec = tree_flatten(args)
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        key = _key(leaves, spec, flags) if _graphable(tensors) else None
        entry = _EAGER if key is None else self._entries.get(key)
        if isinstance(entry, _Graph):
            profiling.count(self.counter + '.replay')
            add_launches(entry.launches)
            return entry.replay(tensors)
        if entry is _SEEN:
            entry = self._entries[key] = self._capture(fn, leaves, spec, flags)
            if isinstance(entry, _Graph):
                profiling.count(self.counter + '.capture')
                profiling.count(self.counter + '.captured_bytes', entry.nbytes())
                return entry.replay(tensors)
        elif entry is None:
            self._entries[key] = _SEEN
            profiling.count(self.counter + '.signatures')
        profiling.count(self.counter + '.eager')
        return fn(*args, *flags)

    def _capture(self, fn, leaves, spec, flags):
        """A graph of ``fn`` at these arguments' signature, or ``_EAGER`` when capture
        raised.  The capture's own launch counts stand for the replay that follows it."""
        static = [x if x is None else torch.empty_like(x) for x in leaves]
        args = tree_unflatten(static, spec)
        device = next(x.device for x in static if x is not None)
        stream = torch.cuda.current_stream(device)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.device(device):
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                with torch.cuda.graph(graph, pool=self._pool):
                    out = fn(*args, *flags)
        except RuntimeError:
            # a failed capture may leave its side stream current; nothing it issued ran
            torch.cuda.set_stream(stream)
            add_launches(_since(before), -1)
            self._failed.append(graph)
            return _EAGER
        out_leaves, out_spec = tree_flatten(out)
        return _Graph(graph, [x for x in static if x is not None], out_leaves, out_spec,
                      _since(before))
