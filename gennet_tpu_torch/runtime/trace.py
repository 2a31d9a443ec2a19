"""The port's host spans: a name, host start and end in nanoseconds on
``time.perf_counter_ns``'s clock, the span that was open around it, and a
few attributes, kept in memory.

``with span("graph.capture"): ...`` records one span when the block ends,
whether or not it raised. The parent is the innermost span still open in
the same thread. :func:`spans` returns a copy of the records, oldest first
by end; the newest :data:`CAPACITY` are kept. Recording is always on and
costs about a microsecond a span: it reads the host clock twice and
appends a tuple, and never waits on the device, reads a tensor or
annotates the device's timeline (a profiler range would show up among the
device's records).

The spans, each read by a per-layer metric of the benchmark
(``benchmark/metrics/``):

- ``chunk`` (attributes ``graph``, the step graph's name, and ``n``, the
  iterations of the call): one call of a chunk step of
  ``make_gan_step_scan`` or ``make_cnn_step_scan``;
- ``graph.warmup``, ``graph.capture`` and ``graph.replay`` (attribute
  ``replays``): :class:`~gennet_tpu_torch.runtime.graphs.StepGraph`'s
  eager iterations before a capture, the capture, and the replays;
- ``optim.adam``: the construction of an optimizer
  (:func:`gennet_tpu_torch.runtime.optim.adam`).
"""

import collections
import itertools
import threading
import time

CAPACITY = 65536

# (id, name, start_ns, end_ns, parent_id, attrs)
_RECORDS = collections.deque(maxlen=CAPACITY)
_IDS = itertools.count(1)
_OPEN = threading.local()


class span:
    """A context manager that records one span; after the block,
    ``start_ns`` and ``end_ns`` hold its bounds."""

    __slots__ = ("name", "attrs", "id", "parent", "start_ns", "end_ns")

    def __init__(self, name: str, **attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self.id = next(_IDS)
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        _OPEN.stack.pop()
        _RECORDS.append((self.id, self.name, self.start_ns, self.end_ns, self.parent,
                         self.attrs))
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def spans() -> list:
    """A copy of the records: ``(id, name, start_ns, end_ns, parent_id,
    attrs)`` each, ``parent_id`` ``None`` at the top."""
    return list(_RECORDS)


def clear():
    """Forget every record."""
    _RECORDS.clear()
