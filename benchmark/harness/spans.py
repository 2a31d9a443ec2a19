"""The benchmark's own host spans around its calls into the program (the
program has none yet): a name and host start and end in nanoseconds on
``time.perf_counter_ns``'s clock, kept in memory."""

import contextlib
import time


class Spans:
    def __init__(self):
        self.spans = []  # (name, start_ns, end_ns)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter_ns()))

    def at(self, t_ns: int, default: str = "host") -> str:
        """The innermost span open at host time ``t_ns``."""
        best = None
        for name, a, b in self.spans:
            if a <= t_ns <= b and (best is None or b - a < best[1]):
                best = (name, b - a)
        return default if best is None else best[0]
