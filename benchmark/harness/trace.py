"""The device's side of a traced window, from ``torch.profiler``'s raw
records (CUDA activity only: the host's op events would cost more to read
back than the window takes).

- busy seconds: the union of the intervals in which a kernel, copy or
  set ran on the card, inside the window;
- the device operations that took most time, by kernel name;
- the longest idle gaps, each labelled with the benchmark's host span open
  when it began (``window_start`` and ``window_end`` at the edges).

Kineto drops, as out of range, a record whose time, converted from the
card's clock to the host's, lands after the profiler's stop (it did so to
the last kernels of a chunk on an H100 with torch 2.11): an idle margin at
each end keeps them in. The card's clock is tied to the host's by a short
marker kernel launched on an idle card at a known host time, at each end.
"""

import contextlib
import time

MARGIN_S = 0.1
MARK_CYCLES = 1000
TOP = 10


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class DeviceTrace:
    """``with trace.window(): ...`` profiles the block; :meth:`reduce` reads it."""

    def __init__(self, spans):
        self.spans = spans
        self.prof = None
        self.marks = []      # host ns at which each marker kernel was launched
        self.t0 = self.t1 = None

    def _mark(self):
        import torch

        torch.cuda.synchronize()
        self.marks.append(time.perf_counter_ns())
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()

    @contextlib.contextmanager
    def window(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(MARGIN_S)
            self._mark()
            self.t0 = time.perf_counter_ns()
            try:
                yield
            finally:
                torch.cuda.synchronize()
                self.t1 = time.perf_counter_ns()
                self._mark()
                time.sleep(MARGIN_S)
        self.prof = prof

    def reduce(self) -> dict:
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in self.prof.profiler.kineto_results.events()
                  if e.device_type() == cuda]
        marks = sorted(a for name, a, _ in events if "spin_kernel" in name)
        offset = (marks[0] - self.marks[0]) if marks else None
        events = [ev for ev in events if "spin_kernel" not in ev[0]]
        if offset is None:  # no marker: the window is what the records span
            offset = (min(a for _, a, _ in events) - self.t0) if events else 0
        w0, w1 = self.t0 + offset, self.t1 + offset
        inside = [(n, max(a, w0), min(b, w1)) for n, a, b in events if b > w0 and a < w1]
        merged = _merge([[a, b] for _, a, b in inside])
        busy = sum(b - a for a, b in merged)
        by_name = {}
        for n, a, b in inside:
            by_name[n] = by_name.get(n, 0) + (b - a)
        gaps, prev = [], w0
        for a, b in merged + [[w1, w1]]:
            if a > prev:
                label = ("window_start" if prev == w0 else "window_end" if a == w1
                         else self.spans.at(prev - offset))
                gaps.append((label, (a - prev) * 1e-9))
            prev = max(prev, b)
        return {
            "busy_s": busy * 1e-9,
            "window_s": (w1 - w0) * 1e-9,
            "n_events": len(inside),
            "aligned": bool(marks),
            "device_ops": [[n[:120], t * 1e-9] for n, t in
                           sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
            "idle_gaps": [[n, s] for n, s in sorted(gaps, key=lambda g: -g[1])[:TOP]],
        }
