"""Metrics logging: reference-style status lines, a jsonl history whose
schema matches ``gennet_tpu.train.metrics`` (one ``{metric: float, "step":
int}`` object per line), the same history in memory for the plots, and a
steps/sec meter; and the observability helpers, a ``torch.profiler`` trace
and anomaly mode (the reference's ``jax.profiler`` trace and
``jax_debug_nans``)."""

import contextlib
import json
import os
import time
from collections import defaultdict

import numpy as np
import torch


class MetricLogger:
    """Persists per-step metric dicts to ``<out_dir>/<name>_metrics.jsonl``
    and keeps them as ``history`` (metric → list of values, ``"step"``
    included); computes steps/sec."""

    def __init__(self, out_dir: str | None = None, name: str = "train"):
        self.history = defaultdict(list)
        self._last = time.perf_counter()
        self._last_step = 0
        self._fh = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self._fh = open(os.path.join(out_dir, f"{name}_metrics.jsonl"), "a")

    def log(self, step: int, metrics: dict):
        row = {k: float(v) for k, v in metrics.items()}
        row["step"] = step
        for k, v in row.items():
            self.history[k].append(v)
        if self._fh:
            self._fh.write(json.dumps(row) + "\n")
            self._fh.flush()

    def steps_per_sec(self, step: int) -> float:
        now = time.perf_counter()
        ds = step - self._last_step
        dt = now - self._last
        self._last, self._last_step = now, step
        return ds / dt if dt > 0 else float("nan")

    def status_line(self, step: int, metrics: dict, sps: float | None = None) -> str:
        """'123: [sD loss: x, acc: y]  [sG loss: ..]' (ref: bbhMahoGANy.py:
        1303-1305), with steps/sec."""
        parts = [f"{step}:"]
        if "d_loss" in metrics:
            parts.append(f"[sD loss: {float(metrics['d_loss']):f}, acc: {float(metrics.get('d_acc', 0)):f}]")
        if "g_loss" in metrics:
            parts.append(f"[sG loss: {float(metrics['g_loss']):f}, acc: {float(metrics.get('g_acc', 0)):f}]")
        if "res_loss" in metrics and float(metrics.get("res_loss", 0)) != 0:
            parts.append(f"[nG loss: {float(metrics['res_loss']):f}]")
        if "pe_loss" in metrics:
            parts.append(f"[PE loss: {float(metrics['pe_loss']):f}]")
        if sps is not None:
            parts.append(f"[{sps:.1f} steps/s]")
        return "  ".join(parts)

    def arrays(self) -> dict:
        """``history`` as a dict of numpy arrays (what the plots read)."""
        return {k: np.asarray(v) for k, v in self.history.items()}

    def close(self):
        if self._fh:
            self._fh.close()


def fetch_metrics(metrics: dict) -> dict:
    """One device→host transfer for a dict of 0-d tensors."""
    keys = list(metrics)
    vals = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32) for k in keys]).cpu()
    return {k: float(v) for k, v in zip(keys, vals.tolist())}


@contextlib.contextmanager
def profile_trace(out_dir: str):
    """Profile the ``with`` block (the CPU, and every CUDA card when there
    is one) and write its Chrome trace to ``out_dir/trace_<ns>.json``,
    viewable in Perfetto or chrome://tracing. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(out_dir, f"trace_{time.time_ns()}.json"))


def debug_nans(enable: bool = True):
    """Numerical-sanitizer mode: autograd's anomaly detection, which raises
    when a backward function returns NaN and names the forward operation
    that made it (process-wide, as ``jax_debug_nans`` is)."""
    torch.autograd.set_detect_anomaly(enable)
