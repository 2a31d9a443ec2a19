"""What the per-layer metric files read (``benchmark/metrics/``). Each
takes the run's record and returns ``None`` where the run has nothing to
read (no trace). Which cells report a metric is its ``workloads`` list in
``BENCHMARK.json``."""

from .costs import PEAK_FLOPS


def idle_share(run):
    """% of the traced window in which no operation ran on the card."""
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def step_ms(run):
    """Device ms of one iteration: CUDA events around each chunk's call."""
    if not run.chunk_ms:
        return None
    return sum(run.chunk_ms) / (len(run.chunk_ms) * run.chunk)


def mfu(run):
    """% of the TF32 peak: the model FLOPs of one iteration times the
    traced run's untraced iterations per second."""
    if not run.untraced_rate:
        return None
    return 100.0 * run.step_flops * run.untraced_rate / PEAK_FLOPS


def conv_roofline(run):
    """% of the roofline over one iteration's conv calls: the sum of their
    bounds over the sum of their times, each call as often as the
    iteration makes it."""
    if not run.conv_rows:
        return None
    bound = sum(count * b for _, _, _, count, _, b in run.conv_rows)
    took = sum(count * ms for _, _, _, count, ms, _ in run.conv_rows)
    return 100.0 * bound / took if took > 0 else None


def iterations_per_s(run):
    """Training iterations completed over the window's host seconds."""
    return run.iterations / run.window_s
