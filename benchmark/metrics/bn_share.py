"""``bn_share``: % of one iteration's device time that its BatchNorm calls
take, each timed alone (``run.bn_rows``, :mod:`benchmark.harness.bntime`),
as often as the iteration makes it, over ``step_ms``
(:func:`benchmark.harness.readers.step_ms`). ``None`` where the run has no
such rows or no step time (untraced)."""

from benchmark.harness.readers import step_ms


def read(run):
    rows, step = getattr(run, "bn_rows", None), step_ms(run)
    if not rows or not step:
        return None
    return 100.0 * sum(count * ms for _, _, _, count, ms, _ in rows) / step
