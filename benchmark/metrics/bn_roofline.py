"""``bn_roofline``: % of the HBM bound over one iteration's BatchNorm calls
(``run.bn_rows``, :mod:`benchmark.harness.bntime`): the sum of their bounds
over the sum of their times, each call as often as the iteration makes it.
``None`` where the run has no such rows (untraced, or a phase without
BatchNorm)."""


def read(run):
    rows = getattr(run, "bn_rows", None)
    if not rows:
        return None
    took = sum(count * ms for _, _, _, count, ms, _ in rows)
    return 100.0 * sum(count * b for _, _, _, count, _, b in rows) / took if took > 0 else None
