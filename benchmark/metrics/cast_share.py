"""``cast_share``: % of one iteration's device time that its dtype
conversions take, each distinct conversion timed alone (``run.cast_rows``,
:func:`benchmark.harness.bf16time.cast_table`), as often as the iteration
makes it, autograd's casts of the gradients included, over ``step_ms``
(:func:`benchmark.harness.readers.step_ms`).

``None`` where the run has no such rows or no step time (untraced), and
where the program's count disagrees with the harness's: every
``graph.capture`` span that carries the program's ``casts`` counter (one
captured iteration's forward conversions,
``gennet_tpu_torch.runtime.trace``) must read
``run.casts_per_iteration``, and one must exist (a program without the
counter reads ``None``)."""

from benchmark.harness.program_spans import records
from benchmark.harness.readers import step_ms


def program_casts(run) -> set:
    """The ``casts`` of each ``graph.capture`` span that carries one."""
    return {r[5]["casts"] for r in records() or () if r[1] == "graph.capture" and "casts" in r[5]}


def read(run):
    rows, step = getattr(run, "cast_rows", None), step_ms(run)
    if not rows or not step or program_casts(run) != {getattr(run, "casts_per_iteration", None)}:
        return None
    return 100.0 * sum(count * ms for _, _, _, count, ms, _ in rows) / step
