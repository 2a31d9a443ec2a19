"""``optim_init_s``: :func:`benchmark.harness.program_spans.optim_init_s` in every cell."""

from benchmark.harness.program_spans import optim_init_s as read  # noqa: F401
