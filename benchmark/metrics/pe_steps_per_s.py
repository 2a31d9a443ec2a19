"""``pe_steps_per_s``: :func:`benchmark.harness.readers.iterations_per_s` in the pe cells."""

from benchmark.harness.readers import iterations_per_s as read  # noqa: F401
