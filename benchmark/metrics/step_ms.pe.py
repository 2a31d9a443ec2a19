"""``step_ms.pe``: :func:`benchmark.harness.readers.step_ms` in the pe cells."""

from benchmark.harness.readers import step_ms as read  # noqa: F401
