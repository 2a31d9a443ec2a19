"""``step_ms.gan``: :func:`benchmark.harness.readers.step_ms` in the gan cells."""

from benchmark.harness.readers import step_ms as read  # noqa: F401
