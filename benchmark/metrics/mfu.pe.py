"""``mfu.pe``: :func:`benchmark.harness.readers.mfu` in the pe cells."""

from benchmark.harness.readers import mfu as read  # noqa: F401
