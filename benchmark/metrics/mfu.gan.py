"""``mfu.gan``: :func:`benchmark.harness.readers.mfu` in the gan cells."""

from benchmark.harness.readers import mfu as read  # noqa: F401
