"""``idle_share.pe``: :func:`benchmark.harness.readers.idle_share` in the pe cells."""

from benchmark.harness.readers import idle_share as read  # noqa: F401
