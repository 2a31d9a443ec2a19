"""``idle_share.gan``: :func:`benchmark.harness.readers.idle_share` in the gan cells."""

from benchmark.harness.readers import idle_share as read  # noqa: F401
