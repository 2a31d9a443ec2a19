"""``graph_setup_s``: :func:`benchmark.harness.program_spans.graph_setup_s` in every cell."""

from benchmark.harness.program_spans import graph_setup_s as read  # noqa: F401
