"""``chunk_prep_ms.gan``: :func:`benchmark.harness.program_spans.chunk_prep_ms` in the gan cells."""

from benchmark.harness.program_spans import chunk_prep_ms as read  # noqa: F401
