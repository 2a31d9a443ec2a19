"""``chunk_prep_ms.pe``: :func:`benchmark.harness.program_spans.chunk_prep_ms` in the pe cells."""

from benchmark.harness.program_spans import chunk_prep_ms as read  # noqa: F401
