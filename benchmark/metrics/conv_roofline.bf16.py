"""``conv_roofline.bf16``: % of the roofline over one iteration's conv
calls of the layers that compute in bfloat16 (``run.conv_rows_bf16``,
:func:`benchmark.harness.bf16time.conv_table`: each timed alone through
the model's own layer on bfloat16 inputs, bound at 2-byte operands and the
BF16 peak): :func:`benchmark.harness.readers.conv_roofline` over them.
``None`` where the run has no such rows (untraced)."""

from types import SimpleNamespace

from benchmark.harness.readers import conv_roofline


def read(run):
    rows = getattr(run, "conv_rows_bf16", None)
    return conv_roofline(SimpleNamespace(conv_rows=rows)) if rows else None
