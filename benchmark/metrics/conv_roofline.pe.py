"""``conv_roofline.pe``: :func:`benchmark.harness.readers.conv_roofline` in the pe cells."""

from benchmark.harness.readers import conv_roofline as read  # noqa: F401
