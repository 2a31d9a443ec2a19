"""``conv_roofline.gan``: :func:`benchmark.harness.readers.conv_roofline` in the gan cells."""

from benchmark.harness.readers import conv_roofline as read  # noqa: F401
