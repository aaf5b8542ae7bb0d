"""The codec's least time a step over its kernels' device time."""

from port_bench.readers import codec_roofline as read  # noqa: F401
