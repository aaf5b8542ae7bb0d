"""The attention's least time a step over its kernels' device time."""

from port_bench.readers import attention_roofline as read  # noqa: F401
