"""The whole step's model FLOPs over the window, as a share of the bf16
peak."""

from port_bench.readers import mfu as read  # noqa: F401
