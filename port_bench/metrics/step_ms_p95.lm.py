"""The 95th percentile of the window's step times (CUDA events; the largest
over ranks a step)."""

from port_bench.readers import step_ms_p95 as read  # noqa: F401
