"""Seconds from process start to the first timed step."""

from port_bench.readers import setup_s as read  # noqa: F401
