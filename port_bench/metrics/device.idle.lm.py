"""The traced stretch's share with no device operation (union over
streams)."""

from port_bench.readers import device_idle as read  # noqa: F401
