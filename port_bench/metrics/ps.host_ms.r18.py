"""Host ms to issue one queued step of the PS (`ps.py`'s `isend_time`, rank
0)."""

from port_bench.readers import host_ms as read  # noqa: F401
