"""Flat collectives of the sync phase in the window's last step
(``sync_calls``, rank 0)."""

from port_bench.readers import counter

read = counter("sync_calls")
