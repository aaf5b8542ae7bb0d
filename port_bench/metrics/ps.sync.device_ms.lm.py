"""Device ms a traced step of what was launched inside the exchange of the
codes and their decode-sum (``ps.sync``)."""

from port_bench.readers import span_ms

read = span_ms("ps.sync", "device_ms")
