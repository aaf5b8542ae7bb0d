"""Device ms a traced step of what was launched inside the optimizer's rule and
the EMA (``ps.update``)."""

from port_bench.readers import span_ms

read = span_ms("ps.update", "device_ms")
