"""Device ms a traced step of what was launched inside the forward, the loss
and the backward (``ps.grad``)."""

from port_bench.readers import span_ms

read = span_ms("ps.grad", "device_ms")
