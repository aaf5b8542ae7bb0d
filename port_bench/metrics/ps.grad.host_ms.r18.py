"""Host ms a traced step inside the forward, the loss and the backward
(``ps.grad``)."""

from port_bench.readers import span_ms

read = span_ms("ps.grad", "host_ms")
