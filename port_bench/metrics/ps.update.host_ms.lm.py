"""Host ms a traced step inside the optimizer's rule and the EMA
(``ps.update``)."""

from port_bench.readers import span_ms

read = span_ms("ps.update", "host_ms")
