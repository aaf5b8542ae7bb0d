"""Host ms a traced step inside the codec's encode (``ps.encode``)."""

from port_bench.readers import span_ms

read = span_ms("ps.encode", "host_ms")
