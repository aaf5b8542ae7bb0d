"""Device ms a traced step of what was launched inside the codec's encode
(``ps.encode``)."""

from port_bench.readers import span_ms

read = span_ms("ps.encode", "device_ms")
