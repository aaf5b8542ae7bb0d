"""Device ms a step of the model's conv/matmul, head GEMM, norm and softmax
kernels."""

from port_bench.readers import model_device_ms as read  # noqa: F401
