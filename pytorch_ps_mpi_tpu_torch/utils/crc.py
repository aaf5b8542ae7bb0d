"""crc32 over the native PCLMUL kernel — `fast_crc32`.

The serializer checksums every buffer frame at save and again at load;
`fast_crc32` routes multi-KB buffers through the native ``ps_crc32``
kernel and the rest through ``zlib.crc32``, with the same result.

Copied from `pytorch_ps_mpi_tpu/utils/crc.py` (framework-free), but for
``crc32_combine``, which only the JAX package's scatter-gather wire
encoder (``encode_segments``) calls; it comes with the wire transport.
"""

from __future__ import annotations


# ---------------------------------------------------------------------------
# fast crc32 — the native PCLMUL kernel for multi-KB buffers
# ---------------------------------------------------------------------------

# Below this size the ctypes call overhead beats the PCLMUL win; the
# system zlib handles small buffers fine.
_NATIVE_MIN = 1 << 12

_native_crc = None
_native_failed = False


def _load_native():
    global _native_crc, _native_failed
    try:
        import ctypes

        import numpy as np

        from ..native import lib

        fn = lib().ps_crc32

        def native(data, crc: int) -> int:
            arr = (data if isinstance(data, np.ndarray)
                   else np.frombuffer(data, np.uint8))
            return fn(crc & 0xFFFFFFFF,
                      ctypes.c_void_p(arr.ctypes.data), arr.nbytes)

        _native_crc = native
    except Exception:  # pragma: no cover - toolchain-less host
        _native_failed = True
    return _native_crc


def fast_crc32(data, crc: int = 0) -> int:
    """``zlib.crc32``-compatible checksum that routes multi-KB buffers
    through the native PCLMUL kernel (`ps_crc32`, ~20x the system
    zlib's table loop on this image) — the wire path checksums every
    multi-MB frame at both ends, so this is directly serve-rate.
    Accepts bytes/bytearray/memoryview/C-contiguous ndarray; falls
    back to ``zlib.crc32`` for small buffers or a toolchain-less
    host."""
    import zlib

    n = data.nbytes if hasattr(data, "nbytes") else len(data)
    if n < _NATIVE_MIN or _native_failed:
        return zlib.crc32(data, crc)
    native = _native_crc or _load_native()
    if native is None:
        return zlib.crc32(data, crc)
    return native(data, crc)
