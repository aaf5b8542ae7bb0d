"""crc32 over the native PCLMUL kernel, and zlib's ``crc32_combine``.

The serializer checksums every buffer frame at save and again at load;
`fast_crc32` routes multi-KB buffers through the native ``ps_crc32``
kernel and the rest through ``zlib.crc32``, with the same result.  The
zero-copy wire checksums each leaf once: ``crc32(a || b) ==
crc32_combine(crc32(a), crc32(b), len(b))`` derives both the leaf
frame's crc and the whole frame's chained crc from that one pass
(`native.serializer.encode_segments`, `transport.frame_iovec`).

Copied from `pytorch_ps_mpi_tpu/utils/crc.py` (framework-free), not
imported.
"""

from __future__ import annotations

import functools

# CRC-32 (IEEE 802.3) reflected polynomial — the one zlib.crc32 uses.
_POLY = 0xEDB88320


def _times(mat: "list[int]", vec: int) -> int:
    """GF(2) matrix × vector: XOR the rows selected by vec's set bits."""
    out = 0
    i = 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _square(mat: "list[int]") -> "list[int]":
    return [_times(mat, mat[n]) for n in range(32)]


@functools.lru_cache(maxsize=4096)
def _shift_operator(len2: int) -> "list[int]":
    """The GF(2) operator advancing a crc32 register over ``len2`` zero
    bytes — zlib's even/odd squaring ladder, composed into ONE matrix so
    the memoized per-call cost is a single matrix×vector product."""
    # Operator for one zero BIT.
    odd = [0] * 32
    odd[0] = _POLY
    row = 1
    for n in range(1, 32):
        odd[n] = row
        row <<= 1
    # Square to 2 bits, then 4: the ladder below starts at 8 (one byte).
    even = _square(odd)
    odd = _square(even)
    op: "list[int] | None" = None
    while True:
        even = _square(odd)  # 8, 32, 128, ... bit shifts
        if len2 & 1:
            op = even if op is None else [_times(even, c) for c in op]
        len2 >>= 1
        if not len2:
            break
        odd = _square(even)  # 16, 64, 256, ... bit shifts
        if len2 & 1:
            op = odd if op is None else [_times(odd, c) for c in op]
        len2 >>= 1
        if not len2:
            break
    assert op is not None  # len2 >= 1 on entry
    return op


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """``crc32(a || b)`` from ``crc1 = crc32(a)``, ``crc2 = crc32(b)``
    and ``len2 = len(b)`` — no pass over either buffer."""
    if len2 <= 0:
        return crc1 & 0xFFFFFFFF
    return (_times(_shift_operator(len2), crc1) ^ crc2) & 0xFFFFFFFF



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
