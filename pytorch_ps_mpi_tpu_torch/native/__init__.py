"""Native (C++) host components, bound with ctypes.

Counterpart of `pytorch_ps_mpi_tpu/native/__init__.py`: the same two
sources, copied into ``src/`` — ``ps_serial.cpp`` (the checkpoint byte
pipeline: shuffle, LZ, crc32, the batched tree encode and decode) and
``ps_loader.cpp`` (the data loader's threaded row gather) — whose code is
the JAX package's line for line; only comments that named files outside
the repository differ.
This is host code: it builds with ``g++`` (no ``nvcc``), on the CPU host as
on the card's machine, at first use and never at import, into
``pytorch_ps_mpi_tpu_torch/_build/`` (listed in ``.gitignore``) under a
name carrying a hash of the sources, so an edited source is rebuilt.  The
build writes a temporary file and renames it into place, so processes
that build at once never load a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_DIR, "src", f)
         for f in ("ps_serial.cpp", "ps_loader.cpp")]
_LIBDIR = os.path.join(os.path.dirname(_DIR), "_build")
_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")
# ps_serial.cpp includes <immintrin.h> inside an anonymous namespace; from
# g++ 13 that header pulls in parts of the standard library, which then
# land in the namespace ("reference to 'std' is ambiguous").  Included
# first, its guards make the inner include empty, and the copied code
# stays the JAX package's.
if platform.machine() in ("x86_64", "AMD64", "i386", "i686"):
    _FLAGS += ("-include", "immintrin.h")

_lib_handle = None


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for s in _SRCS:
        with open(s, "rb") as f:
            h.update(f.read())
    return os.path.join(_LIBDIR, f"libps_native-{h.hexdigest()[:16]}.so")


def _build() -> str:
    """Compile the shared library unless a build of these sources exists."""
    path = _lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(_LIBDIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_LIBDIR)
    os.close(fd)
    cmd = ["g++", *_FLAGS, "-o", tmp, *_SRCS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, OSError) as e:
        os.unlink(tmp)
        from ..errors import NativeToolchainError
        raise NativeToolchainError(
            f"native build failed: {' '.join(cmd)}\n"
            f"{getattr(e, 'stderr', None) or e}") from e
    os.replace(tmp, path)
    return path


def lib() -> ctypes.CDLL:
    """The loaded native library (built on first use)."""
    global _lib_handle
    if _lib_handle is None:
        h = ctypes.CDLL(_build())
        h.ps_max_compressed.restype = ctypes.c_size_t
        h.ps_max_compressed.argtypes = [ctypes.c_size_t]
        for name in ("ps_lz_compress", "ps_lz_decompress"):
            fn = getattr(h, name)
            fn.restype = ctypes.c_longlong
            fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                           ctypes.c_void_p, ctypes.c_size_t]
        for name in ("ps_shuffle", "ps_unshuffle"):
            fn = getattr(h, name)
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_size_t, ctypes.c_size_t]
        h.ps_crc32.restype = ctypes.c_uint32
        h.ps_crc32.argtypes = [ctypes.c_uint32, ctypes.c_void_p,
                               ctypes.c_size_t]
        h.ps_tree_decode.restype = ctypes.c_longlong
        h.ps_tree_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_size_t, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong)]
        h.ps_tree_encode.restype = ctypes.c_longlong
        h.ps_tree_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong)]
        h.ps_gather_rows.restype = None
        h.ps_gather_rows.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_size_t, ctypes.c_size_t,
                                     ctypes.c_void_p, ctypes.c_int]
        _lib_handle = h
    return _lib_handle
