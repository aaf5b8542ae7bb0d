"""Build and load the CUDA codec kernels.

``csrc/codec_kernels.cu`` is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``.  The library lands in ``pytorch_ps_mpi_tpu_torch/_build/``
(listed in ``.gitignore``), named after a hash of the source and the
flags, so an edited source is rebuilt and a finished build is reused.
Nothing here runs at import: the CPU tests import every module, and this
host has no ``nvcc``.

The flags leave out ``--use_fast_math`` on purpose: the quantizer's true
division and half-to-even rounding, and the decode sums' unfused multiply
and add, are what make the kernels agree bit for bit with the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..errors import PSRuntimeError

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "codec_kernels.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: "ctypes.CDLL | None" = None

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # x, n, tile, n_blocks, bits, vec, q, scales, stream
    "ps_block_quantize": (_P, _L, _I, _L, _I, _I, _P, _P, _P),
    # q, q_rank_stride, bits, scales, s_rank_stride, world, total, tile,
    # out, stream
    "ps_block_dequant_sum": (_P, _L, _I, _P, _L, _I, _L, _I, _P, _P),
    # x, rank_stride, dtype, world, n, vec, out, stream
    "ps_cast_sum": (_P, _L, _I, _I, _L, _I, _P, _P),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise PSRuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the CUDA "
        "codec kernels are built from csrc/ on the machine with the card")


def build() -> "tuple[Path, str]":
    """Compile the kernels unless this source's library exists already.
    Returns ``(library path, compiler log)``; the log, empty for a reused
    build, holds ``-Xptxas -v``'s registers and spills per kernel."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libcodec_kernels-{digest}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise PSRuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent ranks never load a partial file
    return out, proc.stdout + proc.stderr


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.ps_error_string.argtypes = [ctypes.c_int]
        lib.ps_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(name: str, err: int) -> None:
    """Raise if a kernel's launch returned a CUDA error."""
    if err != 0:
        msg = library().ps_error_string(err).decode(errors="replace")
        raise PSRuntimeError(f"{name} kernel launch failed: CUDA error "
                             f"{err} ({msg})")
