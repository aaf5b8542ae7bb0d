"""Build and load the CUDA kernels.

Each source in ``csrc/`` (``codec_kernels.cu``, ``flash_attention.cu``) is
compiled at first use with ``nvcc`` for ``sm_90a`` into a shared library of
its own with a plain C interface, loaded with ``ctypes``.  The libraries
land in ``pytorch_ps_mpi_tpu_torch/_build/`` (listed in ``.gitignore``),
named after a hash of the source and the flags, so an edited source is
rebuilt and a finished build is reused.  `build` starts one ``nvcc`` per
missing library, all at once, and waits for them together.  Nothing here
runs at import: the CPU tests import every module, and this host has no
``nvcc``.

The flags leave out ``--use_fast_math`` on purpose: the quantizer's true
division and half-to-even rounding, the decode sums' unfused multiply and
add, and the attention kernels' IEEE ``expf``/``logf`` and division are
what make the kernels agree with the JAX package and their plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ..errors import PSRuntimeError

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# Library name -> {C function: argument types}.  Every library also exports
# ``ps_error_string``.
_SIGNATURES = {
    "codec_kernels": {
        # x, n, tile, n_blocks, bits, vec, ctas, q, scales, stream
        "ps_block_quantize": (_P, _L, _I, _L, _I, _I, _I, _P, _P, _P),
        # rows (7 int64 a leaf), count, world, bits, stream, launches
        "ps_block_dequant_sum_group": (_P, _I, _I, _I, _P, _P),
        # rows (4 int64 a leaf), count, world, dtype, stream, launches
        "ps_cast_sum_group": (_P, _I, _I, _I, _P, _P),
        # kind, out[5]
        "ps_group_info": (_I, _P),
    },
    "flash_attention": {
        # dtype, d, q, k, v, strides[12], o, lse, B, H, L, scale, causal,
        # stream
        "ps_flash_fwd": (_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I,
                         _P),
        # dtype, d, q, k, v, dout, strides[12], lse, delta, dk, dv, B, H, L,
        # scale, causal, stream
        "ps_flash_bwd_dkdv": (_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                              _I, _I, _F, _I, _P),
        # dtype, d, q, k, v, dout, strides[12], lse, delta, dq, B, H, L,
        # scale, causal, stream
        "ps_flash_bwd_dq": (_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                            _I, _F, _I, _P),
        # kind, dtype, d, out[6]
        "ps_flash_kernel_info": (_I, _I, _I, _P),
    },
}
SOURCES = {name: _PKG / "csrc" / f"{name}.cu" for name in _SIGNATURES}

_libs: "dict[str, ctypes.CDLL]" = {}
_libs_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise PSRuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the CUDA "
        "kernels are built from csrc/ on the machine with the card")


def _target(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None) -> "dict[str, tuple[Path, str]]":
    """Compile each named library (default: all) unless its build exists
    already, one ``nvcc`` per library, run together.  Returns ``{name:
    (library path, compiler log)}``; a log, empty for a reused build, holds
    ``-Xptxas -v``'s registers, shared memory and spills per kernel."""
    names = list(SOURCES) if names is None else list(names)
    out, running = {}, {}
    for name in names:
        target = _target(name)
        if target.exists():
            out[name] = (target, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        running[name] = (target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (target, tmp, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name].name} ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)  # atomic: concurrent ranks never load a partial file
        out[name] = (target, log)
    if failed:
        raise PSRuntimeError("nvcc failed: " + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built on first call (under a
    lock: the async PS's worker threads may reach it at once)."""
    if name in _libs:
        return _libs[name]
    with _libs_lock:
        if name in _libs:
            return _libs[name]
        path, _ = build([name])[name]
        lib = ctypes.CDLL(str(path))
        for fn_name, argtypes in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.ps_error_string.argtypes = [ctypes.c_int]
        lib.ps_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


def check(lib: str, kernel: str, err: int) -> None:
    """Raise if a kernel's launch from library ``lib`` returned a CUDA
    error."""
    if err != 0:
        msg = library(lib).ps_error_string(err).decode(errors="replace")
        raise PSRuntimeError(f"{kernel} kernel launch failed: CUDA error "
                             f"{err} ({msg})")
