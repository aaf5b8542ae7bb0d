"""Typed runtime errors of the PyTorch port.

Counterpart of `pytorch_ps_mpi_tpu/errors.py`, copied (not imported: the
port never imports the JAX package) for the errors this slice raises.
Every class subclasses ``RuntimeError`` so ``except RuntimeError`` call
sites keep working.  ``ValueError``/``TypeError`` on eager configuration
validation stay builtins, as in the JAX package.
"""

from __future__ import annotations


class PSRuntimeError(RuntimeError):
    """Base class for the library's operational (non-config) failures."""


class NotCompiledError(PSRuntimeError):
    """A train entry point was called before ``compile_step``."""
