"""Typed runtime errors of the PyTorch port.

Counterpart of `pytorch_ps_mpi_tpu/errors.py` (and of the two errors the
JAX package's ``ps.py`` defines), copied, not imported: the port never
imports the JAX package.  The operational failures subclass
``RuntimeError`` so ``except RuntimeError`` call sites keep working;
`ElasticResumeError` is a ``ValueError``, as in the JAX package, since it
refuses a checkpoint's contents.  ``ValueError``/``TypeError`` on eager
configuration validation stay builtins, as in the JAX package.
"""

from __future__ import annotations


class PSRuntimeError(RuntimeError):
    """Base class for the library's operational (non-config) failures."""


class NotCompiledError(PSRuntimeError):
    """A train entry point was called before ``compile_step``."""


class WorkerFailedError(PSRuntimeError):
    """An async worker thread died with an exception; the original is
    chained as ``__cause__``."""


class FleetDeadError(PSRuntimeError):
    """The worker fleet is gone: every worker exited without producing
    gradients, or no gradient arrived within the idle timeout."""


class NativeToolchainError(PSRuntimeError):
    """The in-repo native (C++) codec pipeline failed to build or its
    encoder reported a hard error."""


class SDCDetectedError(RuntimeError):
    """The replica-consensus guard found data-parallel replicas that are
    not bitwise identical — silent data corruption or a desync bug.
    Raised under ``consensus_policy="abort"``; the message names the first
    diverging parameter leaf."""


class ElasticResumeError(ValueError):
    """A checkpoint that cannot be remapped onto this optimizer's topology.

    Elastic N→M resume de-chunks and re-chunks ZeRO shards and remaps the
    error-feedback residual across world sizes; when a component is
    genuinely topology-bound (or reflects a model change, not a topology
    change), this names it instead of loading a silently wrong state."""
