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
    """A train/serve entry point was called before ``compile_step``."""


class WorkerFailedError(PSRuntimeError):
    """An async worker thread died with an exception; the original is
    chained as ``__cause__``."""


class FleetDeadError(PSRuntimeError):
    """The worker fleet is gone: every worker exited without producing
    gradients, or no gradient arrived within the idle timeout."""


class FillStarvedError(FleetDeadError):
    """A rank-distinct fill can never complete with the connected fleet
    (fewer distinct eligible ranks than the fill target, and no quorum
    configured to close fills short)."""


class AggregatorDeadError(PSRuntimeError):
    """Every group-local aggregator of a hierarchy failed before serving
    a single forward (upstream unreachable, or the whole tier crashed
    un-restorably with direct fallback impossible); the first failure is
    chained as ``__cause__``.  A single dead aggregator is not fatal: its
    workers fail over to direct root connections, so this fires only
    when the tier as a whole never functioned."""


class ShardDeadError(PSRuntimeError):
    """A PS-fleet shard died and could not be restored (no hot standby
    with replicated state, no checkpoint configured, or the per-shard
    restore budget is exhausted); the original failure is chained as
    ``__cause__``."""


class FleetManifestError(PSRuntimeError):
    """A fleet-checkpoint manifest (``ckpt.fleet.json``) refused a
    resume: a shard's checkpoint file is missing, its content digest
    disagrees with the manifest, or the manifest was written by a fleet
    with a different shard plan.  Restoring anyway would silently stitch
    a parameter tree from mismatched slices."""


class FleetResumeSkewError(FleetManifestError):
    """Per-shard checkpoints in a fleet resume were taken at different
    update counts (version skew): restoring them together would stitch a
    parameter tree from K different epochs.  The message names the
    offending shards and their recorded steps; take a coordinated fleet
    snapshot (``snapshot_every`` / `PSFleet.save_checkpoint`) to get a
    consistent set with a manifest."""


class BufferMutatedError(PSRuntimeError):
    """A wire buffer changed between hand-off to the transport and the
    moment its bytes were about to hit the socket, caught by the
    ``PS_BUFFER_SENTINEL=1`` debug checksum (`transport.Session`): the
    frame that would have flushed is not the frame the caller computed.
    This is the silent-corruption class no CRC catches — the CRC is
    computed over the already-wrong bytes — and exactly what the
    zero-copy wire's ownership contract (README "buffer ownership
    contract", pslint PSL7xx) exists to prevent.  The message names the
    frame kind and the enqueue site."""


class RaceDetectedError(PSRuntimeError):
    """A lock-discipline violation caught LIVE by the race sanitizer
    (``PS_RACE_SANITIZER=1`` / ``Session(race_sanitizer=True)``): a
    ``# pslint: holds(_lock)`` helper ran on a thread that did not hold
    the session lock — the caller-side obligation the static checkers
    (pslint PSL1xx/PSL8xx) document but cannot verify.  The dynamic
    complement of the lockset analysis: the static pass over-approximates
    interleavings, the sanitizer convicts the one that actually happened
    (with the helper name and the offending thread in the message).  A
    RuntimeError subclass, so the transport reconnect ladders (which
    retry ConnectionError/OSError only) never swallow it."""


class InferShedError(PSRuntimeError):
    """The inference front-end's bounded admission queue is full: the
    request was SHED with this typed refusal instead of queueing
    unboundedly (counted ``infer_shed``).  Graceful overload
    degradation for the serve tier — a caller (or load balancer) can
    catch it by type and back off / retry elsewhere, exactly like the
    wire's READ-class shed; the alternative (an unbounded queue) turns
    overload into unbounded tail latency for every request behind it."""


class SnapshotRewindError(PSRuntimeError):
    """A snapshot subscription observed the served version move
    BACKWARDS with different bytes behind it — a reader hot-swapping
    params on this stream would silently regress to an older model.
    Raised only when rewind tolerance is disabled; by default the
    subscriber counts (``version_rewinds``) and force-refreshes
    instead (promotion and checkpoint restore preserve the serving
    version counter precisely so this never fires)."""


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
