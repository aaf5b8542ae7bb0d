"""Per-step metrics keys and the overlap-schedule record.

Counterpart of `pytorch_ps_mpi_tpu/utils/timing.py`: the reference's
``step()`` returns a per-phase wall-clock dict, and every step of the port
returns the same keys; `format_fault_stats` prints the sync trainer's
``fault_stats``.  The overlap engine (`parallel.overlap`) records
each bucket schedule it builds here, so a run's chosen schedule can be
read after the fact.
"""

from __future__ import annotations

from typing import Any

# Canonical metric keys, matching the reference step() dict (`ps.py:193`).
STEP_METRIC_KEYS = (
    "code_wait",              # encode phase (host wall-clock or phase-split)
    "iallgather_prepare_time",  # trace+compile of the SPMD program (one-time)
    "isend_time",             # collective dispatch latency
    "comm_wait",              # block_until_ready on the synced grads
    "decode_time",            # decode phase
    "optim_step_time",        # parameter update phase
    "msg_bytes",              # encoded payload bytes per rank
    "packaged_bytes",         # on-wire bytes (after codec packaging)
)

# The counters of the sync trainer's ``fault_stats`` that
# `format_fault_stats` prints, in the JAX package's order.
_SYNC_FAULT_COUNTERS = ("fused_sync_encodes", "sdc_checks", "sdc_mismatches",
                        "sdc_rebroadcasts")


def format_fault_stats(fs: "dict[str, Any]") -> str:
    """One-line summary of a sync trainer's ``fault_stats`` (the
    `MPI_PS.fault_stats` subset of the JAX package's
    ``format_fault_stats``): the non-zero counters, the first leaf an SDC
    check flagged and the number of rollbacks, or ``"clean"``."""
    parts = [f"{key}={fs[key]}" for key in _SYNC_FAULT_COUNTERS
             if fs.get(key)]
    if fs.get("sdc_first_leaf"):
        parts.append(f"sdc_first_leaf={fs['sdc_first_leaf']!r}")
    if fs.get("rollbacks"):
        parts.append(f"rollbacks={len(fs['rollbacks'])}")
    return ", ".join(parts) if parts else "clean"


_OVERLAP_SCHEDULES: list[dict[str, Any]] = []


def record_overlap_schedule(info: "dict[str, Any]") -> None:
    """Append one schedule record (see `OverlapPlan.describe`)."""
    _OVERLAP_SCHEDULES.append(dict(info))


def overlap_schedules() -> "list[dict[str, Any]]":
    """All schedule records since process start (or the last clear)."""
    return list(_OVERLAP_SCHEDULES)


def clear_overlap_schedules() -> None:
    _OVERLAP_SCHEDULES.clear()
