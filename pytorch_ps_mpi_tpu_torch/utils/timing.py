"""Per-step metrics keys and the overlap-schedule record.

Counterpart of `pytorch_ps_mpi_tpu/utils/timing.py`: the reference's
``step()`` returns a per-phase wall-clock dict, and every step of the port
returns the same keys; `print_summary` prints their mean and max over a
run, `format_fault_stats` the sync trainer's ``fault_stats``, and `trace`
records a run with ``torch.profiler``.  The overlap engine
(`parallel.overlap`) records each bucket schedule it builds here, so a
run's chosen schedule can be read after the fact.
"""

from __future__ import annotations

import contextlib
import os
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


@contextlib.contextmanager
def trace(logdir: str):
    """Record the region with ``torch.profiler`` (host ops, and the card's
    kernels when one is visible) and write it as a Chrome trace,
    ``logdir/trace-<pid>.json`` (open it in Perfetto or
    ``chrome://tracing``).  Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir,
                                          f"trace-{os.getpid()}.json"))


def print_summary(timings: "list[dict[str, Any]]", keys=None) -> None:
    """Mean/max per metric over accumulated step dicts."""
    if not timings:
        print("(no timings)")
        return
    if keys is None:
        keys = sorted({k for t in timings for k in t})
    width = max(len(k) for k in keys)
    for k in keys:
        vals = [float(t[k]) for t in timings if k in t]
        if not vals:
            continue
        mean = sum(vals) / len(vals)
        print(f"{k:<{width}}  mean={mean:10.6f}  max={max(vals):10.6f}  "
              f"n={len(vals)}")
