"""Per-step metrics keys, the step's named spans and the overlap-schedule
record.

Counterpart of `pytorch_ps_mpi_tpu/utils/timing.py`: the reference's
``step()`` returns a per-phase wall-clock dict, and every step of the port
returns the same keys; `print_summary` prints their mean and max over a
run, `format_fault_stats` a trainer's, server's or worker's
``fault_stats``, and `trace` records a run with ``torch.profiler``.
`annotate` opens a named host span in that trace (the JAX package's
``annotate``).  The sync step (`ps.MPI_PS.step`) opens five:
``ps.step`` around the whole step, and inside it, in order, ``ps.grad``
(forward, loss, backward, the loss and aux means), ``ps.encode``,
``ps.sync`` (the exchange of the codes and their decode-sum) and
``ps.update`` (the rule, and the EMA).  They are
``torch.profiler.record_function`` spans, on the profiler's clock, so a
kernel is tied to the span that launched it; with no profiler recording a
span is one flag check.  `RequestLatency` and `RankLatency` are the async
PS's per-rank latency record (host code, copied with the JAX package's
numbers).  The overlap engine (`parallel.overlap`) records each bucket
schedule it builds here, so a run's chosen schedule can be read after the
fact.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from typing import Any

import numpy as np
import torch

# Canonical metric keys, matching the reference step() dict (`ps.py:193`).
# Seconds on the host clock unless noted; the phase keys are filled only by
# a ``profile=True`` step, which runs each phase to a device synchronize.
STEP_METRIC_KEYS = (
    "code_wait",              # encode phase (profiled steps)
    "iallgather_prepare_time",  # the first step's issue, with one-time set-up
    "isend_time",             # host time to issue a step (profiled: the sync)
    "comm_wait",              # synchronize after the issue (profiled: sync)
    "decode_time",            # decode-sum, inside the sync (profiled steps)
    "optim_step_time",        # parameter update phase (profiled steps)
    "msg_bytes",              # gradient bytes per rank, before encoding
    "packaged_bytes",         # on-wire bytes (after codec packaging)
)

# The counters `format_fault_stats` prints, in the JAX package's order
# (its keys, so both packages' lines read alike): the multihost server's
# and worker's transport counters, the async PS's admission counters,
# the fleet/hierarchy/serve-tier counters (0 until those slices land)
# and the sync trainer's.
_FAULT_COUNTERS = (
    "evictions", "reconnects", "crc_dropped", "quarantined_frames",
    "stale_dropped", "nonfinite_dropped", "accept_errors", "conn_drops",
    "quorum_fills", "late_folded", "robust_clipped", "duplicate_dropped",
    "evicted_dropped", "quarantined_drops", "surplus_dropped",
    "breakdown_floor_stalls", "floor_relaxed_admits",
    "shard_restores", "promotions",
    "repl_sent", "repl_received", "repl_refused", "repl_lag",
    "snapshot_barriers", "partition_drops", "degraded_pulls",
    "agg_frames", "agg_forwards", "agg_paced", "agg_failovers",
    "agg_redials", "direct_fallbacks", "agg_restarts",
    "latency_weighted", "deadline_adapted",
    "deadline_expired", "credits_stalled", "shed_data_frames",
    "admission_shed", "flood_injected", "burst_injected", "slow_consumed",
    "sentinel_checks", "sentinel_trips", "race_checks", "race_trips",
    "parm_encodes", "parm_fanout_reuse", "parm_unchanged",
    "segments_sent", "decode_offloaded",
    "buckets_sent", "buckets_filled", "bucket_partial_timeouts",
    "fused_encodes",
    "reads_served", "read_shed", "delta_frames", "subs_active",
    "reads_stalled", "version_rewinds", "infer_requests", "infer_shed",
    "param_swaps",
    "parm_bytes_raw", "parm_bytes_wire", "delta_hits", "delta_misses",
    "fused_sync_encodes",
    "sdc_checks", "sdc_mismatches", "sdc_rebroadcasts")


# ---------------------------------------------------------------------------
# Per-rank latency: the async PS's admission audit trail
# ---------------------------------------------------------------------------

class RequestLatency:
    """Windowed duration tracker: EMA + rolling p50/p95 over observed
    spans — the shared percentile engine.  `RankLatency` keeps one per
    rank and feeds it inter-submission intervals.

    ``observe(seconds)`` appends one duration; percentiles are computed
    over the last ``window`` observations (rolling, so a long run
    reports its RECENT tail, not its lifetime average).  Reads and
    writes may come from different threads, so every window access
    copies under a small lock — an unsynchronized deque iteration racing
    an append raises "deque mutated during iteration" in the READER."""

    __slots__ = ("alpha", "ema", "n", "_win", "_win_lock")

    def __init__(self, window: int = 64, alpha: float = 0.2):
        self.alpha = float(alpha)
        self.ema: "float | None" = None
        self.n = 0
        self._win = deque(maxlen=int(window))
        self._win_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._win)

    def observe(self, seconds: float) -> None:
        dt = max(float(seconds), 0.0)
        with self._win_lock:
            self.ema = dt if self.ema is None else (
                self.alpha * dt + (1 - self.alpha) * self.ema)
            self._win.append(dt)
            self.n += 1

    def _copy(self) -> "list[float]":
        with self._win_lock:
            return list(self._win)

    def percentile(self, q: float) -> "float | None":
        data = self._copy()
        if not data:
            return None
        return float(np.percentile(np.asarray(data, np.float64), q))

    def p50(self) -> "float | None":
        return self.percentile(50)

    def p95(self) -> "float | None":
        return self.percentile(95)

    def recent_median(self, tail: int = 9,
                      min_obs: int = 3) -> "float | None":
        """Median of the last ``tail`` observations (None below
        ``min_obs``) — the short-window robustness primitive behind
        `RankLatency.speed_weight`: one outage spike is a single
        outlier the median ignores, while sustained slowness dominates
        the window within ~tail/2 observations."""
        data = self._copy()
        if len(data) < min_obs:
            return None
        return float(np.median(np.asarray(data[-tail:], np.float64)))

    def snapshot(self) -> "dict[str, float]":
        """{ema_s, p50_s, p95_s, n} rounded to 4 places — empty dict
        before the first observation."""
        with self._win_lock:
            data = list(self._win)
            ema, n = self.ema, self.n
        if not data:
            return {}
        arr = np.asarray(data, np.float64)
        return {
            "ema_s": round(float(ema), 4),
            "p50_s": round(float(np.percentile(arr, 50)), 4),
            "p95_s": round(float(np.percentile(arr, 95)), 4),
            "n": n,
        }


class RankLatency:
    """Per-rank submission-latency tracker: EMA + rolling p50/p95 of the
    time between successive gradient submissions from each rank — one
    `RequestLatency` window per rank, fed inter-arrival intervals.

    The audit trail behind the quorum/deadline decisions: after a run,
    ``fault_stats["rank_latency"]`` shows which rank was the straggler
    the deadline fired against.  Host wall-clock only; observed at
    admission time on the PS."""

    def __init__(self, window: int = 64, alpha: float = 0.2):
        self.alpha = float(alpha)
        self._window = int(window)
        self._last: "dict[int, float]" = {}
        self._req: "dict[int, RequestLatency]" = {}

    def observe(self, rank: "int | None", now: "float | None" = None) -> None:
        if rank is None:
            return
        now = time.monotonic() if now is None else float(now)
        prev = self._last.get(rank)
        self._last[rank] = now
        if prev is None:
            return  # first submission: no interval yet
        self._req.setdefault(
            rank, RequestLatency(self._window, self.alpha)).observe(
                max(now - prev, 0.0))

    def snapshot(self) -> "dict[int, dict[str, float]]":
        return {rank: req.snapshot()
                for rank, req in sorted(self._req.items()) if len(req)}

    def fleet_p95(self, min_obs: int = 4) -> "float | None":
        """The fleet's typical-rank tail latency: the MEDIAN over ranks
        of each rank's inter-submission p95 (ranks with fewer than
        ``min_obs`` intervals abstain; None with no qualified rank).
        One straggler must not drag it up (the deadline exists to close
        fills without it); a uniformly slow fleet moves it, so the
        derived deadline stretches."""
        per_rank = [req.p95() for req in self._req.values()
                    if len(req) >= min_obs]
        if not per_rank:
            return None
        return float(np.median(np.asarray(per_rank)))

    def _recent_median(self, rank, tail: int = 9,
                       min_obs: int = 3) -> "float | None":
        """Median of the rank's last ``tail`` inter-submission intervals
        (None below ``min_obs``): "persistently slower" means a majority
        of recent intervals, not one bad one."""
        req = self._req.get(rank)
        if req is None:
            return None
        return req.recent_median(tail=tail, min_obs=min_obs)

    def speed_weight(self, rank: "int | None", *,
                     floor: float = 0.25) -> float:
        """Contribution weight for heterogeneous fleets: a rank
        PERSISTENTLY slower than the fleet's median pace weighs (fleet
        median / its recent median), floored at ``floor``.  Ranks at or
        above the median pace (and unknown or too-new ranks, or a
        single-rank fleet) weigh 1.0."""
        if rank is None:
            return 1.0
        mine = self._recent_median(rank)
        if mine is None:
            return 1.0
        peers = [m for r in self._req
                 for m in [self._recent_median(r)] if m is not None]
        if len(peers) < 2:
            return 1.0
        med = float(np.median(np.asarray(peers, np.float64)))
        if med <= 0.0 or mine <= med:
            return 1.0
        return max(float(floor), med / mine)

    def forget(self, rank) -> None:
        """Drop a departed rank's latency state entirely (a rejoining
        rank re-warms from scratch)."""
        self._last.pop(rank, None)
        self._req.pop(rank, None)


def format_fault_stats(fs: "dict[str, Any]") -> str:
    """One-line rendering of a ``fault_stats`` snapshot (the JAX
    package's ``format_fault_stats``): evictions, reconnects, quarantined
    or dropped frames and gradients, the transport's flow-control counts,
    with zero-valued counters elided so a clean run renders as
    ``clean``."""
    parts = [f"{key}={fs[key]}" for key in _FAULT_COUNTERS if fs.get(key)]
    if fs.get("quarantined_ranks"):
        parts.append(f"quarantined_ranks={fs['quarantined_ranks']}")
    if fs.get("sdc_first_leaf"):
        parts.append(f"sdc_first_leaf={fs['sdc_first_leaf']!r}")
    if fs.get("rollbacks"):
        parts.append(f"rollbacks={len(fs['rollbacks'])}")
    drops = fs.get("dropped_queue_full")
    if drops:
        total = sum(drops.values())
        parts.append(f"dropped_queue_full={total} "
                     f"(ranks {sorted(drops)})")
    if fs.get("evicted_ranks"):
        parts.append(f"evicted_ranks={fs['evicted_ranks']}")
    if fs.get("groups"):
        parts.append(f"groups={sorted(fs['groups'])}")
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
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir,
                                          f"trace-{os.getpid()}.json"))


_NO_SPAN = contextlib.nullcontext()


def annotate(name: str, args=None):
    """A named host span, ``torch.profiler.record_function(name, args)``
    (``args`` as a string), while a ``torch.profiler`` session records; the
    shared no-op context otherwise, after one check of the profiler's
    flag.  Open one around a phase, never one per leaf or per bucket: an
    open span costs microseconds of host time."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(
        name, None if args is None else str(args))


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
