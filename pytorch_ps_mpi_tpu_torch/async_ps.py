"""Asynchronous parameter server — AsySG-InCon, on PyTorch.

Counterpart of `pytorch_ps_mpi_tpu/async_ps.py`, its single-host
deployment.  The reference designs (but never codes) an async PS in its
README (algorithm AsySG-InCon, arXiv:1506.08272): rank 0 receives
gradients from any source until a quota is met, **sums** them, applies one
optimizer step and re-broadcasts the parameters with *inconsistent reads*
— workers may read parameters mid-update.

* Every worker is a host thread with its own ``torch.cuda.Stream`` on its
  device: the thread posts the gradient and encode kernels on that stream
  and the card runs them beside the other workers' and the PS's, the
  analogue of one MPI rank.  A list of devices that repeats one card (a
  PS and four workers on ``[cuda:0] * 5``) is legal, as in JAX.
* The PS owns the canonical params and optimizer state on its device (the
  thread that calls `run`, on its current stream); encoded gradients
  arrive over a bounded host queue (the any-source receive).
* After a fill the PS decodes and sums (one grouped decode launch for
  blockq and bf16), updates and **publishes the new params leaf by
  leaf** into a shared dict; workers snapshot it leaf by leaf with no
  lock, so a read during an update sees a mix of old and new leaves —
  AsySG-InCon's inconsistent read.

The card adds two hand-offs JAX tracks for itself and the CUDA caching
allocator does not:

* **worker -> PS**: a queued gradient carries an event recorded on the
  worker's stream after its encode; the PS's stream waits on it before
  reading the codes, and each code tensor is marked used on the PS's
  stream (``record_stream``), so the allocator does not hand its memory
  back to the worker while the PS still reads it;
* **PS -> worker**: the PS records an event after each update and
  publishes it before the leaves; a worker reads the leaves, then the
  event, and its stream waits on it, so every leaf it read is complete;
  each leaf it reads is marked used on its stream, so a leaf the PS drops
  is not reused while the worker's kernels still read it.

Staleness is first class: each gradient is tagged with the parameter
version it was computed from, and every update records the staleness of
the gradients it consumed.  Each worker encodes in the JAX package's
element order (`utils.interop.jax_order`), so the codes equal the JAX
package's and the PS's decoded sums come back in the port's layout.
"""

from __future__ import annotations

import contextlib
import queue
import sys
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable

import numpy as np
import torch

from .errors import FleetDeadError, NotCompiledError, WorkerFailedError
from .ops.codecs import Codec, get_codec
from .optim.schedules import (hyper_for_checkpoint, hyper_from_checkpoint,
                              resolve_hyper)
from .parallel.mesh import record_event, resolve_device
from .ps import init_ps_core
from .utils.bytes import bytes_of, host_numpy
from .utils.flatten import tree_flatten, tree_leaves, tree_map, tree_unflatten
from .utils.interop import from_jax_order, jax_order, to_jax_order

# Adaptive fill-deadline bounds: the live-p95-derived deadline never
# shrinks below this floor (a sub-millisecond deadline would close every
# fill at bare quorum on scheduler noise alone).
_ADAPTIVE_DEADLINE_FLOOR = 0.005


def make_worker_step(loss_fn: Callable, code: Codec, grad_transform=None,
                     orders=None):
    """The per-worker program — grad + per-leaf encode:
    ``worker_step(params, batch) -> (loss, codes)``.  ``orders`` maps a
    leaf name to its `jax_order` permutation (the codec encodes each
    gradient in the JAX package's element order).

    ``grad_transform`` (a gradient tree -> gradient tree map) is the
    Byzantine-fault injection point (`FaultPlan.byzantine_transform`): it
    runs on the RAW gradients before encoding, so the attack rides any
    codec.  None (the default) is the honest program."""
    orders = orders or {}

    def worker_step(params, batch):
        leaves = OrderedDict((n, p.detach().requires_grad_())
                             for n, p in params.items())
        loss = loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
        with torch.no_grad():
            grads = OrderedDict(zip(leaves, grads))
            if grad_transform is not None:
                grads = grad_transform(grads)
            codes = OrderedDict(
                (n, code.encode(to_jax_order(g, orders.get(n))))
                for n, g in grads.items())
        return loss.detach(), codes

    return worker_step


class _Published:
    """The broadcast surface: a leaf-wise-updated params dict, a version
    counter and, on the card, the event that completes the newest update.
    Readers take no lock (inconsistent reads by design); the version is
    bumped only after every leaf of an update has landed, so ``staleness
    = writer.version - read_version`` is a *lower bound* on how stale a
    mixed read is.  The event is published before the leaves and read
    after them, so it completes every leaf a reader saw."""

    def __init__(self, params, event=None):
        self.leaves = dict(params)
        self.version = 0
        self.event = event

    def publish(self, new_params, event=None) -> None:
        if event is not None:
            self.event = event
        for n, p in new_params.items():   # leaf-by-leaf: mid-update readers
            self.leaves[n] = p            # see a mix of versions (InCon)
        self.version += 1

    def snapshot(self):
        v = self.version
        params = OrderedDict((n, self.leaves[n]) for n in self.leaves)
        return params, v, self.event


def _stack_codes(codes_list):
    """The codes of a fill, each leaf gaining a leading contributor dim."""
    flats, treedef = zip(*(tree_flatten(c) for c in codes_list))
    return tree_unflatten(treedef[0], [torch.stack(xs) for xs in
                                       zip(*flats)])


def _use_on(tensors, stream) -> None:
    """Mark every card tensor of ``tensors`` used on ``stream``: the
    allocator then keeps its memory until ``stream``'s work queued at its
    free has run."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            t.record_stream(stream)


class AsyncPS:
    """Host-driven asynchronous parameter server (AsySG-InCon).

    Usage::

        opt = AsyncSGD(model_named_params, lr=0.1, quota=4)
        opt.compile_step(loss_fn)                  # loss_fn(params, batch)
        history = opt.run(batch_fn, steps=500)

    ``batch_fn(rank, it) -> batch`` supplies worker ``rank``'s ``it``-th
    local batch (numpy or tensors; each worker moves it to its device).

    ``devices`` is a list of `torch.device` (or strings): the first holds
    the PS, the rest run one worker each (all of them with
    ``ps_is_worker=True``; a single device is shared by the PS and one
    worker).  It defaults to every visible card and raises when there is
    none; the CPU is used only when the caller passes CPU devices.
    ``loss_fn`` is called from every worker thread at once: the port's
    loss factories (`models.make_classifier_loss`, `make_lm_loss`) run a
    per-thread copy of their module.

    ``quota`` is the number of gradients the PS consumes per update;
    gradients left in the queue when a quota fills are consumed — stale —
    by later updates, exactly the inconsistency the algorithm tolerates.
    """

    # The PS is rank 0 of a world of one process (the checkpoint helpers
    # write from rank 0 and meet at a barrier only at world > 1).
    rank = 0
    world_size = 1

    def __init__(self, named_params, *, optim: str = "sgd",
                 code: Codec | str | None = None, quota: int | None = None,
                 devices=None, ps_is_worker: bool = False,
                 staleness_weighting: bool = False,
                 max_staleness: int | None = None,
                 skip_nonfinite: bool = False,
                 aggregate: str = "mean", trim_k: int | None = None,
                 quorum: int | None = None, fill_deadline: float = 0.0,
                 anomaly_z: float | None = None,
                 adaptive_deadline: bool = False,
                 latency_weighting: bool = False,
                 credit_window: int = 0,
                 fault_plan=None, **hyper):
        from .ops.robust import ROBUST_REDUCERS, RankScoreboard
        from .utils.timing import RankLatency

        self.optim = optim
        self.code = get_codec(code)
        # Robust aggregation (`ops.robust`): how a fill's contributions
        # combine.  "mean" is the staleness-weighted sum (renormed to the
        # fill target under quorum short-fills); the others are the
        # Byzantine-robust reducers.
        if aggregate not in ROBUST_REDUCERS:
            raise ValueError(f"unknown aggregate {aggregate!r}; have "
                             f"{list(ROBUST_REDUCERS)}")
        self.aggregate = aggregate
        if trim_k is not None and trim_k < 1:
            raise ValueError(f"trim_k must be >= 1, got {trim_k}")
        self.trim_k = trim_k
        # Straggler-tolerant quorum fills: once `quorum` contributions are
        # in and `fill_deadline` seconds have passed since the fill
        # started, the update proceeds with what it has (renormalized to
        # the fill target) instead of stalling on the slowest rank.
        if quorum is not None and quorum < 1:
            raise ValueError(f"quorum must be >= 1, got {quorum}")
        if fill_deadline < 0:
            raise ValueError(
                f"fill_deadline must be >= 0, got {fill_deadline}")
        self.quorum = quorum
        self.fill_deadline = float(fill_deadline)
        # Adaptive fill-deadline: each fill's deadline is
        # ``min(fill_deadline, 1.5 * fleet_p95)`` — the configured value
        # becomes a ceiling.
        if adaptive_deadline and quorum is None:
            raise ValueError(
                "adaptive_deadline derives the quorum fill-deadline from "
                "live latencies; without a quorum no fill ever closes "
                "short, so the flag would be silently inert — set quorum "
                "(and a fill_deadline ceiling) or drop it")
        self.adaptive_deadline = bool(adaptive_deadline)
        # Heterogeneous-fleet admission: contributions from ranks
        # persistently slower than the fleet median are down-weighted by
        # their latency ratio (`RankLatency.speed_weight`).
        self.latency_weighting = bool(latency_weighting)
        # Per-rank anomaly scoring/quarantine (None = off, the default).
        self.anomaly_z = anomaly_z
        self._scoreboard = (RankScoreboard(anomaly_z)
                            if anomaly_z is not None else None)
        self._latency = RankLatency()
        # norm_clip's rolling median: recent admitted contribution norms.
        self._norm_window: deque = deque(maxlen=64)
        # Ranks that missed a quorum-shortened fill; their next admitted
        # gradient is the "late frame folded into a later fill".
        self._missed_ranks: set = set()
        # Non-linear reducers get their breakdown point PER CONTRIBUTOR:
        # each fill admits at most one contribution per rank; surplus
        # frames are held over for the next fill (bounded per rank, then
        # dropped + counted).
        self._rank_distinct = aggregate != "mean"
        self._held: list = []
        # Staleness weighting: gradient i scales by 1/(1+s_i) before the
        # sum, applied to the *codes* (`Codec.scale_codes`) so the fused
        # decode-sum survives.
        self.staleness_weighting = staleness_weighting
        # Bounded-staleness admission: a gradient older than this many
        # versions is dropped (counted, never applied).
        if max_staleness is not None and max_staleness < 0:
            raise ValueError(f"max_staleness must be >= 0, got {max_staleness}")
        self.max_staleness = max_staleness
        # Non-finite quarantine: checked per received gradient
        # (`ps.tree_all_finite`), dropped + counted.
        self.skip_nonfinite = skip_nonfinite
        # The bounded gradient queue's size (0 = the deployment default):
        # its capacity bounds staleness.
        if credit_window < 0:
            raise ValueError(
                f"credit_window must be >= 0, got {credit_window}")
        self.credit_window = int(credit_window)
        self.fault_plan = fault_plan
        # Overload-injector counter lock: flood/burst bumps come from
        # concurrent worker threads, while `_bump` stays lock-free for the
        # single-consumer serve loop.
        self._overload_lock = threading.Lock()
        # Admission/fault counters, with every key of the JAX package's
        # (the transport, serve and bucket-stream counters stay 0 in the
        # in-process deployment); merged into the run history as
        # ``history["fault_stats"]``.  Only the serve loop writes them,
        # but for the worker-side overload bumps under `_overload_lock`.
        self.fault_stats: dict[str, Any] = {
            "stale_dropped": 0, "nonfinite_dropped": 0,
            "quorum_fills": 0, "late_folded": 0, "robust_clipped": 0,
            "quarantined_drops": 0, "surplus_dropped": 0,
            "breakdown_floor_stalls": 0, "floor_relaxed_admits": 0,
            "deadline_adapted": 0, "latency_weighted": 0,
            "deadline_expired": 0, "credits_stalled": 0,
            "shed_data_frames": 0, "admission_shed": 0,
            "flood_injected": 0, "burst_injected": 0, "slow_consumed": 0,
            "sentinel_checks": 0, "sentinel_trips": 0,
            "race_checks": 0, "race_trips": 0,
            "parm_encodes": 0, "parm_fanout_reuse": 0,
            "parm_unchanged": 0, "segments_sent": 0,
            "decode_offloaded": 0,
            "buckets_sent": 0, "buckets_filled": 0,
            "bucket_partial_timeouts": 0, "fused_encodes": 0,
            "reads_served": 0, "read_shed": 0, "delta_frames": 0,
            "subs_active": 0, "reads_stalled": 0,
            "infer_requests": 0, "infer_shed": 0,
            "parm_bytes_raw": 0, "parm_bytes_wire": 0,
            "delta_hits": 0, "delta_misses": 0,
            "fused_sync_encodes": 0}

        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
            if not devices:
                resolve_device("cuda")  # raises: no card visible
        devices = [resolve_device(d) for d in devices]
        if not devices:
            raise ValueError("devices must name at least one device")
        self.ps_device = devices[0]
        if len(devices) == 1:
            self.worker_devices = [devices[0]]
        else:
            self.worker_devices = (list(devices) if ps_is_worker
                                   else list(devices[1:]))
        self.num_workers = len(self.worker_devices)
        self.quota = int(quota) if quota is not None else self.num_workers
        if self.quota < 1:
            raise ValueError(f"quota must be >= 1, got {self.quota}")
        if self.quorum is not None and self.quorum > self.quota:
            raise ValueError(
                f"quorum ({self.quorum}) cannot exceed the quota "
                f"({self.quota}) — it is the minimum fill, not a second "
                f"target")
        # A trim/median fill below its breakdown size silently degenerates
        # to a plain mean: trimmed_mean needs every fill >= 2k+1
        # contributions, median >= 3.
        min_fill = {"trimmed_mean": 2 * (1 if trim_k is None else trim_k)
                    + 1, "median": 3}.get(aggregate)
        if min_fill is not None:
            floor = self.quota if self.quorum is None else self.quorum
            if floor < min_fill:
                raise ValueError(
                    f"aggregate={aggregate!r} needs every fill to keep >= "
                    f"{min_fill} contributions (2*trim_k+1 for "
                    f"trimmed_mean, 3 for median), but "
                    f"{'quorum' if self.quorum is not None else 'quota'}="
                    f"{floor} allows smaller fills, where the rule "
                    f"silently degenerates to a plain mean — raise the "
                    f"fill floor or use norm_clip, whose influence bound "
                    f"holds at any fill size")
        # The same floor is re-checked at fill time (`_shrink_floor`).
        self._min_fill = 1 if min_fill is None else min_fill
        self._floor_binding = False
        if self.fill_deadline > 0 and self.quorum is None:
            raise ValueError(
                "fill_deadline only takes effect with a quorum (fills "
                "without one always wait for the full target); set "
                "quorum or drop fill_deadline")

        def place(x):
            return torch.as_tensor(x).detach().to(self.ps_device, copy=True)

        self.params, self.state, self.hyper, self._update_fn = init_ps_core(
            named_params, optim, hyper, place)
        # The codec's element order per leaf (only where it differs from
        # the port's layout and the wire depends on it), and each leaf's
        # shape and dtype as the codec sees it.
        self._orders = {}
        if self.code.ordered:
            for n, p in self.params.items():
                order = jax_order(n, p.shape)
                if order is not None:
                    self._orders[n] = order
        self._metas = OrderedDict(
            (n, (to_jax_order(p, self._orders.get(n)).shape, p.dtype))
            for n, p in self.params.items())

        self._loss_fn: Callable | None = None
        self._worker_fn = None
        self._worker_fn_byz = None
        self._itemwise = False
        self.timings: list[dict[str, float]] = []
        # Gradients the workers computed over every run: consumed, dropped
        # at admission, or left in flight when a run ended (the kernels'
        # launch counts are per computed gradient).
        self.grads_computed = 0
        # Test/diagnostic knob: workers wait for their own gradient to be
        # consumed before pulling again, making 1-worker runs
        # deterministic (sequential SGD).  Never the default: a barrier.
        self._lockstep = False

    # -- program construction -------------------------------------------------

    def compile_step(self, loss_fn: Callable) -> None:
        """Bind ``loss_fn(params, batch) -> loss`` and build the per-worker
        grad+encode step (the attacked rank's own under a Byzantine
        fault plan).  Aux/BatchNorm state is a sync-PS feature: the async
        variant mirrors the reference pseudo-code, plain params only.
        PyTorch runs eagerly, so nothing is traced here."""
        self._loss_fn = loss_fn
        self._worker_fn = make_worker_step(loss_fn, self.code,
                                           orders=self._orders)
        self._worker_fn_byz = None
        plan = self.fault_plan
        if plan is not None and getattr(plan, "byzantine_rank",
                                        None) is not None:
            self._worker_fn_byz = make_worker_step(
                loss_fn, self.code,
                plan.byzantine_transform(plan.byzantine_rank),
                orders=self._orders)
        # Non-linear reducers (and anomaly scoring, which needs
        # per-contribution norms) need itemwise decodes; a codec that
        # cannot decode one contribution is refused here.
        from .ops.robust import check_reducer_codec

        self._itemwise = check_reducer_codec(
            self.aggregate, self.code,
            anomaly_scoring=self._scoreboard is not None)

    # -- the PS apply ---------------------------------------------------------

    def _from_wire(self, tree):
        """Decoded leaves in the codec's element order -> the port's
        layout (inverse-permuted views, no copy)."""
        return OrderedDict((n, from_jax_order(g, self._orders.get(n)))
                           for n, g in tree.items())

    def _update_all(self, params, state, d):
        new_params, new_state = OrderedDict(), OrderedDict()
        for n, p in params.items():
            h = resolve_hyper(self.hyper, state[n]["step"])
            new_params[n], new_state[n] = self._update_fn(p, d[n], state[n],
                                                          **h)
        return new_params, new_state

    def _apply_fn(self, params, state, stacked_codes, weights=None):
        """The linear apply: the fill's codes (every leaf with a leading
        contributor dim), scaled by ``weights`` when given (staleness
        damping, quorum renormalization, scoreboard and latency
        down-weights, all on the codes), decoded and **summed** — one
        grouped launch for blockq and bf16 — then the update.  Returns
        ``(new_params, new_state)``."""
        if weights is not None:
            w = torch.as_tensor(weights, dtype=torch.float32)
            stacked_codes = OrderedDict(
                (n, self.code.scale_codes(c, w))
                for n, c in stacked_codes.items())
        d = self._from_wire(self.code.decode_sum_leaves(stacked_codes,
                                                        self._metas))
        return self._update_all(params, state, d)

    def _decode_each(self, stacked_codes):
        """Every contribution decoded on its own (one grouped launch each
        for blockq and bf16): name -> ``[n, *shape]`` in the codec's
        element order and the parameter's dtype."""
        first = tree_leaves(next(iter(stacked_codes.values())))[0]
        items = [self.code.decode_sum_leaves(OrderedDict(
            (n, tree_map(lambda x, i=i: x[i:i + 1], c))
            for n, c in stacked_codes.items()), self._metas)
            for i in range(first.shape[0])]
        return OrderedDict((n, torch.stack([it[n] for it in items]))
                           for n in self._metas)

    def _apply_robust_fn(self, params, state, stacked_codes, weights,
                         n_target, clip_norm):
        """The decode-then-reduce apply: every contribution decoded to
        dense, robust-reduced (`ops.robust.robust_reduce`), then the
        update.  Returns ``(new_params, new_state, info)``."""
        from .ops.robust import robust_reduce

        reduced, info = robust_reduce(
            self.aggregate, self._decode_each(stacked_codes), weights,
            n_target=n_target, trim_k=self.trim_k, clip_norm=clip_norm)
        new_params, new_state = self._update_all(params, state,
                                                 self._from_wire(reduced))
        return new_params, new_state, info

    def _norm_fn(self, codes) -> torch.Tensor:
        """Global L2 norm of ONE submission's decoded gradient — the
        scoring probe for quarantined ranks, whose submissions are dropped
        before the apply ever sees them (recovery must stay observable)."""
        decoded = self.code.decode_sum_leaves(OrderedDict(
            (n, tree_map(lambda x: x[None], c)) for n, c in codes.items()),
            self._metas)
        sq = torch.zeros((), dtype=torch.float32, device=self.ps_device)
        for d in decoded.values():
            sq = sq + torch.sum(d.to(torch.float32) ** 2)
        return torch.sqrt(sq)

    def _bump(self, key: str, n: int = 1) -> None:
        self.fault_stats[key] += n

    def _admit(self, codes, staleness, loss) -> "str | None":
        """Admission control for one received gradient: None to admit, or
        the fault_stats key it was rejected under."""
        if (self.max_staleness is not None
                and staleness > self.max_staleness):
            return "stale_dropped"
        if self.skip_nonfinite:
            from .ps import tree_all_finite
            if not (np.isfinite(float(loss)) and tree_all_finite(codes)):
                return "nonfinite_dropped"
        return None

    def _shrink_floor(self, target: int, cause: str) -> int:
        """Clamp runtime fill-target shrinkage (quarantine) to the active
        reducer's breakdown size: the fill HOLDS at the breakdown size,
        topping up with repeat contributions from eligible ranks while
        fewer than that remain (`_repeat_allowed`), instead of silently
        degenerating to a plain mean.  Logged once per episode and
        counted in ``breakdown_floor_stalls``."""
        if target >= self._min_fill:
            self._floor_binding = False
            return target
        if not self._floor_binding:
            self._floor_binding = True
            self._bump("breakdown_floor_stalls")
            print(f"async PS: {cause} would shrink the fill target to "
                  f"{target}, below aggregate={self.aggregate!r}'s "
                  f"breakdown size {self._min_fill} — holding the fill "
                  f"at {self._min_fill} (topping up with repeat "
                  f"contributions from eligible ranks while fewer than "
                  f"{self._min_fill} remain) instead of degenerating to "
                  f"a plain mean",
                  file=sys.stderr)
        return self._min_fill

    def _fill_target(self) -> int:
        """The number of contributions a fill aims for: the quota, minus
        quarantined ranks under rank-distinct fills, never below the
        reducer's breakdown size (`_shrink_floor`)."""
        target = self.quota
        if self._rank_distinct and self._scoreboard is not None:
            nq = len(self._scoreboard.quarantined_ranks())
            target = self._shrink_floor(max(1, target - nq), "quarantine")
        return target

    def _eligible_rank_count(self) -> int:
        """Ranks that can legitimately contribute to a fill right now."""
        n = self.num_workers
        if self._scoreboard is not None:
            n -= len(self._scoreboard.quarantined_ranks())
        return max(0, n)

    def _repeat_allowed(self) -> bool:
        """Rank-distinct fills admit a REPEAT contribution only while the
        breakdown floor is binding and fewer eligible distinct ranks
        remain than the floor requires (counted in
        ``floor_relaxed_admits``)."""
        return (self._rank_distinct and self._floor_binding
                and self._eligible_rank_count() < self._min_fill)

    def _take_held(self, ranks) -> "tuple | None":
        """Pop the first held-over frame whose rank is not yet in this
        fill (rank-distinct fills only); under a binding breakdown floor
        with too few eligible ranks, a repeat frame is eligible too."""
        for i, item in enumerate(self._held):
            if item[2] is None or item[2] not in ranks:
                return self._held.pop(i)
        if self._held and self._repeat_allowed():
            return self._held.pop(0)
        return None

    def _hold_surplus(self, item) -> None:
        """Park a same-rank surplus frame for the next fill; a rank may
        hold at most 2 (newer frames are then dropped + counted)."""
        rank = item[2]
        if sum(1 for it in self._held if it[2] == rank) >= 2:
            self._bump("surplus_dropped")
        else:
            self._held.append(item)

    # -- the shared fill-admission loop ---------------------------------------

    def _fleet_ranks(self) -> "set[int]":
        """The ranks a quorum-shortened fill may have left behind (they
        get late-fold credit when their frame lands).  The TCP server
        overrides this with its live-fleet accounting."""
        return set(range(self.num_workers))

    def _drop_before_admit(self, rank) -> bool:
        """Deployment-specific pre-admission drop, checked after the
        rank-distinct gate: the TCP server drops evicted ranks' in-flight
        frames here.  True when the frame was dropped (and counted)."""
        return False

    def _check_fill_starved(self, n_filled: int, t0: float) -> None:
        """Deployment-specific starvation guard, called whenever a surplus
        frame is held back from a rank-distinct fill.  In-process, `run`
        refuses starving configurations eagerly (quota > num_workers);
        the TCP server fails loudly when its connected fleet can never
        complete the fill."""

    def _at_fill_boundary(self) -> None:
        """Deployment-specific hook at the top of every fill, before any
        gradient of the next update is consumed, so the parameters and
        optimizer state are exactly "N updates applied".  In-process it
        does nothing; the TCP server writes an armed coordinated-snapshot
        cut here (SNAP markers), the one point where a checkpoint is
        provably at a whole-update cut."""

    def _fill_gradients(self, receive, drain_nowait, *, current_version,
                        base_timeout: float = 0.5, on_consumed=None):
        """Receive gradients until the fill target is met — or, with a
        quorum configured, until quorum + deadline close the fill short.
        The one fill-admission loop of the PS.

        ``receive(timeout) -> item | None``: one bounded receive attempt
        (None on a quiet interval; raises when the fleet is gone).
        ``drain_nowait() -> item | None``: a non-blocking drain once the
        fill deadline has expired.  ``current_version()``: the published
        version, for staleness.  ``on_consumed(rank)``: called for frames
        consumed but never applied (quarantined or rejected), so lockstep
        workers still see their ack.

        Items are ``(codes, version, rank, loss)``, or from the
        hierarchy's AGGR frames ``(codes, version, rank, loss, contrib)``,
        where ``contrib`` is how many worker gradients the pre-reduced
        frame stands for (a plain frame counts 1).  Returns
        ``(codes_list, stalenesses, losses, ranks, contribs, fill_target,
        short)``."""
        from .transport import Deadline

        self._at_fill_boundary()
        # The quorum fill budget, armed at fill start.
        fill_dl = Deadline(self._effective_deadline())
        t0 = time.perf_counter()
        codes_list: list = []
        stalenesses: list = []
        losses: list = []
        ranks: list = []
        contribs: list = []
        short = False
        while len(codes_list) < self._fill_target():
            # Held-over surplus frames (rank-distinct fills) are this
            # fill's first supply.
            item = self._take_held(ranks)
            quorum_met = (self.quorum is not None
                          and len(codes_list) >= min(self.quorum,
                                                     self._fill_target()))
            if item is not None:
                pass
            elif quorum_met and fill_dl.expired():
                # Deadline expired: drain what is already queued, then
                # proceed with the contributors we have.
                item = drain_nowait()
                if item is None:
                    short = True
                    break
            else:
                timeout = base_timeout
                if quorum_met:
                    timeout = fill_dl.timeout(floor=0.001,
                                              cap=base_timeout)
                item = receive(timeout)
                if item is None:
                    continue
            codes, version, rank, loss = item[:4]
            if (self._rank_distinct and rank is not None
                    and rank in ranks):
                # One contribution per rank per fill (a fast Byzantine
                # rank must not occupy two slots and out-vote the trim),
                # but for a binding breakdown floor with too few eligible
                # ranks.
                if self._repeat_allowed():
                    self._bump("floor_relaxed_admits")
                else:
                    self._hold_surplus(item)
                    self._check_fill_starved(len(codes_list), t0)
                    continue
            if self._drop_before_admit(rank):
                continue
            # Clamp: a gradient computed against a NEWER version than the
            # serving counter (a PS resumed from an older checkpoint) is
            # at worst fresh; staleness -1 would divide by zero in the
            # 1/(1+s) weight.
            staleness = max(0, current_version() - version)
            if (self._scoreboard is not None
                    and self._scoreboard.is_quarantined(rank)):
                # Quarantined rank: drop + count, but keep SCORING its
                # submissions so recovery stays observable.
                self._bump("quarantined_drops")
                self._scoreboard.observe(rank, float(self._norm_fn(codes)))
                if on_consumed is not None:
                    on_consumed(rank)
                continue
            rejected = self._admit(codes, staleness, loss)
            if rejected is not None:
                self._bump(rejected)
                if on_consumed is not None:
                    on_consumed(rank)
                continue
            self._latency.observe(rank)
            if rank in self._missed_ranks:
                # A straggler's frame arriving after its fill closed folds
                # into THIS fill.
                self._missed_ranks.discard(rank)
                self._bump("late_folded")
            codes_list.append(codes)
            stalenesses.append(staleness)
            losses.append(loss)
            ranks.append(rank)
            contribs.append(float(item[4]) if len(item) > 4 else 1.0)
        fill_target = self._fill_target()
        if short:
            self._bump("quorum_fills")
            self._missed_ranks |= self._fleet_ranks() - set(ranks)
        return (codes_list, stalenesses, losses, ranks, contribs,
                fill_target, short)

    def _effective_deadline(self) -> float:
        """This fill's quorum deadline: ``fill_deadline``, or with
        ``adaptive_deadline`` the live fleet latency p95 times 1.5,
        clamped to ``fill_deadline`` as a ceiling (counted in
        ``deadline_adapted`` when it tightens)."""
        if not self.adaptive_deadline:
            return self.fill_deadline
        p95 = self._latency.fleet_p95()
        if p95 is None:
            return self.fill_deadline  # no history yet: the ceiling
        adapted = min(self.fill_deadline,
                      max(1.5 * p95, _ADAPTIVE_DEADLINE_FLOOR))
        if adapted < self.fill_deadline:
            self._bump("deadline_adapted")
        return adapted

    def _contrib_weights(self, stalenesses, ranks,
                         contribs=None) -> np.ndarray:
        """Per-contribution damping: staleness (1/(1+s)) composed with the
        scoreboard's suspect down-weighting, the latency decay
        (``latency_weighting``) and, for the hierarchy's pre-reduced AGGR
        frames, the contributor multiplicity (a frame standing for 4
        worker gradients weighs 4x a plain one, so a group that filled
        short moves the root pro-rata); applied BEFORE the robust
        statistic.  float32, numpy, the products in the JAX package's
        order."""
        w = np.ones(len(stalenesses), np.float32)
        if self.staleness_weighting:
            w *= 1.0 / (1.0 + np.asarray(stalenesses, np.float32))
        if self._scoreboard is not None:
            w *= np.asarray([self._scoreboard.weight(r) for r in ranks],
                            np.float32)
        if self.latency_weighting:
            lw = np.asarray([self._latency.speed_weight(r) for r in ranks],
                            np.float32)
            slowed = int(np.sum(lw < 1.0))
            if slowed:
                self._bump("latency_weighted", slowed)
                w *= lw
        if contribs is not None:
            c = np.asarray(contribs, np.float32)
            if not np.all(c == 1.0):
                w = w * c
        return w

    def _apply_weighted(self, stacked, stalenesses, ranks, data,
                        n_target: "int | None" = None, contribs=None):
        """Reduce + update on already-stacked codes — the one aggregation
        entry point of the in-process and the TCP deployments.
        ``n_target`` is the fill target the contribution count
        renormalizes to (default: the quota); ``contribs`` the fill's
        per-frame contributor multiplicities."""
        n = len(stalenesses)
        n_target = self.quota if n_target is None else n_target
        w = self._contrib_weights(stalenesses, ranks, contribs)
        if self.staleness_weighting:
            data["mean_weight"] = float(w.mean())
        if self._itemwise:
            # Decode-then-reduce (robust reducers / anomaly scoring).
            clip = float("nan")
            if self.aggregate == "norm_clip" and self._norm_window:
                clip = float(np.median(np.asarray(self._norm_window)))
            new_params, new_state, info = self._apply_robust_fn(
                self.params, self.state, stacked, torch.from_numpy(w),
                float(np.float32(n_target)), clip)
            self._post_apply_scoring(ranks, info)
            return new_params, new_state
        # The linear path (fused decode-sum): staleness damping,
        # quarantine down-weights and the quorum renormalization all fold
        # into the per-code scale; the default configuration (mean, no
        # weighting, full fills) scales nothing.
        renorm = float(n_target) / n
        if renorm != 1.0:
            w = w * np.float32(renorm)
        if self.staleness_weighting or not np.all(w == 1.0):
            return self._apply_fn(self.params, self.state, stacked,
                                  torch.from_numpy(w))
        return self._apply_fn(self.params, self.state, stacked)

    def _post_apply_scoring(self, ranks, info) -> None:
        """Feed the robust apply's per-contribution norms and clip count
        into the counters, the norm_clip rolling window and the per-rank
        scoreboard (one host read)."""
        norms = host_numpy(info["contrib_norms"]).astype(np.float64)
        clipped = int(info["clipped"])
        if clipped:
            self._bump("robust_clipped", clipped)
        if self.aggregate == "norm_clip":
            self._norm_window.extend(float(x) for x in norms)
        if self._scoreboard is not None:
            for r, nm in zip(ranks, norms):
                if r is not None:
                    self._scoreboard.observe(r, float(nm))

    def _base_fault_snapshot(self) -> "dict[str, Any]":
        """fault_stats + the per-rank latency and anomaly scores."""
        snap = {k: (dict(v) if isinstance(v, dict) else v)
                for k, v in self.fault_stats.items()}
        lat = self._latency.snapshot()
        if lat:
            snap["rank_latency"] = lat
        if self._scoreboard is not None:
            snap.update(self._scoreboard.snapshot())
        return snap

    # -- the async loop -------------------------------------------------------

    def _worker_loop(self, rank: int, device, batch_fn, published: _Published,
                     grad_queue: "queue.Queue", stop: threading.Event,
                     consumed: list[int], computed: list[int],
                     errors: list):
        try:
            self._worker_body(rank, device, batch_fn, published, grad_queue,
                              stop, consumed, computed)
        except Exception as exc:  # propagate to the PS loop, don't die silent
            errors.append((rank, exc))

    def _worker_body(self, rank: int, device, batch_fn, published: _Published,
                     grad_queue: "queue.Queue", stop: threading.Event,
                     consumed: list[int], computed: list[int]):
        plan = self.fault_plan
        fn = self._worker_fn
        if (plan is not None and self._worker_fn_byz is not None
                and getattr(plan, "byzantine_rank", None) == rank):
            fn = self._worker_fn_byz
        stream = (torch.cuda.Stream(device) if device.type == "cuda"
                  else None)
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            try:
                self._worker_iterations(rank, device, fn, stream, batch_fn,
                                        published, grad_queue, stop,
                                        consumed, computed)
            finally:
                if stream is not None:
                    stream.synchronize()

    def _worker_iterations(self, rank, device, fn, stream, batch_fn,
                           published, grad_queue, stop, consumed, computed):
        it = 0
        plan = self.fault_plan
        while not stop.is_set():
            if plan is not None and plan.should_slow(rank):
                # Deterministic straggler: this rank pays the configured
                # delay before every gradient it computes (cut short by
                # the end of the run).
                stop.wait(plan.slow_delay_s)
            params, version, event = published.snapshot()
            if stream is not None:
                # The "broadcast receive": every leaf read is complete
                # once the newest update's event is, and none is reused
                # while this stream's kernels read it.
                if event is not None:
                    stream.wait_event(event)
                _use_on(params.values(), stream)
            params = OrderedDict((n, p.to(device, non_blocking=True))
                                 for n, p in params.items())
            batch = tree_map(
                lambda x: torch.as_tensor(x).to(device, non_blocking=True),
                batch_fn(rank, it))
            loss, codes = fn(params, batch)
            computed[rank] += 1  # this worker's own slot
            # The "send to rank 0": only the *encoded* grads move to the
            # PS's device (a no-op on a shared card).
            codes = tree_map(
                lambda x: x.to(self.ps_device, non_blocking=True), codes)
            loss = loss.to(self.ps_device, non_blocking=True)
            sent = None
            if stream is not None:
                sent = torch.cuda.Event()
                sent.record(stream)
            # Bounded put = MPI-send backpressure: a worker whose grad the
            # PS hasn't absorbed yet blocks here instead of racing ahead,
            # which bounds staleness.
            item = ((codes, version, rank, loss), sent)
            extra_flood, extra_burst = (
                plan.overload_extras(rank, it) if plan is not None
                else (0, 0))
            for i in range(1 + extra_flood + extra_burst):
                placed = False
                while not stop.is_set():
                    try:
                        grad_queue.put(item, timeout=0.05)
                        placed = True
                        break
                    except queue.Full:
                        continue
                if i >= 1 and placed:
                    # Overload injectors (flood_rank / burst_at): the same
                    # gradient enqueued again as extra supply, counted
                    # under the injector lock.
                    key = ("flood_injected" if i <= extra_flood
                           else "burst_injected")
                    with self._overload_lock:
                        self.fault_stats[key] += 1
            it += 1
            if self._lockstep:
                while consumed[rank] < it and not stop.is_set():
                    stop.wait(1e-4)

    def _receive_on_ps(self, wrapped):
        """The PS's half of the worker -> PS hand-off: its stream waits
        for the worker's send event, and every tensor of the item is
        marked used on it.  Returns the item."""
        item, sent = wrapped
        if sent is not None:
            stream = torch.cuda.current_stream(self.ps_device)
            stream.wait_event(sent)
            _use_on(tree_leaves(item), stream)
        return item

    def run(self, batch_fn: Callable[[int, int], Any], steps: int,
            log_every: int = 0) -> dict[str, Any]:
        """Run ``steps`` PS updates; returns the training history.

        History keys: ``losses`` (mean worker loss per update),
        ``staleness`` (mean gradient staleness per update), ``versions``,
        ``contributors``, ``grads_consumed``, ``grads_computed`` (consumed,
        dropped, or in flight at the end), ``wall_time`` and
        ``fault_stats``, plus per-update timing dicts in ``self.timings``
        (``comm_wait``: the fill; ``optim_step_time``: stacking, decode
        and update, queued on the card; ``isend_time``: the publish).
        Every worker thread is joined before it returns or raises."""
        if self._worker_fn is None:
            raise NotCompiledError("call compile_step(loss_fn) before run()")
        if self._lockstep and self.quota > self.num_workers:
            # Each lockstep worker holds exactly one outstanding grad, so a
            # quota above the worker count can never fill.
            raise ValueError(
                f"lockstep mode needs quota <= num_workers "
                f"({self.quota} > {self.num_workers})")
        if self._rank_distinct and self.quota > self.num_workers:
            raise ValueError(
                f"aggregate={self.aggregate!r} admits one contribution "
                f"per rank per fill: quota {self.quota} needs at least "
                f"that many workers (have {self.num_workers})")

        # The workers' streams start after the params' placement.
        published = _Published(self.params, record_event(self.ps_device))
        # Capacity: one in-flight grad per worker beyond what an update
        # drains, or the configured credit window, whichever is larger
        # (the bounded queue is the in-process flow control).
        grad_queue: "queue.Queue" = queue.Queue(
            maxsize=max(self.quota, self.num_workers, self.credit_window))
        stop = threading.Event()
        consumed = [0] * self.num_workers
        computed = [0] * self.num_workers
        errors: list = []

        workers = [
            threading.Thread(
                target=self._worker_loop,
                args=(r, d, batch_fn, published, grad_queue, stop, consumed,
                      computed, errors),
                daemon=True, name=f"async-ps-worker-{r}")
            for r, d in enumerate(self.worker_devices)
        ]
        for w in workers:
            w.start()

        def raise_worker_error():
            rank, exc = errors[0]
            raise WorkerFailedError(f"async worker {rank} failed") from exc

        def receive(timeout: float = 0.5):
            """One bounded receive attempt with worker-liveness checks: a
            dead worker surfaces as an error, never as a hang."""
            if errors:
                raise_worker_error()
            try:
                wrapped = grad_queue.get(timeout=timeout)
            except queue.Empty:
                if not any(w.is_alive() for w in workers):
                    raise FleetDeadError(
                        "all async workers exited without producing "
                        "gradients")
                return None
            plan = self.fault_plan
            if plan is not None and plan.slow_consumer > 0:
                # Overload injector: the PS consumes slower than the
                # workers produce, so the bounded queue's backpressure
                # engages.
                time.sleep(plan.slow_consumer)
                self._bump("slow_consumed")
            return self._receive_on_ps(wrapped)

        def drain_nowait():
            try:
                return self._receive_on_ps(grad_queue.get_nowait())
            except queue.Empty:
                return None

        def ack_consumed(rank):
            if rank is not None:
                consumed[rank] += 1

        history: dict[str, Any] = {
            "losses": [], "staleness": [], "versions": [],
            "contributors": [], "grads_consumed": 0,
        }
        t_start = time.perf_counter()
        try:
            for update in range(steps):
                if (self.fault_plan is not None
                        and self.fault_plan.should_kill_ps(update)):
                    from .utils.faults import SimulatedCrash
                    raise SimulatedCrash(
                        f"FaultPlan: PS killed before update {update}")
                data: dict[str, float] = {}
                # --- receive until quota, or until quorum + deadline
                # close the fill short.
                t0 = time.perf_counter()
                (batch_codes, stalenesses, losses, ranks, _contribs,
                 fill_target, _short) = self._fill_gradients(
                    receive, drain_nowait,
                    current_version=lambda: published.version,
                    on_consumed=ack_consumed)
                data["comm_wait"] = time.perf_counter() - t0

                # --- reduce + step (on the PS's device) -----------------
                t0 = time.perf_counter()
                with torch.no_grad():
                    # The losses go to the host ahead of the update, so
                    # reading them does not wait for it.
                    loss_host = torch.stack(
                        [l.to(torch.float32) for l in losses]).to(
                            "cpu", non_blocking=True)
                    losses_ready = record_event(self.ps_device)
                    stacked = OrderedDict(
                        (n, _stack_codes([c[n] for c in batch_codes]))
                        for n in batch_codes[0])
                    new_params, new_state = self._apply_weighted(
                        stacked, stalenesses, ranks, data,
                        n_target=fill_target)
                done = record_event(self.ps_device)
                data["optim_step_time"] = time.perf_counter() - t0

                # --- publish (the inconsistent-read broadcast) ----------
                t0 = time.perf_counter()
                self.params, self.state = new_params, new_state
                published.publish(new_params, done)
                # Acknowledge consumption only after the publish, so
                # lockstep workers always see the post-update params.
                for r in ranks:
                    consumed[r] += 1
                data["isend_time"] = time.perf_counter() - t0
                data["msg_bytes"] = float(bytes_of(batch_codes[0]))

                if losses_ready is not None:
                    losses_ready.synchronize()
                mean_loss = float(np.mean([float(x) for x in
                                           loss_host.numpy()]))
                mean_stale = float(np.mean(stalenesses))
                history["losses"].append(mean_loss)
                history["staleness"].append(mean_stale)
                history["versions"].append(published.version)
                history["contributors"].append(list(ranks))
                history["grads_consumed"] += len(batch_codes)
                self.timings.append(data)
                if log_every and (update + 1) % log_every == 0:
                    print(f"async update {update + 1:5d}  loss {mean_loss:.4f}"
                          f"  staleness {mean_stale:.2f}")
        finally:
            stop.set()
            # Every worker is joined: a thread left inside torch at
            # interpreter exit aborts the process.  Each loop checks
            # ``stop`` between gradients.
            for w in workers:
                w.join()
            # A late failure must not vanish with the threads — but never
            # mask an exception already propagating out of the try block.
            if errors and sys.exc_info()[0] is None:
                raise_worker_error()
            # Drop in-flight grads left behind: the run is over.
            while not grad_queue.empty():
                try:
                    grad_queue.get_nowait()
                except queue.Empty:  # pragma: no cover
                    break
        history["wall_time"] = time.perf_counter() - t_start
        history["grads_computed"] = sum(computed)
        self.grads_computed += sum(computed)
        history["fault_stats"] = self._base_fault_snapshot()
        return history

    # -- checkpoint / resume --------------------------------------------------

    def state_dict(self) -> dict:
        """Host-side snapshot (see `MPI_PS.state_dict`: numpy, bfloat16
        widened to float32); the async PS carries no aux state, so the
        entry is an empty tree, the on-disk format of the sync trainer's
        checkpoints."""
        return {
            "optim": self.optim,
            "hyper": hyper_for_checkpoint(self.hyper),
            "params": tree_map(host_numpy, self.params),
            "state": tree_map(host_numpy, self.state),
            "aux": {},
        }

    def load_state_dict(self, sd: dict) -> None:
        if sd["optim"] != self.optim:
            raise ValueError(
                f"checkpoint is for optim={sd['optim']!r}, this is {self.optim!r}")
        if set(sd["params"]) != set(self.params):
            missing = set(self.params) ^ set(sd["params"])
            raise ValueError(f"parameter name mismatch: {sorted(missing)}")
        self.hyper = hyper_from_checkpoint(sd["hyper"], self.hyper)

        def place(a, like):
            return torch.as_tensor(np.array(a)).to(self.ps_device, like.dtype)

        self.params = OrderedDict(
            (n, place(sd["params"][n], p)) for n, p in self.params.items())
        state = OrderedDict()
        for n, st in self.state.items():
            state[n] = {}
            for k, v in sd["state"][n].items():
                if k == "step":  # host counter (`optim.rules`)
                    state[n][k] = torch.tensor(int(np.asarray(v)),
                                               dtype=torch.int32)
                else:
                    state[n][k] = place(v, st.get(k, self.params[n]))
        self.state = state

    # -- conveniences ---------------------------------------------------------

    def named_parameters(self):
        return list(self.params.items())

    def print_summary(self):
        from .utils.timing import print_summary
        print_summary(self.timings)


class AsyncSGD(AsyncPS):
    """Async PS with the torch-parity SGD rule."""

    def __init__(self, named_params, **kwargs):
        kwargs["optim"] = "sgd"
        super().__init__(named_params, **kwargs)


class AsyncAdam(AsyncPS):
    """Async PS with the torch-parity Adam rule."""

    def __init__(self, named_params, **kwargs):
        kwargs["optim"] = "adam"
        super().__init__(named_params, **kwargs)


def dataset_batch_fn(x: np.ndarray, y: np.ndarray, batch_size: int,
                     *, seed: int = 0) -> Callable[[int, int], dict]:
    """Build a ``batch_fn`` sampling random minibatches per (rank, it) —
    each worker draws from its own deterministic stream
    (``SeedSequence([seed, rank, it])``, the JAX package's draws index for
    index), the analogue of per-rank data shards under ``mpirun``."""
    n = x.shape[0]

    def batch_fn(rank: int, it: int) -> dict:
        rng = np.random.default_rng(np.random.SeedSequence([seed, rank, it]))
        idx = rng.integers(0, n, size=batch_size)
        return {"x": x[idx], "y": y[idx]}

    return batch_fn


def lm_batch_fn(toks: np.ndarray, batch_size: int,
                *, seed: int = 0) -> Callable[[int, int], dict]:
    """`dataset_batch_fn` for token rows ``[n, S+1]``: each worker draws its
    own deterministic row sample and builds the {tokens, targets,
    positions} dict (`models.transformer.lm_batch`)."""
    from .models.transformer import lm_batch

    n = toks.shape[0]

    def batch_fn(rank: int, it: int) -> dict:
        rng = np.random.default_rng(np.random.SeedSequence([seed, rank, it]))
        idx = rng.integers(0, n, size=batch_size)
        return lm_batch(toks[idx])

    return batch_fn
