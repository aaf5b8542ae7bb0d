"""Hierarchical fault-contained aggregation: the group-local tier.

Counterpart of `pytorch_ps_mpi_tpu/shard/hierarchy.py`.  Every
robustness mechanism of the PS (quorum fills, rank-distinct trims, the
scoreboard's quarantine, eviction) runs at one level when the root sees
every worker directly, so straggler patience, Byzantine breakdown points
and fill-admission cost all scale with the fleet.  Li et al. (OSDI 2014)
interpose aggregation between workers and servers; Lian et al. (NeurIPS
2015, AsySG-InCon) show the bounded-staleness semantics survive such
re-timing.  This module is that middle tier:

* `LocalAggregator`: one per host group, a full `AsyncPSServer` facing
  its workers (the same HELO/PULL/GRAD protocol and fill-admission loop,
  with the group's own quorum, deadline, robust reducer and scoreboard)
  that instead of applying an update reduces each fill to one
  per-contributor-mean gradient, re-encodes it with the codec and
  forwards one ``AGGR`` frame to the root: a single PS or a `PSFleet`,
  whose `ShardPlan` splits the forward per shard;
* `GroupWorker`: a worker of a group, which redials a dead aggregator
  with bounded backoff (``agg_redials``) and, once the budget is spent,
  falls back to a direct root connection (``agg_failovers``; the root
  counts ``direct_fallbacks``);
* `Hierarchy`: the supervisor of G aggregators as threads of one
  process, which restarts one killed by a `FaultPlan` (``kill_agg_at``)
  on the same port with the same upstream rank and sequence
  (``agg_restarts``), so the group is reclaimed with no rank churn at
  either level.

The scale contract: a forward carries the group's per-contributor mean
and its contributor count n, and the root folds n into the contribution
weight (`AsyncPS._contrib_weights`), so a frame standing for 4 gradients
moves the root exactly as 4 plain GRADs would, and a group that closed
short moves it pro-rata.

On the card, the group's reduce is the root's linear path: under
``aggregate="mean"`` without scoring, the weights ``w / n`` are folded
into the codes (`Codec.scale_codes`) and one grouped decode-sum launch
(``block_dequant_sum`` for blockq) reduces the fill, then one
``block_quantize`` a leaf re-encodes the mean; the other reducers decode
each contribution and run `ops.robust.robust_reduce`.  The root and its
aggregators share the card's default stream, so each step is ordered
after the previous one, and every relayed parameter version lands in host
memory that the upstream pull decoded fresh (the serve loops never write
a served array in place).
"""

from __future__ import annotations

import dataclasses
import queue
import sys
import threading
import time
from collections import OrderedDict
from typing import Any, Callable

import numpy as np
import torch

from ..errors import AggregatorDeadError, FleetDeadError, NotCompiledError
from ..multihost_async import (AsyncPSServer, AsyncPSWorker, _wire_leaf,
                               tree_to_device, tree_to_host)
from ..parallel.mesh import record_event
from ..transport import TRANSPORT_ERRORS, Deadline
from ..utils.faults import SimulatedCrash
from ..utils.flatten import tree_map
from .router import ShardRouter

_DEAD = object()


class _Upstream:
    """The aggregator's root-facing side: one `AsyncPSWorker` link per
    root endpoint (1 = a plain PS, K = a `PSFleet`), each HELOing with the
    aggregator flag (group id and fill target) and, on a supervised
    restart, the previous incarnation's rank, so the root's per-rank
    accounting (eviction, seq dedup, scoreboard, the ``groups`` view)
    never churns.  For a fleet the `ShardPlan` is fetched from shard 0
    and every link's digest checked against it, as `ShardRouter` does."""

    def __init__(self, endpoints, *, group: int, target: int,
                 code=None, token=None, device=None,
                 assigned_rank: "int | None" = None,
                 initial_seq: int = 0,
                 io_timeout: float = 60.0, reconnect_retries: int = 8,
                 backoff_base: float = 0.1, backoff_max: float = 1.0,
                 pace_hook=None, pace: "int | None" = None,
                 op_deadline: "float | None" = None):
        endpoints = [(h, int(p)) for h, p in endpoints]
        if not endpoints:
            raise ValueError("the aggregator needs at least one root "
                             "endpoint")
        self.endpoints = endpoints
        # ``pace``: at most ``pace`` AGGR frames per observed root-version
        # epoch (`new_epoch`), on the session's credit machinery; a pace
        # stall is counted through ``pace_hook`` (the aggregator's
        # ``agg_paced``), a credit stall in the session's own
        # ``credits_stalled``.
        link_kw = dict(code=code, token=token, device=device,
                       io_timeout=io_timeout,
                       reconnect_retries=reconnect_retries,
                       backoff_base=backoff_base, backoff_max=backoff_max,
                       agg_group=group, agg_target=target,
                       pace_hook=pace_hook, max_pending=2,
                       op_deadline=op_deadline)
        self.links: "list[AsyncPSWorker]" = []
        self.plan = None
        try:
            if len(endpoints) == 1:
                h, p = endpoints[0]
                self.links.append(AsyncPSWorker(
                    h, p, assigned_rank=assigned_rank, **link_kw))
            else:
                h0, p0 = endpoints[0]
                first = AsyncPSWorker(h0, p0, expect_shard=0,
                                      assigned_rank=assigned_rank,
                                      **link_kw)
                self.links.append(first)
                for k, (h, p) in enumerate(endpoints[1:], start=1):
                    self.links.append(AsyncPSWorker(
                        h, p, expect_shard=k, assigned_rank=first.rank,
                        **link_kw))
                if first.num_shards != len(endpoints):
                    raise ValueError(
                        f"the root fleet has {first.num_shards} shards "
                        f"but {len(endpoints)} endpoints were given")
                self.plan = ShardRouter._fetch_plan(first)
                digest = self.plan.digest()
                for k, link in enumerate(self.links):
                    if link.plan_digest != digest:
                        raise ValueError(
                            f"root shard {k} advertises plan digest "
                            f"{link.plan_digest:#x}, the fleet's plan "
                            f"hashes to {digest:#x} — mixed fleets")
        except BaseException:
            self.close()
            raise
        self.rank = self.links[0].rank
        # A restarted aggregator re-presents the same rank upstream, so
        # its sequence continues past the dead incarnation's high-water:
        # a fresh counter would have the root drop its first forwards as
        # duplicates.
        for link in self.links:
            link._push_seq = int(initial_seq)
            if pace is not None:
                link._session.set_pace(pace)
        self._shard_names = (None if self.plan is None else
                             [self.plan.names_for(k)
                              for k in range(len(self.links))])
        # Per-link DONE state (the router's ``done[k]``): a fleet shard
        # that reaches its step budget first sends DONE while the others
        # may still be filling, fed by this aggregator alone.  A done link
        # freezes at its last pulled (version, slice) and takes no more
        # pushes; the run is over when every shard said DONE.
        self._link_done = [False] * len(self.links)
        self._last_pull: "list[tuple[int, dict] | None]" = (
            [None] * len(self.links))

    def push_seq(self) -> int:
        """The highest per-link push seq: what a supervised restart seeds
        the successor's links with."""
        return max(link._push_seq for link in self.links)

    def start_heartbeats(self) -> None:
        for link in self.links:
            link._session.start_heartbeat()

    def new_epoch(self) -> None:
        """The root's version vector advanced: re-arm each live link's
        pace allowance and flush what it admits."""
        for k, link in enumerate(self.links):
            if not self._link_done[k]:
                link._session.new_epoch()

    def open_pace(self) -> None:
        """The ``pace_timeout`` valve: a stalled root has cost its bounded
        wait, so the queued forwards flow (credits still gate)."""
        for k, link in enumerate(self.links):
            if not self._link_done[k]:
                link._session.open_pace()

    def pending_frames(self) -> int:
        return sum(link._session.pending_count()
                   for k, link in enumerate(self.links)
                   if not self._link_done[k])

    def session_stats(self) -> "dict[str, int]":
        out: "dict[str, int]" = {}
        for link in self.links:
            for k, v in link._session.stats.items():
                out[k] = out.get(k, 0) + v
        return out

    def pull(self):
        """One root round trip: ``(per-link versions, full param dict)``,
        or None when the root's run is over (every shard said DONE, or a
        single root stayed gone past the reconnect budget, as for a plain
        worker).  A shard done first freezes at its last pulled slice
        while the rest keep serving; a partly unreachable fleet (dead, not
        done) raises instead of serving a tree with frozen slices."""
        versions: "list[int]" = []
        params: "dict[str, Any]" = {}
        dead = 0
        for k, link in enumerate(self.links):
            if self._link_done[k]:
                version, slice_params = self._last_pull[k]
                versions.append(version)
                params.update(slice_params)
                continue
            while True:
                try:
                    pulled = link.pull()
                    break
                except TRANSPORT_ERRORS:
                    if not link._reconnect():
                        pulled = _DEAD
                        break
            if pulled is None:
                if self._last_pull[k] is None:
                    # DONE before this link served a slice: nothing to
                    # freeze, the run is over.
                    return None
                # This shard's run is over: freeze its final slice and
                # stop dialing it (its listener is going away).
                self._link_done[k] = True
                link.close()
                version, slice_params = self._last_pull[k]
                versions.append(version)
                params.update(slice_params)
                continue
            if pulled is _DEAD:
                dead += 1
                versions.append(0)
                continue
            version, slice_params = pulled
            self._last_pull[k] = (version, slice_params)
            versions.append(version)
            params.update(slice_params)
        if all(self._link_done):
            return None  # every shard completed: the run is over
        if dead:
            # Links still serving, counted after the pass (a link that
            # said DONE during it no longer serves).
            remaining = sum(1 for d in self._link_done if not d)
            if dead == remaining:
                return None  # the whole remaining root is gone
            raise FleetDeadError(
                f"{dead} of {remaining} still-serving root shards "
                f"became unreachable (reconnect budget spent) while "
                f"the rest still serve — refusing to aggregate against "
                f"a partial root")
        return versions, params

    def push(self, codes_host, versions, loss: float, *, group: int,
             n_contrib: int, target: int) -> None:
        """Forward one reduced code tree as AGGR frame(s), split along the
        fleet plan when the root is sharded.  A failed push is a lost
        forward (its seq burned): the root's own quorum absorbs the short
        fill, and the next pull owns any dead-link escalation.  The
        caller keeps owning ``codes_host`` (serialized before the gate,
        copied when parked)."""
        for k, link in enumerate(self.links):
            if self._link_done[k]:
                continue  # this shard's run is complete
            if self._shard_names is None:
                sub = codes_host
            else:
                sub = OrderedDict((n, codes_host[n])
                                  for n in self._shard_names[k])
            try:
                link.push_agg(sub, versions[k], loss, group=group,
                              n_contrib=n_contrib, target=target)
            except TRANSPORT_ERRORS:
                link._reconnect()

    def push_bucketed(self, buckets, n_buckets: int, versions,
                      loss: float, *, group: int, n_contrib: int,
                      target: int) -> None:
        """Stream one reduced forward as AGGR-bucket frames (a single
        root: `LocalAggregator` refuses bucketing against a fleet).
        Failures as in `push`."""
        link = self.links[0]
        if self._link_done[0]:
            return
        try:
            link.push_agg_buckets(buckets, n_buckets, versions[0], loss,
                                  group=group, n_contrib=n_contrib,
                                  target=target)
        except TRANSPORT_ERRORS:
            link._reconnect()

    def close(self) -> None:
        for link in self.links:
            link.close()


class LocalAggregator(AsyncPSServer):
    """One host group's aggregation tier.

    Usage::

        agg = LocalAggregator(named_params, group=0,
                              upstream=[("root-host", 5555)],
                              group_size=4, quorum=3, fill_deadline=0.1,
                              aggregate="trimmed_mean", anomaly_z=4.0)
        agg.compile_reduce()
        hist = agg.serve_group()     # until the root says DONE

    Workers connect to ``agg.address`` with the unchanged worker protocol
    (an `AsyncPSWorker`, or a `GroupWorker` for failover).  The aggregator
    relays the root's params under its own version counter, runs the
    shared fill-admission loop under the group's own policy, reduces each
    fill to a per-contributor mean, re-encodes it and forwards one AGGR
    frame a fill.  It applies no update: ``named_params`` give the tree's
    shapes for the codec and the validation.  ``device`` holds the
    group's reduce: the card unless the caller passes ``"cpu"``.
    """

    def __init__(self, named_params, *, group: int, upstream,
                 group_size: int, host: str = "127.0.0.1", port: int = 0,
                 upstream_rank: "int | None" = None,
                 upstream_seq: int = 0,
                 upstream_retries: int = 8,
                 upstream_backoff_base: float = 0.1,
                 upstream_backoff_max: float = 1.0,
                 forward_ahead: int = 1,
                 pace_timeout: float = 5.0,
                 bucket_bytes: "int | None" = None, **kw):
        if group_size < 1:
            raise ValueError(f"group_size must be >= 1, got {group_size}")
        # Bucket-streamed forwards: reduce each fill per bucket (for the
        # coordinate-wise reducers, `ops.robust.bucket_streamable`; else
        # reduce the whole tree and split it for sending) and stream the
        # reduced sub-trees as AGGR-bucket frames.  None = whole-tree
        # forwards; 0 = auto-size.  A single root only: a sharded root
        # already splits the forward per shard.
        if bucket_bytes is not None and bucket_bytes < 0:
            raise ValueError(
                f"bucket_bytes must be >= 0 (0 = auto) or None, got "
                f"{bucket_bytes}")
        upstream = list(upstream)
        if bucket_bytes is not None and len(upstream) > 1:
            raise ValueError(
                "bucket_bytes composes with a SINGLE root endpoint — a "
                "sharded root already splits the forward per shard "
                "slice")
        self._bucket_bytes = bucket_bytes
        self._bucket_plan = None
        self._bucket_streamed = False
        super().__init__(named_params, quota=int(group_size), host=host,
                         port=port, **kw)
        self.group = int(group)
        self.group_size = int(group_size)
        # Forward pacing: the upstream session admits at most
        # ``forward_ahead`` AGGR frames per observed root version, on top
        # of the root's credit window.  A plain worker is paced by its
        # blocking pull; a group fills from its workers' free-running
        # pushes, so an unpaced aggregator outruns the root and its frames
        # land many versions late.  One forward a root version balances
        # supply and demand at root quota == G groups.  A paced-out
        # forward parks in the session (counted ``agg_paced``);
        # ``pace_timeout`` bounds the stall, after which the queued frames
        # flow.  0 disables pacing (credits alone gate).
        if forward_ahead < 0:
            raise ValueError(
                f"forward_ahead must be >= 0, got {forward_ahead}")
        self.forward_ahead = int(forward_ahead)
        if pace_timeout <= 0:
            raise ValueError(
                f"pace_timeout must be > 0, got {pace_timeout}")
        self.pace_timeout = float(pace_timeout)
        self.fault_stats.update({
            # Fills reduced and handed to the upstream transport, and
            # forwards stalled by the pacing gate.
            "agg_forwards": 0,
            "agg_paced": 0,
        })
        self._compiled = False
        # Local version -> the root's per-shard version vector at that
        # pull, so a forward carries the root's versions (the staleness
        # the root accounts is its own, not the aggregator's).  Bounded.
        self._version_map: "dict[int, list[int]]" = {0: []}
        try:
            self._upstream = _Upstream(
                upstream, group=self.group, target=self.group_size,
                code=self.code, token=self.token, device=self.ps_device,
                assigned_rank=upstream_rank, initial_seq=upstream_seq,
                reconnect_retries=upstream_retries,
                backoff_base=upstream_backoff_base,
                backoff_max=upstream_backoff_max,
                pace_hook=lambda: self._bump("agg_paced"),
                pace=(self.forward_ahead or None),
                # The aggregator's op budget rides its upstream pulls.
                op_deadline=self.op_deadline)
        except BaseException:
            # The listener is bound already: an unreachable root must not
            # leak it (a retry on a fixed port would hit EADDRINUSE).
            super().close()
            raise
        self._version_map[0] = [0] * len(self._upstream.links)

    @property
    def upstream_rank(self) -> int:
        """This aggregator's rank at the root: what a supervised restart
        re-presents."""
        return self._upstream.rank

    # -- the group reduce -----------------------------------------------------

    def compile_reduce(self) -> None:
        """Prepare the group reduce (it replaces `compile_step`: an
        aggregator has no loss function and applies no update): the
        validation indexes of incoming payloads, the reducer/codec gate,
        the `FaultPlan` aggregator attack and, with ``bucket_bytes``, the
        bucket plan.  The indexes come from a zero tree encoded on the CPU,
        so no kernel launches here."""
        from ..ops.robust import bucket_streamable, check_reducer_codec

        with torch.no_grad():
            dummy = OrderedDict(
                (n, self.code.encode(torch.zeros(shape, dtype=dtype)))
                for n, (shape, dtype) in self._metas.items())
        self._index_code_meta(dummy)
        self._itemwise = check_reducer_codec(
            self.aggregate, self.code,
            anomaly_scoring=self._scoreboard is not None)
        self._transform = (
            self.fault_plan.agg_byzantine_transform(self.group)
            if self.fault_plan is not None else None)
        self._bucket_plan = None
        self._bucket_streamed = False
        if self._bucket_bytes is not None:
            from ..parallel.overlap import plan_overlap

            self._bucket_plan = plan_overlap(
                OrderedDict((n, torch.empty(shape, dtype=dtype,
                                            device="meta"))
                            for n, (shape, dtype) in self._metas.items()),
                self._bucket_bytes, record=False)
            # Per-bucket reduces compose bitwise to the whole-tree one
            # only for a coordinate-wise statistic with no whole-tree
            # attack or scoring.
            self._bucket_streamed = (
                self._transform is None
                and bucket_streamable(
                    self.aggregate,
                    anomaly_scoring=self._scoreboard is not None))
        self._compiled = True

    def _reduce(self, stacked, weights, clip_norm: float = float("nan"),
                *, whole: bool = True):
        """Reduce one fill's stacked codes (every leaf with a leading
        contributor dim, in the codec's element order; a bucket's names
        alone when ``whole`` is False) to the re-encoded per-contributor
        mean.  Returns ``(codes, info)``.

        The mean without scoring folds ``weights / n`` into the codes and
        decodes the sum in one grouped launch (dividing after the decode
        would round once more); the other reducers decode each
        contribution and run `robust_reduce` with ``n_target=1``.  The
        aggregator attack (whole tree only) maps the reduced gradient
        before it is encoded."""
        from ..ops.robust import robust_reduce

        code = self.code
        metas = OrderedDict((nm, self._metas[nm]) for nm in stacked)
        w = np.asarray(weights, np.float32)
        n = w.shape[0]
        if self._itemwise:
            items = [code.decode_sum_leaves(OrderedDict(
                (nm, tree_map(lambda x, i=i: x[i:i + 1], stacked[nm]))
                for nm in metas), metas) for i in range(n)]
            decoded = OrderedDict(
                (nm, torch.stack([it[nm] for it in items])) for nm in metas)
            reduced, info = robust_reduce(
                self.aggregate, decoded, torch.from_numpy(w),
                n_target=1.0, trim_k=self.trim_k, clip_norm=clip_norm)
        else:
            scale = torch.from_numpy(w / np.float32(n))
            reduced = code.decode_sum_leaves(OrderedDict(
                (nm, code.scale_codes(stacked[nm], scale))
                for nm in metas), metas)
            info = {"contrib_norms": torch.zeros(n),
                    "clipped": torch.zeros((), dtype=torch.int32)}
        if whole and self._transform is not None:
            reduced = self._transform(reduced)
        codes = OrderedDict(
            (nm, code.encode(reduced[nm].to(metas[nm][1])))
            for nm in metas)
        return codes, info

    def _reduce_weighted(self, stacked, stalenesses, ranks, contribs):
        """The fill's weights (as the root's `_apply_weighted` computes
        them), the norm_clip threshold, the reduce, and the scoring of an
        itemwise reduce."""
        w = self._contrib_weights(stalenesses, ranks, contribs)
        clip = float("nan")
        if self.aggregate == "norm_clip" and self._norm_window:
            clip = float(np.median(np.asarray(self._norm_window)))
        codes, info = self._reduce(stacked, w, clip)
        if self._itemwise:
            self._post_apply_scoring(ranks, info)
        return codes

    def _forward_bucketed(self, stacked, stalenesses, ranks, contribs,
                          versions_vec, mean_loss: float,
                          fill_target: int, n_codes: int) -> None:
        """The bucket-streamed forward: reduce bucket by bucket (an event
        recorded after each on the card, so a finished bucket goes out
        while the next one reduces), then stream the reduced sub-trees as
        AGGR-bucket frames, one credit and one seq for the forward.  A
        policy that is not coordinate-wise reduces the whole tree first
        and only the sending is split."""
        from ..parallel.overlap import (BucketCodes, iter_ready_groups,
                                        split_tree)

        plan = self._bucket_plan
        if self._bucket_streamed:
            w = self._contrib_weights(stalenesses, ranks, contribs)
            outs = []
            for sub in split_tree(stacked, plan):
                codes, _info = self._reduce(sub, w, whole=False)
                bucket = BucketCodes(codes)
                bucket.event = record_event(self.ps_device)
                outs.append(bucket)
        else:
            outs = split_tree(self._reduce_weighted(
                stacked, stalenesses, ranks, contribs), plan)
        stream = iter_ready_groups(
            outs, lambda sub: tree_map(_wire_leaf, tree_to_host(sub)))
        self._upstream.push_bucketed(
            stream, plan.n_buckets, versions_vec, mean_loss,
            group=self.group, n_contrib=n_codes, target=fill_target)

    def _fault_stats_snapshot(self) -> "dict[str, Any]":
        """The server's snapshot plus the upstream sessions' flow-control
        counters (read without the session lock: snapshot-grade int
        reads, and the pace hook bumps under that lock)."""
        snap = super()._fault_stats_snapshot()
        for k, v in self._upstream.session_stats().items():
            snap[k] = snap.get(k, 0) + v
        return snap

    # -- the aggregator loop --------------------------------------------------

    def _pull_and_publish(self) -> "list[int] | None":
        """One upstream pull, published leaf by leaf to the group's
        serving snapshot (the InCon relay).  The pulled tree was decoded
        into fresh host memory; an unchanged pull returns the same arrays.
        The local version advances only when the root's version vector
        moved (bumping on every re-pull would inflate worker staleness
        against a frozen root), and that advance is the pacing epoch: it
        re-arms the upstream sessions' forward allowance.  None = the
        root is done or gone."""
        pulled = self._upstream.pull()
        if pulled is None:
            return None
        versions, params = pulled
        for n in self._served:
            self._served[n] = params[n]
        if self._version_map.get(self._served_version) != list(versions):
            self._served_version += 1
            self._version_map[self._served_version] = list(versions)
            if len(self._version_map) > 128:
                self._version_map.pop(min(self._version_map))
            self._upstream.new_epoch()
        return versions

    def _tend_pace_valve(self, valve: "Deadline | None", *,
                         advanced: bool) -> "Deadline | None":
        """The ``pace_timeout`` valve, once a loop: armed while paced-out
        forwards wait in the upstream sessions, re-armed at every root
        advance; expired, it opens the pace gate, so a stalled root costs
        seconds, never a deadlock.  Returns the valve to keep.

        The JAX aggregator re-arms it only once nothing waits: a group
        that out-produces a healthy root then opens it every
        ``pace_timeout``, and each opening leaves its parked frames queued
        at the root for good, a permanent step up in the root's
        staleness."""
        if self._upstream.pending_frames() == 0:
            return None
        if valve is None or advanced:
            return Deadline(self.pace_timeout)
        if valve.expired():
            self._upstream.open_pace()
            return None
        return valve

    def serve_group(self, max_fills: "int | None" = None,
                    log_every: int = 0, idle_timeout: float = 300.0, *,
                    eviction_timeout: float = 30.0,
                    dead_conn_grace: float = 2.0) -> "dict[str, Any]":
        """Serve the group until the root says DONE (or ``max_fills``):
        pull the root's params, publish them to the group, run one fill
        under the group's admission policy, reduce, forward one AGGR
        frame, repeat.  The worker-facing failure semantics are the
        server's own (eviction, re-admission, quorum short fills, the
        starvation and idle errors): a group is a PS whose update is a
        forward."""
        if not self._compiled:
            raise NotCompiledError(
                "call compile_reduce() before serve_group()")
        if self._closed.is_set():
            raise FleetDeadError(
                "serve_group() called on a closed aggregator")
        self._net_stop.clear()
        accept = threading.Thread(target=self._accept_loop, daemon=True,
                                  name=f"agg-{self.group}-accept")
        accept.start()
        poll = min(0.5, max(idle_timeout / 4.0, 0.02))
        self._idle_timeout = idle_timeout
        idle = Deadline(idle_timeout)

        def receive(timeout):
            try:
                item = self._net_queue.get(timeout=timeout)
            except queue.Empty:
                if self._closed.is_set():
                    raise FleetDeadError(
                        f"aggregator group {self.group} closed while "
                        f"serving") from None
                self._evict_dead(eviction_timeout, dead_conn_grace)
                if idle.expired():
                    raise FleetDeadError(
                        f"group {self.group}: no worker gradient for "
                        f"{idle_timeout:.0f}s — group fleet dead or "
                        f"never started") from None
                return None
            idle.restart()
            return item

        def drain_nowait():
            try:
                return self._net_queue.get_nowait()
            except queue.Empty:
                return None

        history: "dict[str, Any]" = {"fills": 0, "losses": [],
                                     "contributors": [],
                                     "grads_consumed": 0}
        plan = self.fault_plan
        t_start = time.perf_counter()
        self._serve_t0 = t_start
        fill = 0
        pace_valve: "Deadline | None" = None
        try:
            self._upstream.start_heartbeats()
            while max_fills is None or fill < max_fills:
                if plan is not None and plan.should_kill_agg(self.group,
                                                             fill):
                    self._dying = True
                    raise SimulatedCrash(
                        f"FaultPlan: aggregator group {self.group} "
                        f"killed before fill {fill}")
                if plan is not None and plan.should_slow_agg(self.group):
                    # A straggling aggregator: the whole group's forward
                    # lags, and only the root's quorum absorbs it.
                    time.sleep(plan.slow_agg_delay_s)
                seen = self._served_version
                versions = self._pull_and_publish()
                if versions is None:
                    break  # the root is done: DONE rides down the group
                pace_valve = self._tend_pace_valve(
                    pace_valve, advanced=self._served_version != seen)
                self._evict_dead(eviction_timeout, dead_conn_grace)
                idle.restart()
                (codes_list, stalenesses, losses, ranks, contribs,
                 fill_target, _short) = self._fill_gradients(
                    receive, drain_nowait,
                    current_version=lambda: self._served_version,
                    base_timeout=poll)
                # The frame's version: the oldest contributing pull,
                # mapped back to the root's version vector.
                v_old = self._served_version - (int(max(stalenesses))
                                                if stalenesses else 0)
                vmap = self._version_map.get(
                    v_old, self._version_map[min(self._version_map)])
                mean_loss = float(np.mean([float(x) for x in losses]))
                with torch.no_grad():
                    stacked = self._stack(codes_list)
                    if self._bucket_plan is not None:
                        self._forward_bucketed(
                            stacked, stalenesses, ranks, contribs, vmap,
                            mean_loss, fill_target, len(codes_list))
                    else:
                        codes = self._reduce_weighted(
                            stacked, stalenesses, ranks, contribs)
                        # One copy into fresh host memory (it waits for
                        # the reduce): the forward's payload.
                        codes_host = tree_map(_wire_leaf,
                                              tree_to_host(codes))
                        self._upstream.push(
                            codes_host, vmap, mean_loss, group=self.group,
                            n_contrib=len(codes_list), target=fill_target)
                self._bump("agg_forwards")
                history["fills"] += 1
                history["losses"].append(mean_loss)
                history["contributors"].append(list(ranks))
                history["grads_consumed"] += len(codes_list)
                fill += 1
                if log_every and fill % log_every == 0:
                    print(f"group {self.group} fill {fill:5d}  loss "
                          f"{mean_loss:.4f}  n={len(codes_list)}")
        finally:
            self._net_stop.set()
            self._listener.close()
            accept.join(timeout=5.0)
            self._upstream.close()
        history["wall_time"] = time.perf_counter() - t_start
        history["fault_stats"] = self._fault_stats_snapshot()
        return history

    def close(self, join_timeout: float = 5.0) -> None:
        super().close(join_timeout)
        self._upstream.close()


class GroupWorker:
    """A hierarchy worker: computes against its group's aggregator, and
    fails over to a direct root connection when the aggregator dies for
    good.

    The ladder on a lost aggregator link: (1) bounded redial with
    backoff, re-presenting the local rank (``fault_stats["agg_redials"]``),
    which rides a supervised restart with no rank churn; (2) once the
    budget is spent, a direct root connection (``agg_failovers``; the
    root books the flagged HELO under ``direct_fallbacks`` and lists the
    rank in its ``groups`` view), finishing the run as a plain worker, a
    `ShardRouter` when the root is a fleet.  No root endpoints = the
    plain worker's clean exit.  ``device`` is the card unless the caller
    passes ``"cpu"``."""

    def __init__(self, agg_host: str, agg_port: int, *,
                 root_endpoints=None, group: int = 0,
                 code=None, token: "str | None" = None, fault_plan=None,
                 device=None,
                 io_timeout: float = 60.0, reconnect_retries: int = 3,
                 backoff_base: float = 0.1, backoff_max: float = 1.0,
                 heartbeat_interval: float = 2.0):
        self.group = int(group)
        self.root_endpoints = ([(h, int(p)) for h, p in root_endpoints]
                               if root_endpoints else None)
        self.fault_stats: "dict[str, int]" = {"agg_failovers": 0,
                                              "agg_redials": 0}
        self._link_kw = dict(code=code, token=token, fault_plan=fault_plan,
                             device=device, io_timeout=io_timeout,
                             reconnect_retries=reconnect_retries,
                             backoff_base=backoff_base,
                             backoff_max=backoff_max,
                             heartbeat_interval=heartbeat_interval)
        self.link = AsyncPSWorker(agg_host, agg_port, **self._link_kw)
        self.rank = self.link.rank  # the local rank, minted by the group
        self.direct_rank: "int | None" = None
        self._direct: "AsyncPSWorker | ShardRouter | None" = None
        self._computed = 0

    @property
    def reconnects(self) -> int:
        return self.link.reconnects

    @property
    def grads_computed(self) -> int:
        """Gradients computed on both legs (the kernels' launch counts are
        per computed gradient)."""
        return self._computed + (self._direct.grads_computed
                                 if self._direct is not None else 0)

    def close(self) -> None:
        self.link.close()

    def _redial(self) -> bool:
        if self.link._reconnect():
            self.fault_stats["agg_redials"] += 1
            return True
        return False

    def _fallback(self, loss_fn, batch_fn,
                  max_iters: "int | None") -> int:
        """The direct leg: re-admit at the root as a plain (group-flagged)
        worker and finish the run there.  A root that is gone too, or
        refuses the configuration, ends the run: 0 pushes, a clean exit,
        as for a plain worker."""
        self.fault_stats["agg_failovers"] += 1
        kw = dict(self._link_kw)
        try:
            if len(self.root_endpoints) > 1:
                direct = ShardRouter(self.root_endpoints,
                                     fallback_group=self.group, **kw)
            else:
                (h, p), = self.root_endpoints
                direct = AsyncPSWorker(h, p, fallback_group=self.group,
                                       **kw)
        except TRANSPORT_ERRORS:
            return 0
        self._direct = direct
        self.direct_rank = direct.rank
        print(f"group {self.group} worker (local rank {self.rank}): "
              f"aggregator gone — direct fallback to the root as rank "
              f"{direct.rank}", file=sys.stderr)
        try:
            return direct.run(loss_fn, batch_fn, max_iters)
        finally:
            direct.close()

    def run(self, loss_fn: Callable,
            batch_fn: "Callable[[int, int], Any]",
            max_iters: "int | None" = None) -> int:
        """Work until the aggregator (or, after a failover, the root) says
        DONE.  Returns the gradients pushed on both legs."""
        from ..async_ps import make_worker_step
        from ..utils.interop import jax_order

        link = self.link
        plan = self._link_kw["fault_plan"]
        transform = (plan.byzantine_transform(self.rank)
                     if plan is not None else None)
        fn = None
        pushed = 0
        it = 0
        failover = False
        # Device params keyed by the identity of the pulled host tree (an
        # unchanged conditional pull returns the same object).
        dev_params = None
        dev_src = None
        link._session.start_heartbeat()
        try:
            while max_iters is None or it < max_iters:
                if (plan is not None
                        and plan.should_kill_worker(self.rank, it)):
                    raise SimulatedCrash(
                        f"FaultPlan: group {self.group} worker "
                        f"{self.rank} killed at iteration {it}")
                if plan is not None and plan.should_slow(self.rank):
                    time.sleep(plan.slow_delay_s)
                try:
                    pulled = link.pull()
                except TRANSPORT_ERRORS:
                    if self._redial():
                        continue
                    failover = True
                    break
                if pulled is None:
                    break  # DONE rode down from the root
                version, params = pulled
                if fn is None:
                    if link.code.ordered:
                        link._orders = {
                            n: o for n, p in params.items()
                            if (o := jax_order(n, tuple(p.shape)))
                            is not None}
                    fn = make_worker_step(loss_fn, link.code, transform,
                                          orders=link._orders)
                if params is not dev_src:
                    dev_params = tree_to_device(params, link.device)
                    dev_src = params
                batch = tree_map(
                    lambda x: torch.as_tensor(x).to(link.device,
                                                    non_blocking=True),
                    batch_fn(self.rank, it))
                loss, codes = fn(dev_params, batch)
                self._computed += 1
                codes_host, loss_f = link._codes_to_host(codes, loss)
                if (plan is not None
                        and plan.inject_nonfinite(self.rank, it)):
                    from ..utils.faults import poison_nonfinite
                    codes_host = poison_nonfinite(codes_host)
                try:
                    link.push(codes_host, version, loss_f)
                except TRANSPORT_ERRORS:
                    if self._redial():
                        continue  # the gradient is lost; pull afresh
                    failover = True
                    break
                link._inject_overload(plan, it, codes_host, version, loss_f)
                pushed += 1
                it += 1
        finally:
            for k, v in link.fault_snapshot().items():
                if v:
                    self.fault_stats[k] = self.fault_stats.get(k, 0) + v
            link.close()
        if failover and self.root_endpoints:
            remaining = None if max_iters is None else max_iters - it
            pushed += self._fallback(loss_fn, batch_fn, remaining)
        return pushed


class Hierarchy:
    """Spawn and supervise G group-local aggregators against one root.

    Usage (the root, an `AsyncPSServer` or a `PSFleet`, must already be
    accepting connections)::

        hier = Hierarchy(named_params, groups=3, group_size=4,
                         upstream=[("127.0.0.1", root_port)],
                         quorum=3, fill_deadline=0.1,
                         aggregate="trimmed_mean", anomaly_z=4.0)
        hier.compile()
        view = hier.serve()          # returns when the root says DONE

    Every keyword beyond the topology reaches each `LocalAggregator`
    unchanged, so per-group policy is single-PS policy.  An aggregator
    killed by ``kill_agg_at`` is restarted (at most ``max_restarts`` times
    a group) on the same port with the same upstream rank: workers inside
    their redial budget reconnect with their local ranks, the root books
    the same aggregator rank, and the group is reclaimed with no rank
    churn.  Past the budget the group stays down and its workers' direct
    fallback takes over."""

    def __init__(self, named_params, *, groups: int, group_size: int,
                 upstream, host: str = "127.0.0.1", ports=None,
                 fault_plan=None, max_restarts: int = 2, **agg_kw):
        if groups < 1:
            raise ValueError(f"groups must be >= 1, got {groups}")
        self._named_params = list(
            named_params.items() if hasattr(named_params, "items")
            else named_params)
        self.groups = int(groups)
        self.group_size = int(group_size)
        self.upstream = [(h, int(p)) for h, p in upstream]
        self.host = host
        self.fault_plan = fault_plan
        self.max_restarts = int(max_restarts)
        self._agg_kw = dict(agg_kw)
        if ports is None:
            port_list = [0] * groups
        elif isinstance(ports, int):
            port_list = ([0] * groups if ports == 0
                         else [ports + g for g in range(groups)])
        else:
            port_list = list(ports)
            if len(port_list) != groups:
                raise ValueError(
                    f"{len(port_list)} ports for {groups} groups")
        self.aggregators: "list[LocalAggregator]" = []
        try:
            for g in range(groups):
                self.aggregators.append(
                    self._make_agg(g, port_list[g], upstream_rank=None,
                                   consume_kill=False))
        except BaseException:
            self.close()
            raise
        self.fault_stats: "dict[str, int]" = {"agg_restarts": 0}
        self._slots = [{"hist": None, "error": None, "restarts": 0}
                       for _ in range(groups)]
        # Crashed-and-replaced incarnations' final snapshots: their
        # counters keep counting in the tier view (as `PSFleet`'s).
        self._retired: "list[tuple[int, dict]]" = []

    def _make_agg(self, g: int, port: int, *, upstream_rank,
                  consume_kill: bool,
                  upstream_seq: int = 0) -> LocalAggregator:
        plan = self.fault_plan
        if consume_kill and plan is not None and g in plan.kill_agg_at:
            # The restarted incarnation must not crash-loop on the same
            # injection.
            remaining = dict(plan.kill_agg_at)
            remaining.pop(g)
            plan = dataclasses.replace(plan, kill_agg_at=remaining)
        return LocalAggregator(
            self._named_params, group=g, upstream=self.upstream,
            group_size=self.group_size, host=self.host, port=port,
            upstream_rank=upstream_rank, upstream_seq=upstream_seq,
            fault_plan=plan, **self._agg_kw)

    @property
    def addresses(self) -> "list[tuple[str, int]]":
        """(host, port) a group, in group order: what each group's
        workers connect to."""
        return [agg.address for agg in self.aggregators]

    def compile(self) -> None:
        for agg in self.aggregators:
            agg.compile_reduce()

    def _serve_agg(self, g: int, serve_kw: dict) -> None:
        slot = self._slots[g]
        try:
            slot["hist"] = self.aggregators[g].serve_group(**serve_kw)
        except BaseException as exc:  # recorded; the supervisor decides
            slot["error"] = exc

    def serve(self, log_every: int = 0,
              idle_timeout: float = 300.0, *,
              eviction_timeout: float = 30.0,
              dead_conn_grace: float = 2.0,
              max_fills: "int | None" = None) -> "dict[str, Any]":
        """Run every group's aggregator until the root finishes.  A planned
        aggregator death (`SimulatedCrash` from ``kill_agg_at``) restarts
        the group in place (same port, same upstream rank and sequence;
        ``agg_restarts``), at most ``max_restarts`` times; past that (or
        with ``max_restarts=0``) the group stays down and its workers'
        direct fallback owns recovery.  Any other failure of a group is
        recorded, printed and survived by the rest of the tier; only a
        tier that never functioned (every group failed before forwarding
        one fill) raises the typed `AggregatorDeadError`."""
        serve_kw = dict(log_every=log_every, idle_timeout=idle_timeout,
                        eviction_timeout=eviction_timeout,
                        dead_conn_grace=dead_conn_grace,
                        max_fills=max_fills)
        threads: "dict[int, threading.Thread]" = {}

        def launch(g: int) -> None:
            t = threading.Thread(target=self._serve_agg,
                                 args=(g, serve_kw), daemon=True,
                                 name=f"hier-agg-{g}")
            threads[g] = t
            t.start()

        t_start = time.perf_counter()
        for g in range(self.groups):
            launch(g)
        while True:
            alive = False
            for g, t in list(threads.items()):
                t.join(timeout=0.1)
                if t.is_alive():
                    alive = True
                    continue
                slot = self._slots[g]
                err, slot["error"] = slot["error"], None
                if err is None:
                    continue
                if (isinstance(err, SimulatedCrash)
                        and slot["restarts"] < self.max_restarts):
                    old = self.aggregators[g]
                    port = old.address[1]
                    rank = old.upstream_rank
                    seq = old._upstream.push_seq()
                    self._retired.append((g, old._fault_stats_snapshot()))
                    old.close()
                    agg = self._make_agg(g, port, upstream_rank=rank,
                                         consume_kill=True,
                                         upstream_seq=seq)
                    agg.compile_reduce()
                    self.aggregators[g] = agg
                    slot["restarts"] += 1
                    self.fault_stats["agg_restarts"] += 1
                    print(f"hierarchy: restarted aggregator for group "
                          f"{g} on port {port} (upstream rank {rank} "
                          f"reclaimed)", file=sys.stderr)
                    launch(g)
                    alive = True
                else:
                    # Gone for good: the group's workers own recovery
                    # (bounded redial, then a direct fallback).
                    slot["error_final"] = err
                    print(f"hierarchy: aggregator for group {g} is down "
                          f"for good ({err!r}) — its workers fail over "
                          f"to direct root connections", file=sys.stderr)
            if not alive:
                break
        wall = time.perf_counter() - t_start
        per_group = [slot["hist"] for slot in self._slots]
        forwarded = sum(h["fills"] for h in per_group if h)
        if forwarded == 0:
            failures = [s.get("error_final") for s in self._slots
                        if s.get("error_final") is not None]
            if len(failures) == self.groups:
                raise AggregatorDeadError(
                    "every group aggregator failed before forwarding a "
                    "single fill — the hierarchy tier never functioned "
                    "(is the root reachable?)") from failures[0]
        view = self.hierarchy_fault_stats()
        return {"per_group": per_group, "fills_total": forwarded,
                "wall_time": wall, "fault_stats": view}

    # -- the one tier view ----------------------------------------------------

    def hierarchy_fault_stats(self) -> "dict[str, Any]":
        """The per-group aggregator snapshots aggregated: integer counters
        summed tier-wide (one `format_fault_stats` line), the full
        per-group snapshots under ``"groups"`` keyed by group id."""
        agg: "dict[str, Any]" = dict(self.fault_stats)
        groups: "dict[str, Any]" = {}
        retired = [(f"{g}:retired{i}", snap)
                   for i, (g, snap) in enumerate(self._retired)]
        live = [(str(g), (a._fault_stats_snapshot()
                          if self._slots[g]["hist"] is None
                          else self._slots[g]["hist"]["fault_stats"]))
                for g, a in enumerate(self.aggregators)]
        for name, snap in retired + live:
            groups[name] = snap
            for key, value in snap.items():
                if isinstance(value, bool):
                    continue
                if key == "repl_lag":
                    continue
                if isinstance(value, int):
                    # workers_seen too: the groups are disjoint.
                    agg[key] = agg.get(key, 0) + value
        agg["groups"] = groups
        return agg

    def close(self) -> None:
        for a in self.aggregators:
            a.close()
