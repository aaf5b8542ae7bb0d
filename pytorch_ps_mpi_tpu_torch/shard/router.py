"""Worker-side shard multiplexer for the sharded PS fleet.

Counterpart of `pytorch_ps_mpi_tpu/shard/router.py`.  A `ShardRouter` is
"one worker, K parameter servers": it holds one transport link
(`multihost_async.AsyncPSWorker`) per fleet shard, but computes ONE
gradient per step — the whole-tree grad + encode the single-PS worker
runs (`async_ps.make_worker_step`, on the worker's device: 62
``block_quantize`` launches a blockq ResNet-18 gradient on the card, never
one set per shard) — and splits the host code tree into per-shard GRAD
frames along the fleet's `ShardPlan`.

Fleet-wide identity: shard 0 mints the worker's rank; every other link
presents it with the HELO ``assigned_rank`` flag, so eviction, seq dedup,
quarantine and latency accounting name the same worker on every shard.

Per-shard versions replace the single parameter version: every PULL from
shard k yields ``(version_k, slice_k)``, and the GRAD slice pushed back to
shard k carries ``version_k``, so staleness weighting, bounded-staleness
admission and the clamp run per shard on the versions that shard served
(AsySG-InCon's inconsistent read, extended across the fleet).

The plan is agreed at HELO time: the router fetches it from shard 0 (the
``SPLN`` frame) and refuses any shard whose advertised digest disagrees.

Partition tolerance: a link that fails its pull (reconnect budget spent),
or is black-holed by a `FaultPlan` ``partition_links`` injection, puts
that shard into bounded degraded mode: the router reuses the shard's
last-pulled slice, skips the suppressed pushes (``degraded_pulls`` /
``partition_drops``), and escalates to `FleetDeadError` only after
``degraded_max`` consecutive degraded steps (or ``degraded_deadline``
seconds).  A healed link resumes on the same socket and the same rank.

On the card the K pulls and pushes run on a thread pool (host work:
framing and the serializer); the gradient runs on the calling thread, with
one host-to-device copy of the assembled tree and one device-to-host copy
of its codes and loss a step.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

import torch

from ..errors import FleetDeadError
from ..multihost_async import (AsyncPSWorker, _wire_leaf, tree_to_device,
                               tree_to_host)
from ..transport import TRANSPORT_ERRORS, Deadline
from ..utils.flatten import tree_map
from .partition import ShardPlan


class ShardRouter:
    """One worker multiplexed across a K-shard PS fleet.

    Usage (as `AsyncPSWorker`)::

        r = ShardRouter([("ps-host", 5555), ("ps-host", 5556)],
                        code="blockq")
        r.run(loss_fn, batch_fn)   # returns when every shard said DONE

    ``endpoints`` lists the shards in shard order (slot k must be fleet
    shard k: a swapped list is refused at connect time).  ``device`` is the
    card unless the caller passes ``"cpu"``.
    """

    def __init__(self, endpoints, *, code=None, device=None,
                 token: "str | None" = None,
                 fault_plan=None, io_timeout: float = 60.0,
                 reconnect_retries: int = 3, backoff_base: float = 0.1,
                 backoff_max: float = 1.0,
                 heartbeat_interval: float = 2.0,
                 degraded_max: int = 8,
                 degraded_deadline: "float | None" = None,
                 op_deadline: "float | None" = None,
                 credit_cap: "int | None" = None,
                 fallback_group: "int | None" = None):
        endpoints = [(h, int(p)) for h, p in endpoints]
        if not endpoints:
            raise ValueError("ShardRouter needs at least one endpoint")
        self.endpoints = endpoints
        self.fault_plan = fault_plan
        # ``fallback_group``: this router is a direct-fallback worker of
        # hierarchy group g (`shard.hierarchy.GroupWorker`): every shard
        # books the HELO flag, and the fleet view sums the K bookings (one
        # failed-over worker reads as K, as reconnects do).
        link_kw = dict(code=code, device=device, token=token,
                       fault_plan=fault_plan, io_timeout=io_timeout,
                       reconnect_retries=reconnect_retries,
                       backoff_base=backoff_base, backoff_max=backoff_max,
                       heartbeat_interval=heartbeat_interval,
                       op_deadline=op_deadline, credit_cap=credit_cap,
                       fallback_group=fallback_group)
        self.links: "list[AsyncPSWorker]" = []
        try:
            # Shard 0 mints the fleet-wide rank; the other links book it.
            h0, p0 = endpoints[0]
            first = AsyncPSWorker(h0, p0, expect_shard=0, **link_kw)
            self.links.append(first)
            self.rank = first.rank
            for k, (h, p) in enumerate(endpoints[1:], start=1):
                self.links.append(AsyncPSWorker(
                    h, p, expect_shard=k, assigned_rank=self.rank,
                    **link_kw))
            if first.num_shards != len(endpoints):
                raise ValueError(
                    f"the fleet has {first.num_shards} shards but "
                    f"{len(endpoints)} endpoints were given — list every "
                    f"shard exactly once")
            self.plan = self._fetch_plan(first)
            digest = self.plan.digest()
            for k, link in enumerate(self.links):
                if link.plan_digest != digest:
                    raise ValueError(
                        f"shard-plan digest mismatch on shard {k}: the "
                        f"fleet's plan hashes to {digest:#x} but the "
                        f"server at {endpoints[k][0]}:{endpoints[k][1]} "
                        f"advertises {link.plan_digest:#x} — the "
                        f"endpoints mix different fleets (or a shard was "
                        f"relaunched with different partition rules)")
        except BaseException:
            self.close()
            raise
        self.code = first.code
        self.device = first.device
        self.num_shards = len(self.links)
        if degraded_max < 1:
            raise ValueError(
                f"degraded_max must be >= 1, got {degraded_max}")
        self.degraded_max = degraded_max
        if degraded_deadline is not None and degraded_deadline <= 0:
            raise ValueError(f"degraded_deadline must be > 0, "
                             f"got {degraded_deadline}")
        self.degraded_deadline = degraded_deadline
        # Router-side counters, rendered by `format_fault_stats` like the
        # PS side's (the links' session counters fold in at run end).
        self.fault_stats: "dict[str, int]" = {
            "partition_drops": 0, "degraded_pulls": 0,
            "credits_stalled": 0, "shed_data_frames": 0,
            "deadline_expired": 0, "flood_injected": 0,
            "burst_injected": 0}
        # Whole-tree gradients computed over every run (the kernels'
        # launch counts are per computed gradient).
        self.grads_computed = 0

    @staticmethod
    def _fetch_plan(link: AsyncPSWorker) -> ShardPlan:
        """The fleet's authoritative `ShardPlan` over the link's SPLN round
        trip: agreement at HELO time, not a recomputation."""
        link._send(b"SPLN")
        reply = link._recv()
        if reply[:4] != b"SPLN":
            raise ValueError(
                f"unexpected reply {reply[:4]!r} to the shard-plan "
                f"request")
        body = reply[4:]
        if not body:
            raise ValueError(
                "the shard-0 server carries no shard plan — it is a "
                "plain (unsharded) PS; connect a plain worker, or start "
                "the fleet via shard.PSFleet / --serve --shards K")
        return ShardPlan.from_json(body)

    @property
    def reconnects(self) -> int:
        """Fleet-wide reconnect count (sum over the shard links)."""
        return sum(link.reconnects for link in self.links)

    def close(self) -> None:
        for link in self.links:
            link.close()

    # -- the worker loop ------------------------------------------------------

    def run(self, loss_fn: Callable, batch_fn: "Callable[[int, int], Any]",
            max_iters: "int | None" = None) -> int:
        """Work until every shard says DONE (or ``max_iters``).  Returns
        the number of whole-tree gradients computed and pushed (each one
        fans out into up to K per-shard GRAD frames)."""
        from ..async_ps import make_worker_step
        from ..utils.interop import jax_order

        plan = self.fault_plan
        transform = (plan.byzantine_transform(self.rank)
                     if plan is not None else None)
        fn = None
        names = list(self.plan.assignment)
        shard_names = [self.plan.names_for(k)
                       for k in range(self.num_shards)]
        done = [False] * self.num_shards
        # Done and dead: the shard spent the reconnect budget and the
        # degraded bound (against a clean DONE).  A partial death must
        # fail loudly, not train a partial model.
        dead = [False] * self.num_shards
        degraded_count = [0] * self.num_shards
        degraded_dl: "list[Deadline | None]" = [None] * self.num_shards

        def check_partial():
            if any(dead) and not all(dead):
                # All dead: the run is over, as a DONE would end it.  Some
                # dead while others serve: continuing would freeze the
                # dead shards' slices and report success.
                gone = [k for k, d in enumerate(dead) if d]
                raise FleetDeadError(
                    f"fleet shard(s) {gone} became unreachable after "
                    f"exhausting the reconnect budget and the "
                    f"degraded-pull bound ({self.degraded_max}) while "
                    f"the rest of the fleet was still serving — "
                    f"refusing to keep training a partial model (raise "
                    f"reconnect_retries if the fleet was mid-restart, "
                    f"degraded_max if the partition outlives it)")

        def degrade(k):
            """One bounded degraded pull for shard k: its last slice is
            reused, counted; past the step bound (or the time budget
            armed at the first consecutive degraded pull) it is dead."""
            degraded_count[k] += 1
            self.fault_stats["degraded_pulls"] += 1
            if self.degraded_deadline is not None and degraded_dl[k] is None:
                degraded_dl[k] = Deadline(self.degraded_deadline)
            timed_out = (degraded_dl[k] is not None
                         and degraded_dl[k].expired())
            if degraded_count[k] > self.degraded_max or timed_out:
                done[k] = dead[k] = True

        versions = [0] * self.num_shards
        leaves: "dict[str, Any]" = {}
        pushed = 0
        it = 0
        _DEAD = object()
        # Latched on the way out of run(): a pool task whose socket the
        # teardown closed must not redial (the reopened socket would
        # never be closed).
        closing = threading.Event()

        def pull_one(k):
            """One shard's PULL, through reconnect and retry until the link
            gives up: (version, slice), None (DONE), or _DEAD (unreachable
            this step; run() decides degraded against dead)."""
            link = self.links[k]
            while True:
                try:
                    return link.pull()
                except TRANSPORT_ERRORS:
                    if closing.is_set() or not link._reconnect():
                        return _DEAD

        def push_one(k, sub, version, loss):
            """One shard's GRAD push; on failure the slice is lost (its
            seq burned) and only the reconnect verdict matters.  ``sub``
            re-keys the host code tree's arrays (no copy): `push`
            serializes them before it returns, or copies on park."""
            link = self.links[k]
            try:
                link.push(sub, version, loss)
                return True
            except TRANSPORT_ERRORS:
                return not closing.is_set() and link._reconnect()

        for link in self.links:
            link._session.start_heartbeat()
        # The K links are independent sockets: driven concurrently, a
        # step's wire latency stays about one round trip, not K.
        pool = ThreadPoolExecutor(max_workers=self.num_shards,
                                  thread_name_prefix="shard-router")
        try:
            while max_iters is None or it < max_iters:
                if (plan is not None
                        and plan.should_kill_worker(self.rank, it)):
                    from ..utils.faults import SimulatedCrash
                    raise SimulatedCrash(
                        f"FaultPlan: worker {self.rank} killed at "
                        f"iteration {it}")
                if plan is not None and plan.should_slow(self.rank):
                    time.sleep(plan.slow_delay_s)
                # A black-holed link goes silent both ways (pull and push
                # skipped here, heartbeats by the link_down latch) on a
                # live socket: at heal the same rank resumes on it.
                partitioned = [
                    plan is not None
                    and plan.should_partition(self.rank, k, it)
                    for k in range(self.num_shards)]
                for k, link in enumerate(self.links):
                    link.link_down = partitioned[k]
                futs = {k: pool.submit(pull_one, k)
                        for k in range(self.num_shards)
                        if not done[k] and not partitioned[k]}
                for k, fut in futs.items():
                    pulled = fut.result()
                    if pulled is _DEAD:
                        degrade(k)
                    elif pulled is None:  # DONE from this shard
                        done[k] = True
                    else:
                        degraded_count[k] = 0
                        degraded_dl[k] = None
                        versions[k], slice_params = pulled
                        leaves.update(slice_params)
                for k in range(self.num_shards):
                    if partitioned[k] and not done[k]:
                        degrade(k)
                check_partial()
                if all(done):
                    break
                if any(n not in leaves for n in names):
                    missing = [k for k in range(self.num_shards)
                               if any(n not in leaves
                                      for n in shard_names[k])]
                    if any(not done[k] for k in missing):
                        # A live but degraded shard has served no slice
                        # yet: nothing to reuse, the step is retried (the
                        # degraded bound owns the escalation).
                        it += 1
                        continue
                    # A shard died before serving its first slice: the
                    # whole tree cannot be assembled; over, not a hang.
                    break
                params = OrderedDict((n, leaves[n]) for n in names)
                if fn is None:
                    orders = ({n: o for n, p in params.items()
                               if (o := jax_order(n, tuple(p.shape)))
                               is not None}
                              if self.code.ordered else {})
                    fn = make_worker_step(loss_fn, self.code, transform,
                                          orders=orders)
                dev_params = tree_to_device(params, self.device)
                batch = tree_map(
                    lambda x: torch.as_tensor(x).to(self.device,
                                                    non_blocking=True),
                    batch_fn(self.rank, it))
                loss, codes = fn(dev_params, batch)
                self.grads_computed += 1
                # One device-to-host copy of the whole code tree and the
                # loss, then the split is a host-side re-keying.
                host_codes, host_loss = tree_to_host((codes, loss))
                codes_host = tree_map(_wire_leaf, host_codes)
                loss_f = float(host_loss.to(torch.float64))
                if (plan is not None
                        and plan.inject_nonfinite(self.rank, it)):
                    from ..utils.faults import poison_nonfinite
                    codes_host = poison_nonfinite(codes_host)
                futs = {}
                for k in range(self.num_shards):
                    if done[k]:
                        continue
                    if partitioned[k] or degraded_count[k] > 0:
                        # The slice cannot (or must not) reach shard k:
                        # dropped and counted; the shard's quorum or fill
                        # deadline absorbs it.  A failed push does not
                        # escalate a degraded shard (the pull side owns
                        # that bound).
                        self.fault_stats["partition_drops"] += 1
                        continue
                    sub = OrderedDict((n, codes_host[n])
                                      for n in shard_names[k])
                    futs[k] = pool.submit(push_one, k, sub, versions[k],
                                          loss_f)
                for k, fut in futs.items():
                    if not fut.result():
                        done[k] = dead[k] = True
                check_partial()
                # Overload injectors (flood_rank / burst_at): the whole
                # per-shard fan-out again per extra frame, fresh seqs.
                extra_f, extra_b = (plan.overload_extras(self.rank, it)
                                    if plan is not None else (0, 0))
                for i in range(extra_f + extra_b):
                    for k in range(self.num_shards):
                        if (done[k] or partitioned[k]
                                or degraded_count[k] > 0):
                            continue
                        sub = OrderedDict((n, codes_host[n])
                                          for n in shard_names[k])
                        push_one(k, sub, versions[k], loss_f)
                    self.fault_stats["flood_injected" if i < extra_f
                                     else "burst_injected"] += 1
                pushed += 1
                it += 1
        finally:
            # Latch first (no task redials), close the sockets (breaks a
            # task blocked in recv), then join the pool.
            closing.set()
            self.close()
            pool.shutdown(wait=True, cancel_futures=True)
            for link in self.links:
                for key, v in link.fault_snapshot().items():
                    if v:
                        self.fault_stats[key] = \
                            self.fault_stats.get(key, 0) + v
        return pushed
