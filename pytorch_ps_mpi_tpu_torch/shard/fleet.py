"""The PS fleet: K sharded `AsyncPSServer`s under one supervisor.

Counterpart of `pytorch_ps_mpi_tpu/shard/fleet.py`.  The K shards and
their standbys are threads of this process; router workers are processes
of their own (or threads, in the tests).

`PSFleet` is the server-group half of the sharded design (Li et al.,
OSDI 2014): it builds the `ShardPlan`, slices the parameter tree, and
runs one full `AsyncPSServer` per shard — each with its OWN version
counter, quorum/fill-deadline policy, robust reducer, eviction and
scoreboard bookkeeping, duplicate-seq suppression, and auto-checkpoint.
Every robustness mechanism of the single PS therefore
composes *per shard* with no new code paths: a shard is just a PS whose
pytree happens to be a slice.

The fleet adds the things K independent servers cannot do alone:

* **supervision** — each shard serves on its own thread; a shard killed
  by a `FaultPlan` (``kill_shard_at``) is rebuilt on the SAME port,
  restored from its own auto-checkpoint, and serves its remaining
  updates while workers ride their reconnect backoff across the gap
  (counted in ``fault_stats["shard_restores"]``);
* **hot-standby replication** (``replicas=1``) — every primary streams
  applied updates (REPL frames: the on-disk checkpoint format over the
  wire) to its own standby; on primary death the supervisor PROM-fences
  the standby and promotes it onto the primary's port with ZERO
  checkpoint rewind (``fault_stats["promotions"]``) — the server-group
  replication Li et al. (OSDI 2014) make first-class, and the reason a
  ``checkpoint_every=0`` fleet is no longer one crash from fatal;
* **coordinated snapshots** (``snapshot_every=N``) — Chandy–Lamport
  style SNAP markers arm every shard to checkpoint at one agreed fill
  boundary; the completed barrier is published as a ``ckpt.fleet.json``
  manifest (plan digest, per-shard path + step + sha256) and
  `resume_from` refuses — typed, never silently — skewed, partial, or
  re-written checkpoint sets;
* **one fleet view** — per-shard ``fault_stats`` snapshots (standbys
  and retired incarnations included) aggregate into a single dict
  (integer counters summed, per-shard detail kept under ``"shards"``)
  that renders through the same `utils.timing.format_fault_stats` line
  as a single PS.

On the card: each shard's serve loop, apply and publish run on that
shard's thread, on the card's default stream (every thread's current
stream unless it sets one).  A shard's device-to-host publish is ordered
after its own apply by that stream, so it never reads a tensor its apply
is still writing; the K shards' kernels queue on the one stream.  A
promotion applies the replicated blob on the supervisor's thread, on the
same stream, before the successor serves.  `serve` synchronizes the card
before it returns, so no shard's last update is still in flight.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time
from typing import Any, Callable

import torch

from ..errors import (FleetManifestError, FleetResumeSkewError,
                      NotCompiledError, ShardDeadError)
from ..multihost_async import AsyncPSServer, control_connect
from ..transport import (TRANSPORT_ERRORS, request_promotion,
                         request_snapshot)
from ..utils import checkpoint as _checkpoint
from ..utils.faults import SimulatedCrash
from .partition import FleetManifest, ShardInfo, ShardPlan, build_shard_plan


def shard_checkpoint_path(base, k: int) -> str:
    """Shard k's sibling of a fleet checkpoint path:
    ``ckpt.psz -> ckpt.shard3.psz`` (each shard checkpoints its own
    slice; a fleet checkpoint is the set of K siblings)."""
    root, ext = os.path.splitext(str(base))
    return f"{root}.shard{k}{ext}"


def fleet_manifest_path(base) -> str:
    """The fleet-manifest sibling of a fleet checkpoint path:
    ``ckpt.psz -> ckpt.fleet.json`` — the `shard.partition.FleetManifest`
    a coordinated snapshot writes and `PSFleet.resume_from` trusts."""
    root, _ext = os.path.splitext(str(base))
    return f"{root}.fleet.json"


def _shard_fault_plan(fault_plan, k: int):
    """The server-side fault plan shard ``k`` consults: its planned
    death (``kill_shard_at[k]``) becomes the shard's ``kill_ps_at``.
    Worker-side faults stay on the worker plans untouched."""
    if fault_plan is None:
        return None
    return fault_plan.shard_view(k)


class PSFleet:
    """Spawn and supervise a K-shard parameter-server fleet.

    Usage::

        fleet = PSFleet(model_named_params, num_shards=4, quota=4,
                        optim="sgd", lr=0.05)
        fleet.compile_step(loss_fn)
        hist = fleet.serve(steps=100, checkpoint_path="ckpt.psz",
                           checkpoint_every=10)

    ``rules`` is the optional ``[(regex, shard), ...]`` partition rule
    list (`shard.partition.build_shard_plan`); without it the split is
    pure size-balanced greedy.  ``ports`` is None (every shard
    ephemeral), a base int (shard k on ``base + k``), or an explicit
    list.  All other keyword arguments reach every shard's
    `AsyncPSServer` construction unchanged (device, quota, quorum,
    aggregate, anomaly_z, token, hyper, ...), so per-shard policy is
    exactly single-PS policy; ``device`` is the card unless the caller
    passes ``"cpu"``.
    """

    def __init__(self, named_params, *, num_shards: int, quota: int,
                 rules=None, host: str = "127.0.0.1", ports=None,
                 fault_plan=None, max_restores: int = 3,
                 replicas: int = 0, replica_every: int = 1, **server_kw):
        items = list(named_params.items()
                     if hasattr(named_params, "items") else named_params)
        self.plan: ShardPlan = build_shard_plan(items, num_shards,
                                                rules=rules)
        self.num_shards = num_shards
        self.quota = quota
        self.host = host
        if fault_plan is not None and fault_plan.kill_ps_at is not None:
            # shard_view would silently drop it (every shard's kill_ps_at
            # is rewritten from kill_shard_at): a chaos plan that names
            # no shard must be refused, not quietly ignored.
            raise ValueError(
                "kill_ps_at is ambiguous for a sharded fleet (which "
                "shard?) and would be silently dropped — use "
                "kill_shard_at={shard: update}")
        self.fault_plan = fault_plan
        self.max_restores = max_restores
        self._server_kw = dict(server_kw)
        self._loss_fn: "Callable | None" = None
        by_name = dict(items)
        self._shard_params = [
            [(n, by_name[n]) for n in self.plan.names_for(k)]
            for k in range(num_shards)]
        if ports is None:
            port_list = [0] * num_shards
        elif isinstance(ports, int):
            port_list = ([0] * num_shards if ports == 0
                         else [ports + k for k in range(num_shards)])
        else:
            port_list = list(ports)
            if len(port_list) != num_shards:
                raise ValueError(
                    f"{len(port_list)} ports for {num_shards} shards")
        # Hot-standby replication: with replicas=1, every
        # primary streams applied updates to its own standby
        # (`AsyncPSServer(standby=True)` on an ephemeral port); on
        # primary death the supervisor PROM-fences the standby and
        # promotes it onto the primary's port — no checkpoint rewind.
        if replicas not in (0, 1):
            raise ValueError(
                f"replicas must be 0 or 1 (one hot standby per shard), "
                f"got {replicas}")
        self.replicas = replicas
        self.replica_every = replica_every
        self.servers: "list[AsyncPSServer]" = []
        self.standbys: "list[AsyncPSServer]" = []
        self._standby_accept: "list[threading.Thread]" = []
        try:
            if replicas:
                for k in range(num_shards):
                    self.standbys.append(self._make_standby(k))
                    self._standby_accept.append(
                        self.standbys[k]._start_accept_thread())
            for k in range(num_shards):
                self.servers.append(self._make_server(k, port_list[k]))
        except BaseException:
            # A later shard failing to bind (port in use) must not leak
            # the earlier shards' bound listeners until interpreter
            # exit — a retry on the same base port would then fail on
            # the ports the dead fleet still holds.
            self.close()
            raise
        # Fleet-level counters (shard-level ones live on each server).
        self.fault_stats: "dict[str, Any]" = {"shard_restores": 0,
                                              "promotions": 0}
        # Per-shard supervision slots: serve outcome, resume point,
        # restore budget, and the checkpoint-persisted updates of
        # retired (crashed) incarnations.  Written by each shard's serve
        # thread, read by the supervisor only after join() —
        # single-owner by design.
        self._slots = [{"hist": None, "error": None, "start": 0,
                        "restores": 0, "restored_base": 0}
                       for _ in range(num_shards)]
        self._ckpt_paths: "list[str | None]" = [None] * num_shards
        self._ckpt_base = None
        self._checkpoint_every = 0
        # Fault snapshots of crashed-and-replaced shard incarnations:
        # their counters must keep counting in the fleet view, not
        # vanish with the object swap.
        self._retired: "list[tuple[int, dict]]" = []
        # Incarnation generation: bumped by every restore/promotion.  A
        # pending snapshot barrier whose armed cut died with a replaced
        # incarnation can never complete — the supervisor abandons it the
        # moment the generation moves instead of blocking every later
        # barrier for the full patience window.
        self._incarnation_gen = 0

    def _make_server(self, k: int, port: int,
                     consume_kill: bool = False) -> AsyncPSServer:
        """One shard server.  ``consume_kill`` builds the restored
        incarnation: its plan carries no ``kill_ps_at``, so a supervised
        restore cannot crash-loop on the same injection."""
        plan = _shard_fault_plan(self.fault_plan, k)
        if consume_kill and plan is not None:
            plan = dataclasses.replace(plan, kill_ps_at=None)
        # Dialable form: a fleet bound to 0.0.0.0 publishes its standby
        # addresses as wildcard binds, which are a listen surface, not a
        # dial target.
        replica_addr = (self._control_host(self.standbys[k].address)
                        if k < len(self.standbys) else None)
        return AsyncPSServer(
            self._shard_params[k], quota=self.quota, host=self.host,
            port=port,
            shard_info=ShardInfo(index=k, count=self.num_shards,
                                 plan=self.plan),
            fault_plan=plan,
            replica_addr=replica_addr, replica_every=self.replica_every,
            **self._server_kw)

    def _make_standby(self, k: int) -> AsyncPSServer:
        """Shard k's hot standby: a full server on an ephemeral port that
        only RECEIVES — REPL frames stash the primary's newest state, a
        PROM fences + reads it out.  Its fault plan has the shard's kill
        consumed (a promoted standby is the restored incarnation: it must
        not re-fire the injection that killed its primary), and it never
        compiles until promotion (K extra jit compiles per fleet would be
        pure waste on the happy path)."""
        plan = _shard_fault_plan(self.fault_plan, k)
        if plan is not None:
            plan = dataclasses.replace(plan, kill_ps_at=None)
        return AsyncPSServer(
            self._shard_params[k], quota=self.quota, host=self.host,
            port=0, standby=True,
            shard_info=ShardInfo(index=k, count=self.num_shards,
                                 plan=self.plan),
            fault_plan=plan,
            **self._server_kw)

    @property
    def addresses(self) -> "list[tuple[str, int]]":
        """(host, port) per shard, in shard order — what a
        `shard.ShardRouter` connects to."""
        return [srv.address for srv in self.servers]

    def describe(self) -> "dict[str, Any]":
        d = self.plan.describe()
        d["addresses"] = [list(a) for a in self.addresses]
        return d

    def compile_step(self, loss_fn: Callable) -> None:
        """Compile every shard's decode+update programs.  The loss_fn is
        also what a restored shard recompiles, so it is kept."""
        self._loss_fn = loss_fn
        for srv in self.servers:
            srv.compile_step(loss_fn)

    # -- checkpoint / resume --------------------------------------------------

    def resume_from(self, base_path) -> "list[int]":
        """Restore the whole fleet from ``base_path``'s checkpoint set.
        Returns the per-shard resume steps.

        Two paths, both refusing to stitch a mixed-epoch tree:

        * **manifest** (the blessed path): when ``<base>.fleet.json``
          exists, every shard restores from exactly the file the
          coordinated snapshot recorded — plan digest, per-file sha256,
          and one agreed cut all verified BEFORE any shard state is
          touched (`FleetManifestError` / `FleetResumeSkewError`);
        * **legacy siblings**: without a manifest, the per-shard
          ``ckpt.shardK.psz`` siblings are peeked first and refused with
          a typed `FleetResumeSkewError` if their recorded steps differ
          (including a missing sibling while others exist — a shard at
          "scratch" among shards at step N is maximal skew).  All-absent
          means a fresh start."""
        manifest_path = fleet_manifest_path(base_path)
        if os.path.exists(manifest_path):
            return self._resume_from_manifest(manifest_path)
        # Peek every sibling's recorded step BEFORE restoring anything:
        # skew must be detected while all shard states are still intact.
        # The decoded trees are kept so the restore below applies them
        # from memory — one deserialization per sibling, not two.
        paths = [shard_checkpoint_path(base_path, k)
                 for k in range(self.num_shards)]
        steps: "dict[int, int | None]" = {}
        peeked: "dict[int, tuple]" = {}
        for k, path in enumerate(paths):
            if not os.path.exists(path):
                steps[k] = None
                continue
            arrays, meta = _checkpoint.load(path, with_meta=True)
            peeked[k] = (arrays, meta)
            steps[k] = int((meta or {}).get("step") or 0)
        present = {k: s for k, s in steps.items() if s is not None}
        if not present:
            for k in range(self.num_shards):
                self._slots[k]["start"] = 0
            return [0] * self.num_shards
        if len(present) < self.num_shards or len(set(present.values())) > 1:
            detail = ", ".join(
                f"shard {k}: "
                f"{'missing' if steps[k] is None else f'step {steps[k]}'}"
                for k in range(self.num_shards))
            raise FleetResumeSkewError(
                f"per-shard checkpoints under {base_path!r} were taken "
                f"at different update counts ({detail}) — restoring them "
                f"together would stitch a parameter tree from multiple "
                f"epochs; resume from a coordinated fleet snapshot (its "
                f"{os.path.basename(manifest_path)!r} manifest is the "
                f"blessed path)")
        starts = []
        for k, srv in enumerate(self.servers):
            # Same pieces as `AsyncPSServer.resume_from`, applied from
            # the peeked decode instead of re-reading the file.
            arrays, meta = peeked[k]
            info = _checkpoint.apply_optimizer(srv, arrays, meta,
                                               source=repr(paths[k]))
            srv._apply_resume_extra(info.get("extra") or {})
            start = int(info.get("step") or 0)
            self._slots[k]["start"] = start
            starts.append(start)
        return starts

    def _resume_from_manifest(self, manifest_path) -> "list[int]":
        """The manifest-verified resume: refuse BEFORE touching any shard
        state, then restore each shard from exactly the recorded file."""
        with open(manifest_path, "rb") as f:
            try:
                manifest = FleetManifest.from_json(f.read())
            except (ValueError, KeyError, TypeError) as exc:
                raise FleetManifestError(
                    f"unreadable fleet manifest {manifest_path!r}: "
                    f"{exc}") from exc
        if (manifest.num_shards != self.num_shards
                or manifest.plan_digest != self.plan.digest()):
            raise FleetManifestError(
                f"fleet manifest {manifest_path!r} was written by a "
                f"{manifest.num_shards}-shard fleet with plan digest "
                f"{manifest.plan_digest:#x}, but this fleet has "
                f"{self.num_shards} shards with digest "
                f"{self.plan.digest():#x} — the split disagrees, the "
                f"slices would not reassemble the same tree")
        skewed = manifest.skewed_entries()
        if skewed:
            raise FleetResumeSkewError(
                f"fleet manifest {manifest_path!r} records shards at "
                f"different update counts than its cut "
                f"{manifest.cut}: {skewed} — a coordinated snapshot "
                f"never writes this; the manifest was hand-edited or "
                f"assembled from mixed barriers")
        base_dir = os.path.dirname(os.path.abspath(manifest_path))
        paths = []
        for k in range(self.num_shards):
            entry = manifest.entry(k)
            path = os.path.join(base_dir, entry["path"])
            if not os.path.exists(path):
                raise FleetManifestError(
                    f"fleet manifest {manifest_path!r} names "
                    f"{entry['path']!r} for shard {k} but the file is "
                    f"missing — the checkpoint set is partial, "
                    f"restoring the rest would freeze shard {k} at "
                    f"construction-time params")
            digest = _checkpoint.file_digest(path)
            if digest != entry["sha256"]:
                raise FleetManifestError(
                    f"shard {k} checkpoint {entry['path']!r} hashes to "
                    f"{digest[:16]}… but the manifest recorded "
                    f"{str(entry['sha256'])[:16]}… — the file was "
                    f"re-written (or corrupted) after the coordinated "
                    f"cut; it is not the slice this snapshot took")
            paths.append(path)
        starts = []
        for k, srv in enumerate(self.servers):
            start = srv.resume_from(paths[k])
            if start != manifest.cut:
                raise FleetManifestError(
                    f"shard {k} checkpoint restored to step {start}, "
                    f"not the manifest cut {manifest.cut}")
            self._slots[k]["start"] = start
            starts.append(start)
        return starts

    # -- supervision ----------------------------------------------------------

    def _serve_shard(self, k: int, steps: int, serve_kw: dict) -> None:
        slot = self._slots[k]
        try:
            slot["hist"] = self.servers[k].serve(
                steps=max(steps - slot["start"], 0),
                start_step=slot["start"],
                checkpoint_path=self._ckpt_paths[k],
                **serve_kw)
        except BaseException as exc:  # recorded; supervisor decides
            slot["error"] = exc

    def _control_host(self, addr) -> "tuple[str, int]":
        """A connectable (host, port) for a fleet-internal control dial:
        the wildcard bind address is a listen surface, not a dial
        target."""
        host, port = addr
        return ("127.0.0.1" if host in ("0.0.0.0", "::") else host), port

    def _promote_standby(self, k: int) -> "int | None":
        """Promote shard ``k``'s hot standby onto the dead primary's
        port.  Returns the step the successor resumes serving from (the
        primary's last replicated update — ZERO rewind at the default
        per-update cadence), or None when the standby holds nothing to
        promote (death before the first REPL) and the checkpoint path
        must decide instead.

        Order is load-bearing: (1) PROM-fence the standby over the wire
        so a zombie primary across a partition can no longer write into
        the successor's state; (2) retire the dead primary's counters and
        close it (freeing the port); (3) apply the replicated blob +
        compile; (4) rebind onto the primary's port; (5) give the
        promoted server a FRESH standby so a second death is survivable
        too."""
        standby = self.standbys[k]
        if standby.replica_step() is None:
            return None
        old = self.servers[k]
        port = old.address[1]
        token = self._server_kw.get("token")
        try:
            host, sport = self._control_host(standby.address)
            sock = control_connect(host, sport, token=token, timeout=5.0)
            try:
                request_promotion(sock, self.plan.digest())
            finally:
                sock.close()
        except TRANSPORT_ERRORS + (ValueError,):
            # The wire fence is best-effort belt-and-suspenders in the
            # in-process deployment: `promote_from_replica` latches the
            # same fence under the replication lock.
            pass
        self._retired.append((k, old._fault_stats_snapshot()))
        old.close()
        # Stop the standby's replication accept loop before stealing its
        # listener; serve() starts a fresh one on the rebound port.
        standby._net_stop.set()
        try:
            standby._listener.close()
        except OSError:  # pragma: no cover - close best-effort
            pass
        if k < len(self._standby_accept):
            self._standby_accept[k].join(timeout=5.0)
        start = standby.promote_from_replica()
        if start is None:  # pragma: no cover - guarded by replica_step()
            return None
        standby.compile_step(self._loss_fn)
        standby.rebind(port)
        # Chain availability: the promoted primary streams to a fresh
        # standby of its own, so the NEXT death promotes again instead
        # of falling back to a checkpoint rewind.
        fresh = self._make_standby(k)
        self.standbys[k] = fresh
        self._standby_accept[k] = fresh._start_accept_thread()
        standby.replica_addr = self._control_host(fresh.address)
        standby.replica_every = self.replica_every
        self.servers[k] = standby
        self._slots[k]["start"] = start
        # Absolute-assignment contract, same as `_restore_shard`: the
        # replicated step already covers every earlier incarnation's
        # updates — assignment, never accumulation.
        self._slots[k]["restored_base"] = start
        self._slots[k]["restores"] += 1
        self.fault_stats["promotions"] += 1
        self._incarnation_gen += 1
        print(f"PS fleet: promoted standby for shard {k} on port {port} "
              f"at replicated step {start} (zero checkpoint rewind)",
              file=sys.stderr)
        return start

    def _restore_shard(self, k: int) -> None:
        """Rebuild a dead shard on its old port and restore it from its
        own auto-checkpoint (or from scratch if it died before the first
        snapshot).  The crashed incarnation's fault counters are retired
        into the fleet view (they must keep counting, not vanish with
        the object swap), and its planned kill is consumed
        (`_make_server(consume_kill=True)`) so a supervised restore
        cannot crash-loop on the same injection."""
        old = self.servers[k]
        port = old.address[1]
        self._retired.append((k, old._fault_stats_snapshot()))
        old.close()
        srv = self._make_server(k, port, consume_kill=True)
        srv.compile_step(self._loss_fn)
        start = 0
        path = (_checkpoint.latest_checkpoint(self._ckpt_paths[k])
                if self._ckpt_paths[k] else None)
        if path is not None:
            start = srv.resume_from(path)
        self.servers[k] = srv
        self._slots[k]["start"] = start
        # The retired incarnations' checkpoint-persisted updates stay in
        # the fleet's updates_total (their serves raised, so they
        # returned no history of their own).  ``start`` is the ABSOLUTE
        # resume step — it already covers every earlier incarnation, so
        # assignment, not accumulation (+= would double-count prior
        # restores on a second death).
        self._slots[k]["restored_base"] = start
        self._slots[k]["restores"] += 1
        self.fault_stats["shard_restores"] += 1
        self._incarnation_gen += 1
        print(f"PS fleet: restored shard {k} on port {port} from "
              f"{'checkpoint step ' + str(start) if start else 'scratch'}",
              file=sys.stderr)

    def serve(self, steps: int, log_every: int = 0,
              idle_timeout: float = 300.0, *,
              eviction_timeout: float = 30.0,
              dead_conn_grace: float = 2.0,
              checkpoint_path=None,
              checkpoint_every: int = 0,
              snapshot_every: int = 0,
              warmup_steps: int = 0) -> "dict[str, Any]":
        """Serve until every shard has applied ``steps`` updates.

        Each shard runs the unmodified `AsyncPSServer.serve` on its own
        thread with its own checkpoint sibling.  On a *planned* shard
        death (`SimulatedCrash` — the ``kill_shard_at`` injection) the
        supervisor first tries to PROMOTE the shard's hot standby (zero
        checkpoint rewind; ``replicas=1``), then falls back to restoring
        from the shard's own auto-checkpoint; both are bounded by
        ``max_restores`` per shard.  Any other failure (fleet dead, fill
        starved, ...) stops the fleet and re-raises — a sick fleet must
        fail loudly, not limp with K-1 shards silently diverging.

        ``snapshot_every``: coordinated fleet snapshots — roughly every N
        updates the supervisor proposes a cut just ahead of the furthest
        shard, injects SNAP markers, and once every shard's step-tagged
        cut checkpoint lands, writes the ``ckpt.fleet.json`` manifest
        (plan digest + per-shard path/step/sha256) that `resume_from`
        verifies.  Needs ``checkpoint_path``."""
        if self._loss_fn is None:
            raise NotCompiledError(
                "call compile_step(loss_fn) before serve()")
        if checkpoint_every and not checkpoint_path:
            raise ValueError("checkpoint_every needs a checkpoint_path")
        if snapshot_every and not checkpoint_path:
            raise ValueError("snapshot_every needs a checkpoint_path")
        self._ckpt_base = checkpoint_path
        self._ckpt_paths = [
            shard_checkpoint_path(checkpoint_path, k) if checkpoint_path
            else None for k in range(self.num_shards)]
        self._checkpoint_every = checkpoint_every
        serve_kw = dict(log_every=log_every, idle_timeout=idle_timeout,
                        eviction_timeout=eviction_timeout,
                        dead_conn_grace=dead_conn_grace,
                        checkpoint_every=checkpoint_every,
                        warmup_steps=warmup_steps)
        threads: "dict[int, threading.Thread]" = {}

        def launch(k: int) -> None:
            t = threading.Thread(target=self._serve_shard,
                                 args=(k, steps, serve_kw),
                                 daemon=True, name=f"ps-fleet-shard-{k}")
            threads[k] = t
            t.start()

        t_start = time.perf_counter()
        for k in range(self.num_shards):
            launch(k)
        # Coordinated-snapshot barrier state (one in flight at a time).
        snap_state = ({"next_at": snapshot_every, "pending": None}
                      if snapshot_every else None)
        fatal: "BaseException | None" = None
        while True:
            alive = False
            for k, t in list(threads.items()):
                t.join(timeout=0.1)
                if t.is_alive():
                    alive = True
                    continue
                slot = self._slots[k]
                err, slot["error"] = slot["error"], None
                if err is None:
                    continue
                # Checkpoint-restorable only when checkpointing is
                # actually LIVE: a periodic cadence > 0, or a resume /
                # coordinated-snapshot checkpoint already on disk
                # (`latest_checkpoint` resolves step-tagged SNAP-cut
                # siblings too).  A path with cadence 0 and no file
                # would "restore" the slice to construction-time params.
                ckpt_live = (self._ckpt_paths[k] is not None
                             and (self._checkpoint_every > 0
                                  or _checkpoint.latest_checkpoint(
                                      self._ckpt_paths[k]) is not None))
                budget_ok = slot["restores"] < self.max_restores
                if isinstance(err, SimulatedCrash) and fatal is None:
                    # Recovery ladder: standby promotion first (zero
                    # rewind — this is what makes checkpoint_every=0
                    # fleets survive a crash), checkpoint restore second.
                    promoted = (self.standbys and budget_ok
                                and self._promote_standby(k) is not None)
                    if promoted or (ckpt_live and budget_ok):
                        if not promoted:
                            self._restore_shard(k)
                        launch(k)
                        alive = True
                    else:
                        # Died but cannot come back: nothing replicated,
                        # no checkpoint, or the budget is spent.
                        standby_note = (
                            "standby empty" if self.standbys
                            else "no standby")
                        fatal = ShardDeadError(
                            f"shard {k} died and cannot be restored "
                            f"({standby_note}, checkpointing "
                            f"{'on' if ckpt_live else 'off'}, "
                            f"{slot['restores']}/{self.max_restores} "
                            f"restores used)")
                        fatal.__cause__ = err
                        self.close()
                elif fatal is None:
                    fatal = err
                    # Stop admitting traffic everywhere; the remaining
                    # serve threads wind down on their own error paths
                    # (drained queues -> fleet-dead inside idle_timeout).
                    self.close()
            if snap_state is not None and fatal is None:
                self._drive_snapshots(snap_state, snapshot_every, steps,
                                      idle_timeout)
            if not alive:
                break
        if fatal is not None:
            raise fatal
        # No shard's last update may still be in flight when control
        # returns (its optimizer state is written after the publish's
        # copy was queued on the card's stream).
        for srv in self.servers:
            if srv.ps_device.type == "cuda":
                torch.cuda.synchronize(srv.ps_device)
        wall = time.perf_counter() - t_start

        per_shard = [slot["hist"] for slot in self._slots]
        reference = next((h for h in per_shard if h), {})
        history: "dict[str, Any]" = {
            "per_shard": per_shard,
            # The fleet-level curves mirror shard 0's view (every shard
            # records the same worker losses modulo fill timing).
            "losses": list(reference.get("losses", [])),
            "staleness": list(reference.get("staleness", [])),
            # Restored shards' serve segments start at their checkpoint
            # step: the retired incarnations' checkpoint-persisted
            # updates (restored_base) count too, so a crash-resume run
            # reports ~steps per shard, not steps-minus-checkpoint.
            "updates_total": (sum(len(h["losses"])
                                  for h in per_shard if h)
                              + sum(s["restored_base"]
                                    for s in self._slots)),
            "grads_consumed": sum(h.get("grads_consumed", 0)
                                  for h in per_shard if h),
            "wall_time": wall,
            # Steady-state window (``warmup_steps``): the SLOWEST
            # shard's post-warmup wall — conservative for aggregate
            # throughput math in the wire-evidence harness.
            "steady_wall_time": max(
                (h.get("steady_wall_time", wall)
                 for h in per_shard if h), default=wall),
            "warmup_steps": warmup_steps,
            "fault_stats": self.fleet_fault_stats(),
        }
        return history

    def save_checkpoint(self, base_path, step: int) -> "list[str]":
        """Write every shard's checkpoint sibling through the server's
        own path (`AsyncPSServer._auto_checkpoint` — it records the
        serving version counter a later resume needs for continuous
        staleness accounting) plus the fleet manifest: the fleet is
        quiescent here, so the K same-step siblings ARE a consistent cut
        and `resume_from` gets its blessed (verified) path.  Returns the
        written paths."""
        paths = []
        for k, srv in enumerate(self.servers):
            path = shard_checkpoint_path(base_path, k)
            srv._auto_checkpoint(path, step)
            paths.append(path)
        self._write_manifest(base_path, step, paths)
        return paths

    # -- coordinated snapshots (the SNAP barrier) -----------------------------

    def _write_manifest(self, base_path, cut: int,
                        paths: "list[str]") -> str:
        """Record a completed barrier: per-shard path (relative to the
        manifest's directory), the one agreed cut, and a sha256 of each
        file's bytes — what `resume_from` verifies before touching any
        shard state.  Atomic (tmp+rename), like every checkpoint."""
        mpath = fleet_manifest_path(base_path)
        base_dir = os.path.dirname(os.path.abspath(mpath))
        entries = [{"shard": k,
                    "path": os.path.relpath(os.path.abspath(p), base_dir),
                    "step": cut,
                    "sha256": _checkpoint.file_digest(p)}
                   for k, p in enumerate(paths)]
        manifest = FleetManifest(plan_digest=self.plan.digest(),
                                 num_shards=self.num_shards, cut=cut,
                                 shards=entries)
        _checkpoint._atomic_write(mpath, manifest.to_json().encode())
        return mpath

    def _send_snap_markers(self, cut: int) -> bool:
        """Inject one SNAP marker per shard over rank-less control
        connections.  True only when EVERY shard armed the cut — a
        refusal (the shard already passed it) or an unreachable shard
        abandons this round; the supervisor re-proposes a later cut."""
        token = self._server_kw.get("token")
        for srv in self.servers:
            try:
                host, port = self._control_host(srv.address)
                sock = control_connect(host, port, token=token,
                                       timeout=5.0)
                try:
                    armed = request_snapshot(sock, cut)
                finally:
                    sock.close()
            except TRANSPORT_ERRORS + (ValueError,):
                return False
            if armed != cut:
                return False
        return True

    def _drive_snapshots(self, state: dict, snapshot_every: int,
                         steps: int, patience: float) -> None:
        """One supervisor tick of the barrier state machine: propose a
        cut just AHEAD of the furthest shard once the cadence is due
        (every shard can then checkpoint at exactly that boundary —
        the Chandy–Lamport marker discipline with per-shard update
        counters as the channel), then poll for the K step-tagged cut
        files and publish the manifest when all have landed."""
        now = time.perf_counter()
        pending = state["pending"]
        if pending is not None:
            cut, paths, deadline, gen = pending
            if all(os.path.exists(p) for p in paths):
                mpath = self._write_manifest(self._ckpt_base, cut, paths)
                state["pending"] = None
                state["next_at"] = cut + snapshot_every
                print(f"PS fleet: coordinated snapshot at cut {cut} -> "
                      f"{mpath}", file=sys.stderr)
            elif gen != self._incarnation_gen or now > deadline:
                # A shard was replaced mid-barrier (its armed cut died
                # with the old incarnation — the file can never appear;
                # abandon NOW, not after the whole patience window) or
                # the fleet stalled past the deadline.  Either way a
                # partial set must never become a manifest; the cadence
                # re-proposes after recovery.
                state["pending"] = None
                state["next_at"] = cut + snapshot_every
                why = ("a shard incarnation was replaced mid-barrier"
                       if gen != self._incarnation_gen
                       else f"shards did not all reach it in "
                            f"{patience:.0f}s")
                print(f"PS fleet: abandoned snapshot barrier at cut "
                      f"{cut} ({why})", file=sys.stderr)
            return
        progress = [srv.applied_updates() for srv in self.servers]
        if max(progress) < state["next_at"]:
            return
        # Margin 2: the marker must land BEFORE any shard reaches the
        # cut; shards ack/refuse, so a lost race only costs a retry.
        cut = max(progress) + 2
        if cut >= steps:
            return  # the run ends first; save_checkpoint cuts the final
        if self._send_snap_markers(cut):
            paths = [_checkpoint.step_path(self._ckpt_paths[k], cut)
                     for k in range(self.num_shards)]
            state["pending"] = (cut, paths, now + patience,
                                self._incarnation_gen)
        else:
            # Refused somewhere: bump the floor so the next tick
            # proposes a strictly later cut instead of spinning.
            state["next_at"] = max(progress) + 1

    # -- the one fleet view ---------------------------------------------------

    def fleet_fault_stats(self) -> "dict[str, Any]":
        """Aggregate the per-shard ``fault_stats`` snapshots: integer
        counters sum fleet-wide (so ``format_fault_stats`` renders one
        line for the whole fleet), full per-shard snapshots stay under
        ``"shards"`` keyed by shard index, and the fleet's own counters
        (``shard_restores``) ride along."""
        agg: "dict[str, Any]" = dict(self.fault_stats)
        shards: "dict[str, Any]" = {}
        # Crashed-and-replaced incarnations keep counting: their final
        # snapshots aggregate alongside the live servers' and stay
        # inspectable under "shards" as "<k>:retired<i>".
        retired = [(f"{k}:retired{i}", snap)
                   for i, (k, snap) in enumerate(self._retired)]
        live = [(str(k), srv._fault_stats_snapshot())
                for k, srv in enumerate(self.servers)]
        # Hot standbys count too (repl_received / repl_refused live on
        # the receiving side): same key-parity contract as every shard.
        standbys = [(f"{k}:standby", sb._fault_stats_snapshot())
                    for k, sb in enumerate(self.standbys)]
        for name, snap in retired + live + standbys:
            shards[name] = snap
            for key, value in snap.items():
                if isinstance(value, bool):
                    continue
                if key == "workers_seen":
                    # Identity is fleet-wide (one rank per worker on
                    # every shard): summing would report K x W workers.
                    agg[key] = max(agg.get(key, 0), value)
                elif key == "repl_lag":
                    # A GAUGE, not a counter: the fleet-level figure is
                    # the worst LIVE primary's unacked lag — summing K
                    # instantaneous gauges (plus dead incarnations'
                    # final values) would read as lag nobody has.
                    continue
                elif isinstance(value, int):
                    agg[key] = agg.get(key, 0) + value
                elif key == "dropped_queue_full":
                    merged = agg.setdefault(key, {})
                    for rank, n in value.items():
                        merged[rank] = merged.get(rank, 0) + n
                elif key == "groups":
                    # The hierarchy's view: every shard books the same
                    # fleet-wide aggregator and fallback identities, so
                    # the fleet entry keeps those and sums the per-shard
                    # AGGR traffic.
                    merged = agg.setdefault(key, {})
                    for g, info in value.items():
                        cur = merged.get(g)
                        if cur is None:
                            merged[g] = dict(
                                info, fallback_ranks=list(
                                    info.get("fallback_ranks", [])))
                            continue
                        cur["agg_frames"] = (cur.get("agg_frames", 0)
                                             + info.get("agg_frames", 0))
                        cur["last_contributors"] = info.get(
                            "last_contributors",
                            cur.get("last_contributors", 0))
                        for r in info.get("fallback_ranks", []):
                            if r not in cur.setdefault(
                                    "fallback_ranks", []):
                                cur["fallback_ranks"].append(r)
        agg["repl_lag"] = max((snap.get("repl_lag", 0)
                               for _n, snap in live), default=0)
        agg["shards"] = shards
        return agg

    def close(self) -> None:
        for srv in self.servers:
            srv.close()
        for sb in self.standbys:
            sb.close()
        # The standbys' accept loops end within their poll once their
        # listeners are closed: joined, so no thread of the fleet outlives
        # it (a thread left running at interpreter exit can abort it).
        for t in self._standby_accept:
            t.join(timeout=5.0)
