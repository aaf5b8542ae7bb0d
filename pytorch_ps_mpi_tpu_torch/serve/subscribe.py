"""Versioned snapshot subscription — the serve tier's read client.

Counterpart of `pytorch_ps_mpi_tpu/serve/subscribe.py`.  A `Subscriber`
dials a PS (or, through `FleetSubscriber`, every shard of a fleet) as a
rank-less READER (HELO flag bit 32) and keeps a local, versioned copy of
the served parameters over the ``SUBS``/``DELT`` round trip:

* the FIRST read is a full snapshot at a consistent version, served
  from the server's encode-once PARM cache (N subscribers cost one
  encode per version, as N pulling workers do);
* every later poll is CONDITIONAL: ``SUBS | have`` at the served
  version answers a head-only "unchanged" frame (no encode, no payload,
  no decode), and a version advance answers the new snapshot;
* the payload self-describes its wire encoding (the v12 codec byte:
  identity/bf16/int8, decoded through `ops.codecs`), and on a
  ``delta_parm`` server a version advance may arrive as a SPARSE DIFF
  against the presented version (flags bit 4), patched onto the cached
  tree to land bitwise on the full decode, with a full snapshot whenever
  the server's ring misses (and always after a redial: ``have`` is
  forced unversioned);
* reader traffic is READ-class end to end: requests go through
  `transport.Session.send_read` (a credit budget of its own), and the
  server's full-payload replies spend a per-version read-token budget
  that sheds head-only (``read_shed``) when readers outrun training.  A
  shed read serves the CACHED snapshot: the reader degrades to bounded
  staleness.

The tree is host memory, as a worker's pulled tree is: numpy leaves,
and CPU tensors for bfloat16 leaves.  It owns its memory: the serializer
decodes each payload into a fresh arena (never a view of the receive
ring), and a delta writes into fresh arrays, never into the cached tree.

Failover: a lost connection redials with the shared jittered `Backoff`
ladder and re-presents the reader HELO; the conditional-read cache does
NOT survive the redial (a restored server may re-serve a version NUMBER
with different bytes), so the first read after it is a forced full
snapshot.  Versions are tracked across the subscription: an observed
rewind is counted (``version_rewinds``) and the snapshot adopted, or
raised as `SnapshotRewindError` under ``on_rewind="raise"``.

A fleet's reader, `FleetSubscriber`, holds one `Subscriber` per shard
(``expect_shard`` pins each link to its slot), fetches the plan from shard
0 and checks its digest against every link, and assembles the full tree
from the per-shard slices; its version is the tuple of per-shard versions
(the fleet has no single one).  A shard's failover (a promoted standby or
a restored shard on the same port) is a redial of that link: its next
read is a full snapshot of the slice.
"""

from __future__ import annotations

import socket
import struct
import time
from collections import OrderedDict
from typing import Any, Callable

import numpy as np

from .. import transport as _transport
from ..errors import FleetDeadError, SnapshotRewindError
from ..multihost_async import (_DELT_DELTA, _DELT_SHED, _DELT_UNCHANGED,
                               _UNVERSIONED, PROTOCOL_VERSION)
from ..native import serializer
from ..ops.codecs import apply_wire_delta, decode_wire_tree
from ..transport import (TRANSPORT_ERRORS, Deadline, DeadlineExpired,
                         Session)
from ..utils.backoff import Backoff

_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")
# The v12 codec-id byte on DELT replies.
_U8 = struct.Struct("B")


def _shed_now() -> Deadline:
    """The shed-now deadline of a request/response read: `send_read`
    sheds at a closed gate instead of parking (an unsent request elicits
    no reply, so a parked one would wait for a replenish that never
    comes)."""
    return Deadline(0.0)


class Subscriber:
    """One read-only subscription to one PS.

    Usage::

        sub = Subscriber("ps-host", 5555)
        version, params = sub.snapshot()        # first full read
        while not sub.done:
            version, params, changed = sub.poll()
            if changed:
                hot_swap(params)                # in-flight work finishes
                                                # on the old tree

    ``expect_shard`` pins which fleet slot this connection must land on
    (`FleetSubscriber` sets it); a plain subscriber refuses a sharded
    server — it would cache one shard's slice as the whole model.
    """

    def __init__(self, host: str, port: int, *,
                 token: "str | None" = None,
                 io_timeout: float = 30.0,
                 reconnect_retries: int = 5,
                 backoff_max: float = 1.0,
                 read_backoff: float = 0.5,
                 op_deadline: "float | None" = None,
                 expect_shard: "int | None" = None,
                 on_rewind: str = "count",
                 nonblock_heal: bool = False):
        if on_rewind not in ("count", "raise"):
            raise ValueError(
                f"on_rewind must be 'count' or 'raise', got {on_rewind!r}")
        # ``nonblock_heal``: the serving path's healing policy — a
        # transport error makes `poll` return the cached snapshot at once
        # and retry ONE bounded dial per backoff window, instead of
        # blocking the caller through the redial ladder.  A decode loop
        # hot-swapping through this subscription keeps its per-step
        # latency bound while the PS is down; the default (blocking
        # ladder, then raise) suits a reader whose job is the read.
        self.nonblock_heal = bool(nonblock_heal)
        self._heal_dl: "Deadline | None" = None
        self.host, self.port = host, int(port)
        self.token = token or None  # "" behaves exactly like unset
        self.io_timeout = io_timeout
        self.reconnect_retries = reconnect_retries
        self.backoff_max = backoff_max
        # How long to believe a zeroed read window before probing once
        # through the `open_read` valve: a shed server costs seconds of
        # staleness, never a dead subscription.
        self.read_backoff = float(read_backoff)
        self.op_deadline = op_deadline
        self.on_rewind = on_rewind
        self._expect_shard = expect_shard
        self.shard_index = 0
        self.num_shards = 1
        self.plan_digest = 0
        # The subscription state: the last decoded (version, params) and
        # the high-water version of the rewind detector.
        self.version: "int | None" = None
        self.params: "Any | None" = None
        self.done = False
        self._max_version: "int | None" = None
        # Reads after a redial are FULL: a restored server may re-serve
        # a version number with different bytes.
        self._force_full = False
        self._shed_dl: "Deadline | None" = None
        self.reconnects = 0
        # Reader-side counters (rendered by `format_fault_stats`); the
        # session's READ-gate counters merge in via `fault_snapshot`.
        self.fault_stats: "dict[str, int]" = {
            "reads_served": 0, "read_shed": 0, "delta_frames": 0,
            "version_rewinds": 0, "deadline_expired": 0}
        self._session: "Session | None" = None
        self._recv_arena = _transport.RecvArena(nbufs=2)
        self._rng = np.random.default_rng(
            np.random.SeedSequence([0, 0x5EED]))
        self._connect()

    # -- connection management ------------------------------------------------

    def _connect(self, dial_budget: "float | None" = None) -> None:
        """Dial and HELO as a reader (flag bit 32): authenticated,
        rank-less, counted in the server's ``subs_active`` gauge.
        ``dial_budget`` bounds this one dial tighter than io_timeout (the
        non-blocking heal's single probe)."""
        dial = Deadline(self.io_timeout if dial_budget is None
                        else min(dial_budget, self.io_timeout))
        sock = socket.create_connection((self.host, self.port),
                                        timeout=dial.timeout())
        try:
            sock.settimeout(dial.timeout())
            try:
                sock.setsockopt(socket.IPPROTO_TCP,
                                socket.TCP_NODELAY, 1)
            except OSError:  # pragma: no cover - non-TCP transports
                pass
            _transport.send_frame(
                sock, b"HELO" + bytes([32])
                + (self.token.encode() if self.token else b""))
            reply = _transport.recv_frame(sock)
            if reply == b"NOAU":
                raise ValueError(
                    "server refused the subscription token (launch the "
                    "subscriber with the server's --token)")
            if reply[:3] != b"PSA" or reply[3] != PROTOCOL_VERSION:
                raise ValueError(
                    f"incompatible peer: subscription needs protocol "
                    f"v{PROTOCOL_VERSION} (reply {reply[:4]!r}) — run "
                    f"matching releases on both ends")
            auth_enforced = reply[8:9] == b"\x01"
            if self.token and not auth_enforced:
                raise ValueError(
                    "this subscriber was given a token but the server "
                    "is not enforcing one — refusing to read from an "
                    "open PS port")
            shard_index, num_shards, plan_digest = struct.unpack_from(
                "<HHQ", reply, 9)
            if self._expect_shard is None and num_shards > 1:
                raise ValueError(
                    f"this server is shard {shard_index} of a "
                    f"{num_shards}-shard fleet; a plain subscriber "
                    f"would cache one slice as the whole model — "
                    f"subscribe through serve.FleetSubscriber (CLI: "
                    f"--subscribe with all {num_shards} endpoints)")
            if (self._expect_shard is not None
                    and shard_index != self._expect_shard):
                raise ValueError(
                    f"endpoint order mismatch: expected fleet shard "
                    f"{self._expect_shard} at {self.host}:{self.port} "
                    f"but the server identifies as shard {shard_index} "
                    f"of {num_shards} — list endpoints in shard order")
            self.shard_index, self.num_shards = shard_index, num_shards
            self.plan_digest = plan_digest
        except BaseException:
            sock.close()
            raise
        if self._session is None:
            self._session = Session(sock, io_timeout=self.io_timeout)
        else:
            self._session.adopt(sock)
        # Version numbers are only comparable within one server lifetime,
        # so the next read is a full one; the READ window is
        # incarnation-scoped for the same reason (a zero the dead server
        # advertised must not gate its successor).
        self._session.reset_read()
        self._shed_dl = None
        self._force_full = True

    def _reconnect(self) -> bool:
        ladder = Backoff(base=0.1, maximum=self.backoff_max,
                         retries=self.reconnect_retries, rng=self._rng)
        for _attempt in ladder.sleeps():
            try:
                self._connect()
            except TRANSPORT_ERRORS:
                continue
            self.reconnects += 1
            return True
        return False

    def close(self) -> None:
        if self._session is not None:
            self._session.close()

    def fault_snapshot(self) -> "dict[str, int]":
        """Reader counters plus the session's READ-gate counts — one dict
        `format_fault_stats` renders."""
        snap = dict(self.fault_stats)
        if self._session is not None:
            for k, v in self._session.stats.items():
                snap[k] = snap.get(k, 0) + v
        return snap

    # -- wire helpers ---------------------------------------------------------

    def _recv(self, deadline: "Deadline | None" = None):
        return self._session.recv(deadline, into=self._recv_arena)

    def _fetch_plan(self):
        """The fleet's authoritative `shard.partition.ShardPlan` over the
        SPLN round trip (`FleetSubscriber`'s agreement at HELO time, as
        the router's).  A plain PS serves an empty plan, refused."""
        from ..shard.partition import ShardPlan

        self._session.send(b"SPLN")
        reply = self._recv(Deadline(self.op_deadline))
        if bytes(reply[:4]) != b"SPLN":
            raise ValueError(
                f"unexpected reply {bytes(reply[:4])!r} to the "
                f"shard-plan request")
        body = bytes(reply[4:])
        if not body:
            raise ValueError(
                "the server carries no shard plan — it is a plain "
                "(unsharded) PS; use a plain Subscriber")
        return ShardPlan.from_json(body)

    # -- the subscription round trip ------------------------------------------

    def poll(self, force: bool = False
             ) -> "tuple[int | None, Any | None, bool]":
        """One conditional read: ``(version, params, changed)``.

        ``changed`` is True exactly when a fresh snapshot payload was
        decoded (the hot-swap trigger); unchanged and shed polls return
        the cached tree.  ``force=True`` requests a full payload even at
        the served version.  Transport blips heal through the backoff
        redial (the next read is a forced full snapshot); a peer that
        stays gone raises the transport error.  A served DONE latches
        ``self.done`` — the PS finished its run."""
        if self.done:
            return self.version, self.params, False
        have = (_UNVERSIONED
                if force or self._force_full or self.version is None
                else self.version)
        try:
            sent = self._session.send_read(
                b"SUBS" + _U64.pack(have), deadline=_shed_now())
            if (not sent and self._shed_dl is not None
                    and self._shed_dl.expired()):
                # Backoff over: probe once through the `open_read` valve;
                # the probe's DELT reply re-advertises the live window.
                self._session.open_read()
                self._shed_dl = None
                sent = self._session.send_read(
                    b"SUBS" + _U64.pack(have), deadline=_shed_now())
            if not sent:
                # Sender-side READ shed (zeroed window): serve the cache
                # and back off.
                if self._shed_dl is None:
                    self._shed_dl = Deadline(self.read_backoff)
                return self.version, self.params, False
            self._shed_dl = None
            dl = Deadline(self.op_deadline)
            try:
                reply = self._recv(dl)
            except DeadlineExpired:
                self.fault_stats["deadline_expired"] += 1
                raise
        except TRANSPORT_ERRORS:
            if self.nonblock_heal:
                # Never stall the caller behind the redial ladder: the
                # cached snapshot now, one bounded dial probe per backoff
                # window until the PS is back.
                if self._heal_dl is None or self._heal_dl.expired():
                    self._heal_dl = Deadline(max(self.read_backoff, 0.25))
                    try:
                        self._connect(dial_budget=1.0)
                        self.reconnects += 1
                        self._heal_dl = None
                    except TRANSPORT_ERRORS:
                        pass
                return self.version, self.params, False
            if self._reconnect():
                return self.version, self.params, False
            raise
        kind = bytes(reply[:4])
        if kind == b"DONE":
            self.done = True
            return self.version, self.params, False
        if kind == b"DELT":
            version = _U64.unpack_from(reply, 4)[0]
            credits = _U32.unpack_from(reply, 4 + _U64.size)[0]
            flags = reply[4 + _U64.size + _U32.size]
            # The v12 codec byte: how the payload (full or delta) was
            # encoded; the frame self-describes.
            codec = _U8.unpack_from(
                reply, 4 + _U64.size + _U32.size + 1)[0]
            self._session.replenish_read(credits)
            payload = reply[4 + _U64.size + _U32.size + 1 + _U8.size:]
            if flags & _DELT_SHED:
                # Server-side READ shed: the version's read budget is
                # spent — cached snapshot, counted, back off.
                self.fault_stats["read_shed"] += 1
                return self.version, self.params, False
            if flags & _DELT_UNCHANGED:
                self.fault_stats["reads_served"] += 1
                return self.version, self.params, False
            if flags & _DELT_DELTA:
                # A sparse diff against the version we PRESENTED (the
                # server diffs post-decode trees), only ever served
                # against a concrete ``have``: a missing base is a
                # protocol violation, not a fallback case.
                if self.params is None or have != self.version:
                    raise ValueError(
                        "DELT delta frame without a matching base "
                        "version — protocol violation")
                params = apply_wire_delta(self.params,
                                          serializer.loads(payload))
            else:
                params = decode_wire_tree(codec, serializer.loads(payload))
            if (self._max_version is not None
                    and version < self._max_version):
                # The server rewound (a restore from a lagging
                # checkpoint): counted, and the snapshot adopted unless
                # the owner asked for the typed refusal.
                self.fault_stats["version_rewinds"] += 1
                if self.on_rewind == "raise":
                    raise SnapshotRewindError(
                        f"served version rewound {self._max_version} "
                        f"-> {version}: the fleet restored to an older "
                        f"state than this subscription already served")
            self.version, self.params = version, params
            self._max_version = (version if self._max_version is None
                                 else max(self._max_version, version))
            self._force_full = False
            self.fault_stats["reads_served"] += 1
            self.fault_stats["delta_frames"] += 1
            return version, params, True
        raise ValueError(f"unexpected reply {kind!r} to SUBS")

    def snapshot(self, force: bool = True, attempts: int = 100,
                 wait: float = 0.02) -> "tuple[int, Any]":
        """One guaranteed-fresh full read: poll (bounded attempts; shed
        reads back off and retry) until a payload lands.  Returns
        ``(version, params)``; raises `FleetDeadError` when the server
        never serves one within the budget."""
        for _ in range(attempts):
            version, params, changed = self.poll(force=force)
            if changed:
                return version, params
            if self.done:
                break
            time.sleep(wait)
        if self.params is not None:
            return self.version, self.params
        raise FleetDeadError(
            f"no snapshot served within {attempts} read attempts — "
            f"PS gone, or the read budget shed every request "
            f"(raise read_window on the server, or back off harder)")

    def run(self, on_update: "Callable | None" = None, *,
            interval: float = 0.05,
            max_polls: "int | None" = None) -> int:
        """Poll until the PS says DONE (or ``max_polls``), hot-swapping
        through ``on_update(version, params)`` on every version advance.
        Returns the number of snapshot updates observed."""
        updates = 0
        polls = 0
        while not self.done and (max_polls is None or polls < max_polls):
            version, params, changed = self.poll()
            polls += 1
            if changed:
                updates += 1
                if on_update is not None:
                    on_update(version, params)
            if not self.done:
                time.sleep(interval)
        return updates


class FleetSubscriber:
    """One subscription multiplexed across a K-shard PS fleet: the read
    side of `shard.ShardRouter` — per-shard versions, the plan fetched
    from shard 0 and checked against every link's digest, and the full
    tree assembled from per-shard slices (host memory each link owns).

    ``poll()`` returns ``(versions, params, changed)`` where ``versions``
    is the per-shard version tuple: a reader that reasons about
    cross-shard skew has the exact tags to do it with.
    """

    def __init__(self, endpoints, *, token: "str | None" = None, **kw):
        endpoints = [(h, int(p)) for h, p in endpoints]
        if not endpoints:
            raise ValueError("FleetSubscriber needs at least one endpoint")
        self.endpoints = endpoints
        self.links: "list[Subscriber]" = []
        try:
            h0, p0 = endpoints[0]
            first = Subscriber(h0, p0, token=token, expect_shard=0, **kw)
            self.links.append(first)
            for k, (h, p) in enumerate(endpoints[1:], start=1):
                self.links.append(Subscriber(h, p, token=token,
                                             expect_shard=k, **kw))
            if first.num_shards != len(endpoints):
                raise ValueError(
                    f"the fleet has {first.num_shards} shards but "
                    f"{len(endpoints)} endpoints were given — list "
                    f"every shard exactly once")
            self.plan = first._fetch_plan()
            digest = self.plan.digest()
            for k, link in enumerate(self.links):
                if link.plan_digest != digest:
                    raise ValueError(
                        f"shard-plan digest mismatch on shard {k}: the "
                        f"fleet's plan hashes to {digest:#x} but "
                        f"{endpoints[k][0]}:{endpoints[k][1]} "
                        f"advertises {link.plan_digest:#x} — the "
                        f"endpoints mix different fleets")
        except BaseException:
            self.close()
            raise
        self.num_shards = len(self.links)
        self._names = list(self.plan.assignment)
        self._leaves: "dict[str, Any]" = {}
        self.versions: "list[int | None]" = [None] * self.num_shards
        self.params: "Any | None" = None

    @property
    def done(self) -> bool:
        return all(link.done for link in self.links)

    @property
    def version(self):
        """The per-shard version tuple (the fleet has no single version)."""
        return tuple(self.versions)

    def close(self) -> None:
        for link in self.links:
            link.close()

    def fault_snapshot(self) -> "dict[str, int]":
        snap: "dict[str, int]" = {}
        for link in self.links:
            for k, v in link.fault_snapshot().items():
                snap[k] = snap.get(k, 0) + v
        return snap

    def poll(self, force: bool = False):
        """One conditional read per shard; ``changed`` is True when any
        shard served a fresh slice and the full tree is assembled (a new
        tree object, the hot-swap trigger)."""
        changed_any = False
        for k, link in enumerate(self.links):
            version, slice_params, changed = link.poll(force=force)
            if changed and slice_params is not None:
                self._leaves.update(slice_params)
                self.versions[k] = version
                changed_any = True
        if changed_any and all(n in self._leaves for n in self._names):
            self.params = OrderedDict(
                (n, self._leaves[n]) for n in self._names)
        else:
            changed_any = False
        return tuple(self.versions), self.params, changed_any

    def snapshot(self, attempts: int = 100,
                 wait: float = 0.02) -> "tuple[tuple, Any]":
        """Bounded-retry full read of every shard's slice."""
        for _ in range(attempts):
            versions, params, changed = self.poll(force=True)
            if params is not None and changed:
                return versions, params
            if self.done:
                break
            time.sleep(wait)
        if self.params is not None:
            return tuple(self.versions), self.params
        raise FleetDeadError(
            f"no full fleet snapshot assembled within {attempts} read "
            f"attempts ({sum(n in self._leaves for n in self._names)}"
            f"/{len(self._names)} leaves served)")

    def run(self, on_update: "Callable | None" = None, *,
            interval: float = 0.05,
            max_polls: "int | None" = None) -> int:
        """Poll until every shard says DONE (or ``max_polls``), calling
        ``on_update(versions, params)`` on every assembled advance.
        Returns the number of updates observed."""
        updates = 0
        polls = 0
        while not self.done and (max_polls is None or polls < max_polls):
            versions, params, changed = self.poll()
            polls += 1
            if changed:
                updates += 1
                if on_update is not None:
                    on_update(versions, params)
            if not self.done:
                time.sleep(interval)
        return updates
