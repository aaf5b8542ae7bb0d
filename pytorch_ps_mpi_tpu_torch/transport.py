# pslint: frame-vocabulary(ps-wire)
"""Transport/session layer for the multihost PS — framing, CRC, deadlines,
and credit-based flow control.

Counterpart of `pytorch_ps_mpi_tpu/transport.py`, copied whole, not
imported (the port never imports the JAX package): the module is
framework-free, and its frame bytes are the contract between the two
packages' peers.  The pslint annotations refer to the repo's linter
(`tools/pslint`), which reads the JAX package; they are kept so the two
copies stay diffable.

This module is everything
below the *protocol* (frame kinds, handshake fields, admission policy —
which stay in `multihost_async`) and above the socket.  It owns:

* **Framing**: every message is a ``u32 length | u32 crc32(payload) |
  payload`` frame (`send_frame`/`recv_frame`).  A crc mismatch raises
  `FrameCRCError` — a frame-local, counted drop at every receiver; the
  length prefix keeps the stream aligned, so one flipped bit costs one
  frame, never the connection.  The zero-copy wire (protocol v9) sends
  the SAME frame as a scatter-gather iovec (`send_frame_segments`:
  header + meta + per-leaf buffer views in one ``socket.sendmsg``, crc
  chained across the segments) and receives it ``recv_into`` a
  preallocated rotating `RecvArena` — byte-identical on the wire, zero
  Python-level payload copies at both ends.

* **`Deadline`** — THE one time-budget type.  The transport stack used
  to run six independently-implemented timeout mechanisms (serve idle
  timeout, quorum fill deadline, aggregator pace timeout, per-op recv
  timeouts, reconnect backoff budgets, the router's degraded-mode
  bound); each was a slightly different ``t0 + patience`` dance and they
  drifted.  All of them now thread one `Deadline` through the
  dial/pull/push/redial ladders: construct with a budget (None = never
  expires), ask ``remaining()``/``expired()``, ``restart()`` on
  progress.  An op that blows its budget surfaces as `DeadlineExpired`
  (an ``OSError``, so the worker's transport-error healing — reconnect,
  degrade — applies unchanged, with the expiry counted).

* **`Session`** — one hardened, framed connection: the send lock, the
  heartbeat thread, the link-partition latch, and **credit-based flow
  control with priority classes**.  Frames classify as DATA
  (``GRAD``/``AGGR``/``REPL`` — the sheddable gradient/replication
  payloads) or CONTROL (everything else: ``HELO``/``PULL``/``BEAT``/
  ``SNAP``/``PROM``/``DONE``...).  The server advertises a credit
  window in its PULL/PARM (and ACKR) replies; every DATA send consumes
  one credit, and at zero credits the sender **stalls-then-sheds**
  instead of blocking the socket: the frame parks in a small pending
  queue (counted ``credits_stalled``) flushed at the next replenish,
  and once the queue is full the OLDEST pending data frame is shed
  (counted ``shed_data_frames``) — oldest-first, because under
  overload the oldest gradient is the stalest and therefore the least
  valuable (Lian et al.'s AsySG-InCon guarantee only holds under
  *bounded* staleness; an unbounded send queue converts overload
  directly into unbounded staleness).  CONTROL frames never enter the
  gate: the dominant overload mode — zero credits — parks data frames
  WITHOUT touching the socket, so a credit-starved link keeps its
  heartbeats flowing instead of starving them into spurious
  evictions.  (A granted in-flight ``sendall`` can still hold the
  send lock briefly; the credit window bounds how many such sends the
  receiver ever authorizes.)

  `Session` also carries the sender-side **pacing gate** the
  hierarchy's aggregator rides (``set_pace``/``new_epoch``): at most N
  data frames per epoch, where the owner defines an epoch (the
  aggregator: one observed root-version advance).  Pacing shares the
  stall/shed machinery — the aggregator's ``forward_ahead`` bound
  on the general credit mechanism.

  Protocol v10 adds a third class: **READ** frames (``SUBS``, the
  serve tier's snapshot-subscription requests) ride their OWN credit
  budget (``send_read``/``replenish_read``, seeded by the read window
  the server advertises in every ``DELT`` reply) with the same
  stall-then-shed-oldest-first discipline over a separate pending
  queue.  The split is the isolation property itself: a reader flood
  exhausts READ credits and sheds READ frames, while the DATA gate —
  and therefore training throughput — never sees it; heartbeats stay
  CONTROL and never gate at all.

* **Buffer ownership** (the zero-copy wire's precondition):
  a caller that hands a frame to `Session.send` keeps OWNING its
  buffer — the session parks an independent copy (copy-on-park in
  `send_data`; ``bytes()`` is free for immutable frames), so a parked
  frame that flushes long after the call returned is always the bytes
  the caller computed.  The debug byte-sentinel
  (``PS_BUFFER_SENTINEL=1``) proves it at runtime: a crc32 recorded at
  enqueue is re-verified at flush and any mismatch raises typed
  `errors.BufferMutatedError` naming the frame kind and enqueue site —
  the dynamic complement of pslint's PSL7xx static ownership rules
  (silent numeric corruption the frame CRC cannot catch, because the
  CRC covers the already-mutated bytes).

Frame-layout *protocol* decisions stay in `multihost_async`; this
module contributes only the DATA/CONTROL priority split, the
heartbeat, and the supervisor's control-plane client helpers
(`control_connect`/`request_snapshot`/`request_promotion` — dial +
typed round trip, the session side of SNAP/PROM).  The two modules
share one ``frame-vocabulary(ps-wire)`` so the pslint PSL301/PSL304
drift checkers balance encodes here against decoders there.
"""

from __future__ import annotations

import os
import socket
import struct
import sys
import threading
import time
import zlib
from collections import deque

from .errors import BufferMutatedError, RaceDetectedError
from .utils.crc import crc32_combine, fast_crc32

# Frame header: payload length + crc32 of the payload.
_HDR = struct.Struct("<II")
# A frame larger than this is a protocol violation (or a stray client whose
# first bytes parsed as a huge length) — reject before allocating.
_MAX_FRAME = 1 << 30


class FrameCRCError(ValueError):
    """A received frame's payload failed its crc32 check."""


class DeadlineExpired(OSError):
    """A transport operation exceeded its `Deadline` budget.

    An ``OSError`` subclass on purpose: every caller already heals
    transport blips (reconnect, degrade, fail over) via the
    `TRANSPORT_ERRORS` tuple, and a blown deadline wants exactly that
    ladder — plus a ``deadline_expired`` count at the call site."""


# Errors a sender treats as a transport blip worth a reconnect attempt
# (vs. ValueError protocol/config refusals, which do not heal by retrying).
TRANSPORT_ERRORS = (ConnectionError, OSError, FrameCRCError)

# PSA rank answered to a control connection (HELO flag bit 4): no worker
# rank was booked, so no u32 rank value may collide with a real one.
_CONTROL_RANK = 0xFFFFFFFF
# PROM reply meaning "nothing replicated yet" — the standby received no
# REPL before its primary died, so promotion must fall back to the
# checkpoint-restore path (or fail loudly).
_NO_REPLICA = (1 << 64) - 1
_U64 = struct.Struct("<Q")

# Whole-program lock order (pslint PSL5xx): the stall/pace/shed hooks
# fire UNDER the session send lock and bump the owner's `_stats_lock`-
# guarded fault_stats, so the session lock is strictly OUTER to the
# stats lock — code taking the session lock while holding `_stats_lock`
# would invert the hook edge into an ABBA deadlock (`shard.hierarchy`
# reads session stats lock-free for exactly this reason).
# pslint: lock-order(_lock < _stats_lock)

# Priority classes: DATA frames are sheddable under zero credits
# (gradients and replication payloads — droppable by design, the
# admission policy upstream absorbs short fills); everything else is
# CONTROL and never sheds (heartbeats, handshakes, snapshot markers,
# promotion fences — losing one turns overload into spurious evictions
# or a wedged failover).
DATA_FRAME_KINDS = frozenset((b"GRAD", b"AGGR", b"REPL"))

# READ class (protocol v10, the serve tier): snapshot-subscription
# requests from readers.  A THIRD priority class with its OWN credit
# budget, deliberately disjoint from the DATA gate above — reader
# traffic must never consume a credit a gradient could have used, so a
# reader flood stalls-then-sheds READ frames (oldest-first, like data)
# while GRAD/AGGR/REPL and the CONTROL plane flow untouched: the
# training SLO survives reader churn by construction, not by tuning.
READ_FRAME_KINDS = frozenset((b"SUBS",))


def _sentinel_enabled() -> bool:
    """The byte-sentinel sanitizer's debug switch (``PS_BUFFER_SENTINEL=1``):
    record a cheap checksum of every PARKED data frame at enqueue and
    re-verify it at flush, raising typed `BufferMutatedError` on any
    mismatch — the dynamic complement of pslint's PSL7xx buffer-ownership
    dataflow rules.  The static checker over-approximates interleavings;
    the sentinel convicts the one that actually happened (with the frame
    kind and the enqueue site in the message).  Cost: one crc32 per
    parked frame — parked frames are the overload minority, so tier-1
    runs with it on (tests/conftest.py)."""
    return os.environ.get("PS_BUFFER_SENTINEL", "") == "1"


def _race_enabled() -> bool:
    """The race sanitizer's debug switch (``PS_RACE_SANITIZER=1``): the
    session lock becomes a `_TrackedLock` recording its owning thread,
    and every ``# pslint: holds(_lock)`` gate/flush helper probes that
    the CALLING thread actually holds it — the caller-side obligation
    the static lockset analysis (pslint PSL1xx/PSL8xx) documents but
    explicitly does not check.  A violation raises typed
    `RaceDetectedError` (a RuntimeError: reconnect ladders never swallow
    it) and bumps ``race_trips``; every probe bumps ``race_checks``.
    Cost: one attribute test per gate helper call when disarmed, one
    thread-ident compare when armed — tier-1 runs with it on
    (tests/conftest.py), like the byte sentinel above."""
    return os.environ.get("PS_RACE_SANITIZER", "") == "1"


class _TrackedLock:
    """``threading.Lock`` with an owner record, substituted for the
    session lock when the race sanitizer is armed.  ``_owner`` is only
    ever written by the thread that holds (or just held) the lock, so
    ``held_by_me()`` is exact for the asking thread: if we hold the
    lock, we were the last writer; if we don't, the compare fails no
    matter which stale ident it reads."""

    __slots__ = ("_inner", "_owner")

    def __init__(self):
        self._inner = threading.Lock()
        self._owner: "int | None" = None

    def acquire(self, *args, **kwargs) -> bool:
        got = self._inner.acquire(*args, **kwargs)
        if got:
            self._owner = threading.get_ident()
        return got

    def release(self) -> None:
        self._owner = None
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def held_by_me(self) -> bool:
        return (self._inner.locked()
                and self._owner == threading.get_ident())

    def __enter__(self) -> "_TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def _enqueue_site() -> str:
    """file:line of the first caller OUTSIDE this module — the hand-off
    site a `BufferMutatedError` names.  Debug-mode only (the sentinel
    pays a frame walk per parked frame; direct sends never come here)."""
    f = sys._getframe(1)
    while f is not None and f.f_code.co_filename == __file__:
        f = f.f_back
    if f is None:  # pragma: no cover - park always has a caller
        return "<unknown>"
    return f"{f.f_code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno}"


def frame_header(payload: bytes) -> bytes:
    # fast_crc32 == zlib.crc32, via the native PCLMUL kernel for
    # multi-KB payloads (the wire crc was ~25% of an update's budget).
    return _HDR.pack(len(payload), fast_crc32(payload))


# Linux caps one sendmsg at IOV_MAX (usually 1024) iovec entries; stay
# comfortably under it and loop — the syscall count is still ~segments/N.
_IOV_CAP = min(getattr(socket, "IOV_MAX", 1024), 512)


def _as_byte_view(seg) -> memoryview:
    """A flat byte view of one gather segment (bytes, bytearray,
    memoryview, or a C-contiguous ndarray buffer) — byte-granular so a
    partial ``sendmsg`` can resume mid-segment."""
    mv = seg if isinstance(seg, memoryview) else memoryview(seg)
    if mv.format != "B" or mv.ndim != 1:
        mv = mv.cast("B")
    return mv


def sendmsg_all(sock: socket.socket, segments) -> int:
    """Gather-send every segment (in order) with ``socket.sendmsg`` —
    the scatter-gather hot path: no concatenation, no per-segment
    syscall, partial sends resumed mid-segment.  Returns bytes sent.
    Falls back to per-segment ``sendall`` where sendmsg is missing."""
    bufs = [_as_byte_view(s) for s in segments if len(s)]
    if not hasattr(sock, "sendmsg"):  # pragma: no cover - non-POSIX
        total = 0
        for b in bufs:
            sock.sendall(b)
            total += b.nbytes
        return total
    total = 0
    while bufs:
        sent = sock.sendmsg(bufs[:_IOV_CAP])
        if sent <= 0:  # pragma: no cover - blocking socket contract
            raise ConnectionError("sendmsg made no progress")
        total += sent
        # Advance past fully-sent segments; slice into a partial one.
        while bufs and sent >= bufs[0].nbytes:
            sent -= bufs[0].nbytes
            bufs.pop(0)
        if sent:
            bufs[0] = bufs[0][sent:]
    return total


def segments_crc(segments) -> int:
    """crc32 chained across the iovec — identical to the crc of the
    concatenated payload, without concatenating."""
    crc = 0
    for s in segments:
        crc = fast_crc32(s, crc)
    return crc


def frame_iovec(segments, cached: "tuple[int, int] | None" = None) -> list:
    """The complete iovec of one wire frame over ``segments`` — header
    (length + chained crc32) first, payload views untouched.  Factored
    out of `send_frame_segments` so the v11 multipart coalescer can put
    SEVERAL frames into one ``sendmsg`` (`Session.send_data_parts`).

    ``cached=(crc, length)`` declares the chained crc32 of the LAST
    ``length`` payload bytes as already known (the serializer computes
    it during its single encode pass; the PARM fanout caches it per
    version) — the frame checksum then costs a crc over the small head
    plus one `crc32_combine`, never a second multi-MB pass."""
    total = sum(len(s) for s in segments)
    if cached is not None:
        tail_crc, tail_len = cached
        head_len = total - tail_len
        hcrc = 0
        remaining = head_len
        for s in segments:
            if remaining <= 0:
                break
            b = s if len(s) <= remaining else memoryview(s)[:remaining]
            hcrc = fast_crc32(b, hcrc)
            remaining -= len(b)
        frame_crc = crc32_combine(hcrc, tail_crc, tail_len)
    else:
        frame_crc = segments_crc(segments)
    return [_HDR.pack(total, frame_crc), *segments]


def send_frame_segments(sock: socket.socket, segments,
                        cached: "tuple[int, int] | None" = None) -> None:
    """One wire frame whose payload is the CONCATENATION of ``segments``
    — scatter-gathered straight from the callers' buffers (frame header
    included in the same ``sendmsg``), so a multi-MB tree goes out with
    zero Python-level copies.  Receivers are agnostic: the frame is
    byte-identical to ``send_frame(sock, b"".join(segments))``."""
    sendmsg_all(sock, frame_iovec(segments, cached))


def send_frame(sock: socket.socket, payload: bytes) -> None:
    if len(payload) > 65536:
        # One gather-send instead of concatenating: prepending 8 bytes
        # to a multi-MB params blob would memcpy the whole payload per
        # message (and two sendalls would cost two syscalls + a small
        # extra packet boundary).
        sendmsg_all(sock, (frame_header(payload), payload))
    else:
        sock.sendall(frame_header(payload) + payload)


def recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def recv_frame(sock: socket.socket) -> bytes:
    n, crc = _HDR.unpack(recv_exact(sock, _HDR.size))
    if n > _MAX_FRAME:
        raise ValueError(f"oversized frame: {n} bytes")
    payload = recv_exact(sock, n)
    if fast_crc32(payload) != crc:
        raise FrameCRCError(
            f"frame failed crc32 check ({n} bytes) — corrupted in transit")
    return payload


class RecvArena:
    """Preallocated receive buffers for one connection: every frame is
    ``recv_into`` a rotating ring of ``nbufs`` bytearrays instead of
    allocating (and twice copying) a fresh payload per frame — the
    receive half of the zero-copy wire.  `recv_frame` returns a
    memoryview INTO the arena.

    Aliasing contract (the PSL703 refill discipline): a returned view
    is valid only until the same ring slot is refilled — i.e. for the
    next ``nbufs - 1`` receives.  Consume it (decode materializes into
    a fresh decode arena) or ``bytes()`` it before then; anything
    retained longer silently re-reads a LATER frame's bytes.  The
    default ``nbufs=3`` leaves room for one receive plus a decode
    pipeline of depth 2 (`AsyncPSServer`'s off-GIL decode pool) — a
    caller that decodes inline before its next receive only ever needs
    2.  ``hint`` pre-sizes each slot (the server derives it from the
    compiled code-tree meta: the expected GRAD frame for its quota's
    worth of senders); undersized slots grow to the largest frame seen
    and stay grown."""

    __slots__ = ("_bufs", "_i", "frames", "grown")

    def __init__(self, hint: int = 1 << 16, nbufs: int = 3):
        if nbufs < 1:
            raise ValueError(f"nbufs must be >= 1, got {nbufs}")
        size = max(int(hint), 4096)
        self._bufs = [bytearray(size) for _ in range(nbufs)]
        self._i = 0
        self.frames = 0
        self.grown = 0

    @property
    def window(self) -> int:
        """How many FURTHER receives a returned view stays valid for
        (``nbufs - 1``) — the rotation bound the server conn loop's
        pre-receive drain checks in-flight offloaded decodes against."""
        return len(self._bufs) - 1

    def recv_frame(self, sock: socket.socket) -> memoryview:
        """One framed receive into the next ring slot; same header/
        length/crc contract as the module-level `recv_frame`, zero
        payload copies."""
        n, crc = _HDR.unpack(recv_exact(sock, _HDR.size))
        if n > _MAX_FRAME:
            raise ValueError(f"oversized frame: {n} bytes")
        self._i = (self._i + 1) % len(self._bufs)
        if len(self._bufs[self._i]) < n:
            self._bufs[self._i] = bytearray(n)
            self.grown += 1
        view = memoryview(self._bufs[self._i])[:n]
        got = 0
        while got < n:
            r = sock.recv_into(view[got:])
            if r == 0:
                raise ConnectionError("peer closed mid-frame")
            got += r
        # `frames` counts SLOT CONSUMPTION, not successful frames: a
        # crc-failed frame (frame-local on an authed connection — the
        # caller keeps receiving) still overwrote a ring slot, and the
        # rotation-window guard must see that rotation or a live
        # offloaded-decode view gets overwritten one receive early.
        self.frames += 1
        if fast_crc32(view) != crc:
            raise FrameCRCError(
                f"frame failed crc32 check ({n} bytes) — corrupted in "
                f"transit")
        return view


def accept_pump(listener: socket.socket, stop, handler, *,
                on_error=None, threads: "list | None" = None,
                poll: float = 0.2) -> None:
    """The server-side accept loop: accept connections on ``listener``
    until ``stop`` (an Event) is set, spawning one daemon ``handler``
    thread per connection.  A listener already closed before the first
    instruction exits quietly (close()/promotion-rebind race); an
    unexpected accept error calls ``on_error`` and keeps serving (a bare
    break would silently stop admitting workers forever); ``threads``
    (when given) collects live handler threads, pruned per accept so a
    long-lived exposed port doesn't grow the list unboundedly.  pslint's
    thread-context classifier treats the handler as handler-thread
    code, exactly like a ``Thread(target=...)`` spawn."""
    try:
        listener.settimeout(poll)
    except OSError:
        return
    while not stop.is_set():
        try:
            conn, _ = listener.accept()
        except socket.timeout:
            continue
        except OSError:
            if stop.is_set() or listener.fileno() < 0:
                break  # listener closed: normal shutdown
            if on_error is not None:
                on_error()
            time.sleep(0.05)
            continue
        t = threading.Thread(target=handler, args=(conn,),
                             daemon=True, name="async-ps-conn")
        t.start()
        if threads is not None:
            threads[:] = [x for x in threads if x.is_alive()]
            threads.append(t)


# -- control-plane client helpers (the fleet supervisor's session side) -------

def control_connect(host: str, port: int, token: "str | None" = None,
                    timeout: float = 10.0, *,
                    protocol_version: int) -> socket.socket:
    """Dial a PS (or standby) as a CONTROL peer: authenticated HELO with
    flag bit 4, so the server books no worker rank for this connection —
    the fleet supervisor's SNAP/PROM markers and the primary→standby
    replication stream must never appear in worker identity, eviction,
    or ``workers_seen`` accounting.  Returns the connected socket."""
    sock = socket.create_connection((host, port), timeout=timeout)
    try:
        sock.settimeout(timeout)
        send_frame(sock, b"HELO" + bytes([4])
                   + (token.encode() if token else b""))
        reply = recv_frame(sock)
        if reply == b"NOAU":
            raise ValueError(
                "server refused the control connection's admission token")
        if reply[:3] != b"PSA" or reply[3] != protocol_version:
            raise ValueError(
                f"control connect: incompatible peer (reply "
                f"{reply[:4]!r}, want PSA v{protocol_version})")
    except BaseException:
        sock.close()
        raise
    return sock


def request_snapshot(sock: socket.socket, cut: int) -> int:
    """Send one SNAP marker over a control connection: ask the shard to
    checkpoint at exactly fill boundary ``cut``.  Returns the armed cut
    (0 = the shard refused — it already passed the boundary; pick a
    later cut and retry)."""
    send_frame(sock, b"SNAP" + _U64.pack(cut))
    reply = recv_frame(sock)
    if reply[:4] != b"SNAP":
        raise ValueError(f"unexpected reply {reply[:4]!r} to SNAP")
    (armed,) = _U64.unpack_from(reply, 4)
    return armed


def request_promotion(sock: socket.socket,
                      plan_digest: int) -> "int | None":
    """Send the promotion fence over a control connection to a standby.
    After the reply the standby refuses further REPL (a zombie primary
    cannot overwrite the new primary's state).  Returns the standby's
    replicated step, or None when nothing was ever replicated."""
    send_frame(sock, b"PROM" + _U64.pack(plan_digest))
    reply = recv_frame(sock)
    if reply[:4] != b"PROM":
        raise ValueError(f"unexpected reply {reply[:4]!r} to PROM")
    (step,) = _U64.unpack_from(reply, 4)
    return None if step == _NO_REPLICA else step


class Deadline:
    """A monotonic time budget: ``Deadline(5.0)`` expires 5 s after
    construction; ``Deadline(None)`` never expires.  The one budget type
    every transport timeout rides (see the module docstring) — replaces
    the per-call-site ``t0 + patience`` arithmetic that had drifted into
    six slightly-different implementations."""

    __slots__ = ("budget", "_t0")

    def __init__(self, budget: "float | None"):
        if budget is not None and budget < 0:
            raise ValueError(f"Deadline budget must be >= 0, got {budget}")
        self.budget = budget
        self._t0 = time.monotonic()

    @classmethod
    def never(cls) -> "Deadline":
        return cls(None)

    def restart(self) -> "Deadline":
        """Re-arm the full budget from now (progress was made)."""
        self._t0 = time.monotonic()
        return self

    def elapsed(self) -> float:
        return time.monotonic() - self._t0

    def remaining(self) -> float:
        """Seconds left (>= 0.0); ``inf`` for a budget-less deadline."""
        if self.budget is None:
            return float("inf")
        return max(0.0, self.budget - self.elapsed())

    def expired(self) -> bool:
        return self.budget is not None and self.remaining() <= 0.0

    def timeout(self, floor: float = 0.001,
                cap: "float | None" = None) -> "float | None":
        """The remaining budget as a socket/queue timeout value: clamped
        to ``floor`` so a just-expired deadline still makes one bounded
        attempt (the caller checks ``expired()`` to decide what a
        timeout means), optionally capped (poll granularity).  None for
        a budget-less deadline with no cap."""
        if self.budget is None:
            return cap
        t = max(self.remaining(), floor)
        return t if cap is None else min(t, cap)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        if self.budget is None:
            return "Deadline(never)"
        return f"Deadline({self.budget}s, {self.remaining():.3f}s left)"


class Session:
    """One framed, heartbeat-kept, credit-gated connection (sender side).

    Owns the per-connection send/recv state the worker, `ShardRouter`
    link, and `LocalAggregator` upstream all need: the send lock, the
    socket (swappable across reconnects via `adopt`), the heartbeat
    thread, the link-partition latch, and the DATA-frame credit/pacing
    gate (see the module docstring for the flow-control contract).

    ``stall_hook``/``pace_hook``/``shed_hook`` fire (under the session
    lock — keep them tiny) when a data frame stalls on exhausted
    CREDITS / stalls on the PACING gate alone / is shed from a full
    pending queue, on top of the session-local ``stats`` counters;
    owners use them to mirror the events into their own locked
    ``fault_stats``.  A stall with BOTH gates closed attributes to
    credits (a saturated receiver makes pacing moot), so one stall
    event lands in exactly one counter.
    """

    def __init__(self, sock: "socket.socket | None", *,
                 io_timeout: float = 60.0,
                 heartbeat_interval: float = 0.0,
                 max_pending: int = 4,
                 credit_cap: "int | None" = None,
                 stall_hook=None, pace_hook=None, shed_hook=None,
                 sentinel: "bool | None" = None,
                 race_sanitizer: "bool | None" = None):
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        if credit_cap is not None and credit_cap < 1:
            raise ValueError(
                f"credit_cap must be >= 1 (or None), got {credit_cap}")
        self._sock = sock  # pslint: guarded-by(_lock)
        self.io_timeout = io_timeout
        self.heartbeat_interval = heartbeat_interval
        self.max_pending = int(max_pending)
        # THE send lock: its whole job is serializing sendall on the
        # shared socket (and making gate-check + send atomic), so
        # blocking inside it is its contract, not a lock-held-blocking
        # bug —
        # the credit gate bounds how many in-flight sends the receiver
        # ever authorizes.  Everything below it is its guarded state.
        self._lock = threading.Lock()  # pslint: blocking-allowed
        # Race sanitizer (``PS_RACE_SANITIZER=1``, or the explicit
        # ``race_sanitizer`` kwarg): swap in the owner-tracking lock so
        # the ``holds(_lock)`` helpers can probe their caller-side
        # obligation (`_assert_locked`).  The swap is a SECOND statement
        # on purpose — the plain ``threading.Lock()`` line above is what
        # pslint's lock-vocabulary scan recognizes, armed or not.
        self._race = (_race_enabled() if race_sanitizer is None
                      else bool(race_sanitizer))
        if self._race:
            self._lock = _TrackedLock()
        # Credit state: None until a server advertises a window (the
        # pre-v8 ungated behavior — also what control-only sessions use).
        self._credits: "int | None" = None  # pslint: guarded-by(_lock)
        self._credit_cap = credit_cap
        # Pacing state (the aggregator's forward_ahead reimplemented on
        # credits): at most _pace_budget data frames per owner-defined
        # epoch.  None = unpaced.
        self._pace_budget: "int | None" = None  # pslint: guarded-by(_lock)
        self._pace_left: "int | None" = None  # pslint: guarded-by(_lock)
        self._pending: "deque[bytes]" = deque()  # pslint: guarded-by(_lock)
        # READ-class gate state (v10): a SEPARATE credit balance and
        # pending queue for snapshot-subscription frames, so reader
        # traffic and gradient traffic can never starve each other at
        # the sender.  None = ungated (no server advertised a read
        # window yet); the queue sheds oldest-first like the data one
        # (the oldest subscription request asks for the stalest view).
        self._read_credits: "int | None" = None  # pslint: guarded-by(_lock)
        self._read_pending: "deque[bytes]" = deque()  # pslint: guarded-by(_lock)
        self.max_read_pending = int(max_pending)
        # The byte-sentinel sanitizer (``PS_BUFFER_SENTINEL=1``, or the
        # explicit ``sentinel`` kwarg): a deque PARALLEL to ``_pending``
        # holding one ``(crc32, kind, enqueue-site)`` record per parked
        # frame, pushed/popped in lockstep under the lock.  Flush
        # re-verifies each record against the parked bytes and raises
        # `BufferMutatedError` on mismatch — send-what-you-computed,
        # enforced at the one window where the transport retains a
        # reference after the caller returned.
        self._sentinel = (_sentinel_enabled() if sentinel is None
                          else bool(sentinel))
        self._sentries: "deque[tuple]" = deque()  # pslint: guarded-by(_lock)
        # Written under the lock; external readers take snapshot-grade
        # lock-free int reads (`_Upstream.session_stats`) by design.
        self.stats = {"credits_stalled": 0,  # pslint: guarded-by(_lock)
                      "shed_data_frames": 0,
                      "segments_sent": 0,
                      "sentinel_checks": 0,
                      "sentinel_trips": 0,
                      # READ-class accounting (v10): subscription
                      # frames stalled on an exhausted read window,
                      # and the ones shed (immediately on an expired
                      # deadline, or oldest-first from a full queue).
                      "reads_stalled": 0,
                      "read_shed": 0,
                      # Race sanitizer (PS_RACE_SANITIZER=1): holds()
                      # obligations probed, and violations caught
                      # (each trip also raises RaceDetectedError).
                      "race_checks": 0,
                      "race_trips": 0}
        self._stall_hook = stall_hook
        self._pace_hook = pace_hook
        self._shed_hook = shed_hook
        # Link-partition latch (`FaultPlan.partition_links`): while set,
        # the heartbeat swallows its BEATs — a black-holed link must go
        # silent in BOTH directions or the PS would keep the partitioned
        # rank alive forever.  The owner suppresses pulls/pushes itself.
        self.link_down = False
        self._hb_stop = threading.Event()
        self._hb_thread: "threading.Thread | None" = None

    # -- socket lifecycle -----------------------------------------------------

    @property
    def sock(self) -> "socket.socket | None":
        # Under the lock: a reconnect's `adopt` may be swapping the
        # socket concurrently, and the caller must never see (and then
        # close or settimeout) a half-retired reference.
        with self._lock:
            return self._sock

    def adopt(self, sock: socket.socket) -> None:
        """Swap in a freshly-dialed socket (reconnect): the old one is
        closed, pending data frames survive onto the new link."""
        with self._lock:
            old, self._sock = self._sock, sock
        if old is not None:
            try:
                old.close()
            except OSError:  # pragma: no cover - close best-effort
                pass

    def close(self) -> None:
        self._hb_stop.set()
        # Deliberately LOCK-FREE read: close() must PREEMPT an in-flight
        # sendall (which legally holds the send lock for its duration —
        # blocking-allowed) by erroring it out of the socket; taking the
        # lock here would serialize shutdown/eviction/teardown behind a
        # wedged send for up to a full io_timeout.
        sock = self._sock  # pslint: allow(lock-discipline): preempts in-flight sends
        if sock is not None:
            try:
                sock.close()
            except OSError:  # pragma: no cover - close best-effort
                pass

    # -- the race-sanitizer probe ---------------------------------------------

    # pslint: holds(_lock)
    def _assert_locked(self, helper: str) -> None:
        """The armed form of ``# pslint: holds(_lock)``: called at the
        top of each annotated gate/flush helper, verifies the CALLING
        thread holds the session lock.  The annotation documents a
        caller-side obligation the static checkers deliberately do not
        verify ("annotate sparingly") — this probe is what verifies it,
        per actual execution.  On a violation the counters are best
        effort (we are off-lock by definition); the typed raise is the
        signal, and nothing between here and the test harness catches a
        RuntimeError."""
        if not self._race:
            return
        self.stats["race_checks"] += 1
        lock = self._lock
        if isinstance(lock, _TrackedLock) and not lock.held_by_me():
            self.stats["race_trips"] += 1
            raise RaceDetectedError(
                f"Session.{helper} requires self._lock held "
                f"(# pslint: holds(_lock)) but thread "
                f"{threading.current_thread().name!r} called it without "
                f"the lock — caught by PS_RACE_SANITIZER=1")

    # -- the credit/pacing gate (DATA frames only) ----------------------------

    # pslint: holds(_lock)
    def _gate_open(self) -> bool:
        self._assert_locked("_gate_open")
        return ((self._credits is None or self._credits > 0)
                and (self._pace_left is None or self._pace_left > 0))

    # pslint: holds(_lock)
    def _consume_gate(self) -> None:
        self._assert_locked("_consume_gate")
        if self._credits is not None:
            self._credits -= 1
        if self._pace_left is not None:
            self._pace_left -= 1

    # pslint: holds(_lock)
    def _flush_pending(self) -> None:
        self._assert_locked("_flush_pending")
        while self._pending and self._gate_open():
            payload = self._pending.popleft()
            if self._sentries:
                self._verify_sentinel(payload, *self._sentries.popleft())
            self._consume_gate()
            self._put_entry(payload)

    # pslint: holds(_lock)
    def _put_entry(self, entry) -> None:
        """One pending-queue entry onto the wire: a plain ``bytes``
        frame, a parked SEGMENT LIST (the scatter-gather wire's
        copy-on-park form) gather-sent as one frame, or a parked
        MULTIPART tuple (a bucket-streamed gradient, v11) sent as its
        consecutive bucket frames — one entry, one credit, however many
        frames it carries."""
        if isinstance(entry, tuple):
            for part in entry:
                send_frame_segments(self._sock, part)
                self.stats["segments_sent"] += len(part)
        elif isinstance(entry, list):
            send_frame_segments(self._sock, entry)
            self.stats["segments_sent"] += len(entry)
        else:
            send_frame(self._sock, entry)

    @staticmethod
    def _entry_crc(entry) -> int:
        """The sentinel checksum of a pending entry: plain frames crc
        whole, segment lists crc chained across the iovec, multipart
        tuples chained across every part's iovec — the same
        bytes-on-the-wire either way."""
        if isinstance(entry, tuple):
            crc = 0
            for part in entry:
                for s in part:
                    crc = fast_crc32(s, crc)
            return crc
        if isinstance(entry, list):
            return segments_crc(entry)
        return fast_crc32(entry)

    # pslint: holds(_lock)
    def _verify_sentinel(self, payload, crc: int, kind: bytes,
                         site: str) -> None:
        """Re-verify a parked frame's enqueue-time checksum right before
        its bytes hit the wire — the flush may run long after `send_data`
        returned (the stall-then-flush path), which is exactly the window
        a zero-copy caller could have reused the buffer in."""
        self.stats["sentinel_checks"] += 1
        if self._entry_crc(payload) != crc:
            self.stats["sentinel_trips"] += 1
            raise BufferMutatedError(
                f"parked {kind!r} frame was mutated between hand-off "
                f"(enqueued at {site}) and flush: the bytes about to hit "
                f"the wire are not the bytes the caller computed — a "
                f"buffer-ownership violation the frame CRC cannot catch "
                f"(it would checksum the already-wrong bytes)")

    def replenish(self, credits: int) -> None:
        """Adopt a server-advertised credit window (PULL/PARM or ACKR
        reply) and flush what the new balance admits.  The sender-side
        ``credit_cap`` (CLI ``--credit-window`` on a worker role) clamps
        a generous server."""
        with self._lock:
            c = int(credits)
            if self._credit_cap is not None:
                c = min(c, self._credit_cap)
            self._credits = c
            self._flush_pending()

    def credits(self) -> "int | None":
        with self._lock:
            return self._credits

    def set_pace(self, per_epoch: "int | None") -> None:
        """Arm (or disarm, with None) the sender-side pacing gate: at
        most ``per_epoch`` data frames between `new_epoch` calls."""
        if per_epoch is not None and per_epoch < 1:
            raise ValueError(
                f"pace must be >= 1 frame per epoch (or None), "
                f"got {per_epoch}")
        with self._lock:
            self._pace_budget = per_epoch
            self._pace_left = per_epoch
            self._flush_pending()

    def new_epoch(self) -> None:
        """The owner observed epoch progress (the aggregator: the root's
        version advanced) — re-arm the pace allowance and flush."""
        with self._lock:
            if self._pace_budget is not None:
                self._pace_left = self._pace_budget
            self._flush_pending()

    def open_pace(self) -> None:
        """The bounded-stall valve (pace_timeout): let the queued frames
        flow once even though the epoch never advanced — a stalled
        receiver costs seconds, never a deadlock.  Credits still gate;
        the pace re-arms at the next `new_epoch`."""
        with self._lock:
            if self._pace_left is not None:
                self._pace_left = max(self._pace_left, len(self._pending))
            self._flush_pending()

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    # -- sending --------------------------------------------------------------

    def send(self, payload: bytes, deadline: "Deadline | None" = None
             ) -> bool:
        """Send one frame under the priority contract: CONTROL frames go
        straight out; DATA frames ride the credit/pacing gate — sent
        when it is open, parked (then shed oldest-first) when it is not;
        READ frames (v10 subscription requests) ride their OWN gate so
        reader and gradient traffic can never stall each other.
        Returns True when the frame hit the socket now."""
        if payload[:4] in DATA_FRAME_KINDS:
            return self.send_data(payload, deadline=deadline)
        if payload[:4] in READ_FRAME_KINDS:
            return self.send_read(payload, deadline=deadline)
        self._send_control(payload)
        return True

    def _send_control(self, payload: bytes) -> None:
        with self._lock:
            send_frame(self._sock, payload)

    # pslint: holds(_lock)
    def _note_stall(self) -> None:
        """Attribute a gate stall to the gate that BINDS: exhausted
        credits (counted ``credits_stalled``) win over the pacing gate
        (``pace_hook`` — the aggregator's ``agg_paced``), so a
        saturated receiver is never misread as pacing and one stall
        lands in exactly one counter."""
        if self._credits is not None and self._credits <= 0:
            self.stats["credits_stalled"] += 1
            if self._stall_hook is not None:
                self._stall_hook()
        elif self._pace_hook is not None:
            self._pace_hook()

    # pslint: holds(_lock)
    def _note_shed(self) -> None:
        self.stats["shed_data_frames"] += 1
        if self._shed_hook is not None:
            self._shed_hook()

    # pslint: holds(_lock)
    def _shed_overflow(self) -> None:
        """Oldest-first overflow shed: under overload the oldest queued
        gradient is the stalest, i.e. the least valuable contribution
        (sentry queue kept in lockstep)."""
        self._assert_locked("_shed_overflow")
        if len(self._pending) > self.max_pending:
            self._pending.popleft()
            if self._sentries:
                self._sentries.popleft()
            self._note_shed()

    def send_data(self, payload: bytes,
                  deadline: "Deadline | None" = None) -> bool:
        """One DATA frame through the gate.  ``deadline`` (when given
        and already expired) sheds immediately instead of parking — an
        op whose budget is gone must not occupy pending-queue space a
        fresher frame could use."""
        with self._lock:
            if self._gate_open():
                self._consume_gate()
                send_frame(self._sock, payload)
                return True
            self._note_stall()
            if deadline is not None and deadline.expired():
                self._note_shed()
                return False
            # COPY-ON-PARK — the `_pending` ownership contract (pslint
            # PSL701): the caller RETAINS ownership of ``payload`` and
            # may legally reuse its buffer the moment send_data returns,
            # while the parked frame may flush long after (the next
            # replenish, an open_pace valve).  The parked entry must
            # therefore be an independent copy: ``bytes()`` is free for
            # the already-immutable frames every current caller hands in
            # and a real copy for the mutable views a zero-copy wire
            # parks.
            parked = bytes(payload)
            self._pending.append(parked)
            if self._sentinel:
                # Checksum the PARKED copy, not the caller's buffer: a
                # mutable payload another thread touches between the
                # two reads would otherwise record a crc of bytes that
                # were never parked — a spurious trip at flush.
                self._sentries.append((fast_crc32(parked), parked[:4],
                                       _enqueue_site()))
            self._shed_overflow()
            return False

    def send_data_segments(self, segments,
                           deadline: "Deadline | None" = None,
                           cached: "tuple[int, int] | None" = None
                           ) -> bool:
        """One DATA frame as a scatter-gather SEGMENT LIST through the
        same gate (`send_frame_segments` when it is open) — the
        zero-copy wire's send: the segments may be live views of the
        caller's leaf buffers, so the open-gate path moves no bytes in
        Python at all.  Parking copies PER SEGMENT (the caller keeps
        ownership of every view it handed in, exactly the `send_data`
        contract), and the sentinel checksums the parked iovec.
        ``cached`` is `send_frame_segments`' precomputed-suffix-crc
        contract (dropped on park: the parked copy is new bytes and
        the sentinel checksums those)."""
        with self._lock:
            if self._gate_open():
                self._consume_gate()
                send_frame_segments(self._sock, segments, cached=cached)
                self.stats["segments_sent"] += len(segments)
                return True
            self._note_stall()
            if deadline is not None and deadline.expired():
                self._note_shed()
                return False
            # COPY-ON-PARK, per segment: the parked frame must be
            # independent of every caller-owned view in the iovec (the
            # leaf segments alias the caller's arrays — legally reused
            # the moment this returns), while staying a segment list so
            # the flush still gather-sends it.
            parked = [bytes(s) for s in segments]
            self._pending.append(parked)
            if self._sentinel:
                self._sentries.append((segments_crc(parked),
                                       bytes(parked[0][:4]),
                                       _enqueue_site()))
            self._shed_overflow()
            return False

    # -- multipart DATA sends (v11 bucket-streamed gradients) -----------------
    #
    # A bucket-streamed gradient is MANY wire frames but ONE unit of flow
    # control: the server's credit window meters queue slots, and its net
    # queue holds ASSEMBLED gradients — charging per bucket frame would
    # shrink the effective window by the bucket count and re-derive the
    # staleness bound from a worker-chosen knob.  So the FIRST bucket
    # consults (and consumes) the gate once; while it is open the
    # remaining buckets ride as continuation frames, and while it is
    # closed the caller collects every bucket and parks the gradient as
    # one entry — flushed as consecutive frames, shed oldest-first as a
    # unit (shedding one bucket of a gradient would ship wire bytes the
    # assembler can only time out on).

    def begin_data_parts(self) -> bool:
        """Open one gated slot for a multipart data send: True consumes
        one credit/pace unit for the WHOLE gradient (stream the parts
        through `send_data_part`); False means the gate is closed
        (counted like any data stall) — collect the parts and hand them
        to `park_data_parts`."""
        with self._lock:
            if self._gate_open():
                self._consume_gate()
                return True
            self._note_stall()
            return False

    def send_data_part(self, segments,
                       cached: "tuple[int, int] | None" = None) -> None:
        """One continuation frame of an ADMITTED multipart send (a
        `begin_data_parts` that returned True): straight onto the wire
        under the send lock, no further gate consultation.  Other
        traffic (control frames, flushed pending entries) may legally
        interleave between parts — bucket assembly at the receiver is
        keyed, not ordered."""
        with self._lock:
            send_frame_segments(self._sock, segments, cached=cached)
            self.stats["segments_sent"] += len(segments)

    def send_data_parts(self, parts) -> None:
        """SEVERAL admitted continuation frames coalesced into one
        gather-send: ``parts`` is a list of ``(segments, cached)``
        pairs, each a complete frame.  The sender streams buckets as
        separate `send_data_part` calls only while later buckets are
        still COMPUTING (that wait is the overlap window); buckets that
        are already materialized when the stream reaches them gain
        nothing from separate syscalls and pay a thread wakeup each at
        the receiver — measured ~40% of the per-update budget on a
        single-CPU host — so ready runs go out as one ``sendmsg`` of
        consecutive frames (byte-identical on the wire)."""
        with self._lock:
            iov: list = []
            n = 0
            for segments, cached in parts:
                iov.extend(frame_iovec(segments, cached))
                n += len(segments)
            sendmsg_all(self._sock, iov)
            self.stats["segments_sent"] += n

    def park_data_parts(self, parts) -> bool:
        """Park a whole multipart gradient as ONE pending entry —
        copy-on-park PER SEGMENT PER PART (the caller keeps ownership of
        every view it handed in, the `send_data` contract), sentinel
        checksum chained across the parked parts, oldest-first overflow
        shed of the entry (= the whole gradient).  Returns False (the
        frames did not hit the socket now), like a parked `send_data`."""
        with self._lock:
            parked = tuple([bytes(s) for s in part] for part in parts)
            self._pending.append(parked)
            if self._sentinel:
                self._sentries.append((self._entry_crc(parked),
                                       bytes(parked[0][0][:4]),
                                       _enqueue_site()))
            self._shed_overflow()
            return False

    # -- the READ gate (v10 subscription frames) ------------------------------
    #
    # A deliberately SEPARATE copy of the stall-then-shed machinery over
    # `_read_credits`/`_read_pending`: READ frames must never touch the
    # DATA gate's state (`_credits`/`_pace_left`) — sharing it would let
    # a reader flood consume the budget gradients replenish through,
    # which is exactly the starvation the class split exists to prevent
    # (and the PSL6xx protocol model checker verifies the DATA gate in
    # isolation for the same reason).

    # pslint: holds(_lock)
    def _read_gate_open(self) -> bool:
        self._assert_locked("_read_gate_open")
        return self._read_credits is None or self._read_credits > 0

    # pslint: holds(_lock)
    def _consume_read(self) -> None:
        self._assert_locked("_consume_read")
        if self._read_credits is not None:
            self._read_credits -= 1

    # pslint: holds(_lock)
    def _flush_read_pending(self) -> None:
        self._assert_locked("_flush_read_pending")
        while self._read_pending and self._read_gate_open():
            self._consume_read()
            self._put_entry(self._read_pending.popleft())

    def send_read(self, payload: bytes,
                  deadline: "Deadline | None" = None) -> bool:
        """One READ-class frame (a subscription request) through the
        read gate: sent when it is open, parked then shed OLDEST-FIRST
        when it is not — the oldest queued subscription request asks
        for the stalest view, so it is the least valuable one to keep.
        A request/response reader passes an already-expired ``deadline``
        to shed immediately instead of parking: an unsent request
        elicits no reply, so a parked one would wait for a replenish
        that can never arrive in-band (the `open_read` valve is the
        bounded-backoff recovery).  Copy-on-park, like `send_data`."""
        with self._lock:
            if self._read_gate_open():
                self._consume_read()
                send_frame(self._sock, payload)
                return True
            self.stats["reads_stalled"] += 1
            if deadline is not None and deadline.expired():
                self.stats["read_shed"] += 1
                return False
            self._read_pending.append(bytes(payload))
            if len(self._read_pending) > self.max_read_pending:
                self._read_pending.popleft()
                self.stats["read_shed"] += 1
            return False

    def replenish_read(self, credits: int) -> None:
        """Adopt a server-advertised READ window (the DELT reply's
        credit field) and flush what the new balance admits."""
        with self._lock:
            self._read_credits = int(credits)
            self._flush_read_pending()

    def read_credits(self) -> "int | None":
        with self._lock:
            return self._read_credits

    def open_read(self) -> None:
        """The READ gate's bounded-stall valve (cf. `open_pace`): grant
        one probe even though no replenish arrived — a subscriber whose
        window the server zeroed backs off for ``read_backoff`` seconds
        and then probes once; the probe's DELT reply re-advertises the
        live window.  A shed server costs a reader seconds of staleness,
        never a permanently dead subscription."""
        with self._lock:
            if self._read_credits is not None:
                self._read_credits = max(self._read_credits, 1)
            self._flush_read_pending()

    def reset_read(self) -> None:
        """Forget the advertised READ window (back to ungated) — the
        redial reset: a window a DEAD server incarnation advertised
        must not gate sends to its successor (a zeroed window would
        cost every failover one extra ``read_backoff`` of staleness
        and book sheds against a server that never refused anything —
        the credit analogue of the version-cache invalidation)."""
        with self._lock:
            self._read_credits = None
            self._flush_read_pending()

    def read_pending_count(self) -> int:
        with self._lock:
            return len(self._read_pending)

    def raw_send(self, chunks) -> None:
        """Pre-framed byte chunks under the send lock — the wire-chaos
        mangler's path (`utils.faults.WireMangler` owns the framing so
        it can corrupt/truncate it; frame-level injection deliberately
        bypasses the credit gate: the chaos exercises the receiver's
        hardening, not the sender's)."""
        with self._lock:
            for c in chunks:
                self._sock.sendall(c)

    # -- receiving ------------------------------------------------------------

    def recv(self, deadline: "Deadline | None" = None, *,
             into: "RecvArena | None" = None):
        """One framed receive, bounded by ``min(io_timeout, deadline)``.
        A recv that times out with the deadline spent raises
        `DeadlineExpired` (counted by the caller, healed like any
        transport error); an io_timeout without a deadline keeps the
        plain socket.timeout contract.  ``into`` routes the payload
        through a preallocated `RecvArena` and returns a memoryview
        into it (zero-copy; the arena's rotation bounds the view's
        validity) instead of fresh ``bytes``."""
        # One locked read of the socket reference (an `adopt` may be
        # swapping it); the blocking receive itself runs UNLOCKED on the
        # local reference — holding the send lock across a recv would
        # starve every sender (and the heartbeat) for a full io_timeout.
        # The read comes FIRST: a lock wait behind an in-flight sendall
        # must burn the deadline budget below, not overshoot a timeout
        # computed before the wait.
        with self._lock:
            sock = self._sock
        timeout = self.io_timeout
        if deadline is not None and deadline.budget is not None:
            if deadline.expired():
                raise DeadlineExpired(
                    f"transport op exceeded its {deadline.budget}s budget "
                    f"before the receive began")
            timeout = min(timeout, deadline.timeout())
        sock.settimeout(timeout)
        try:
            if into is not None:
                return into.recv_frame(sock)
            return recv_frame(sock)
        except socket.timeout:
            if deadline is not None and deadline.expired():
                raise DeadlineExpired(
                    f"transport op exceeded its {deadline.budget}s "
                    f"budget mid-receive") from None
            raise
        finally:
            # Restore the connection's base timeout: a deadline shrinks
            # THIS receive only — leaving the tiny remainder armed would
            # make the next multi-MB send (or a heartbeat during TCP
            # congestion — exactly the overload case) time out and tear
            # down a healthy connection.
            try:
                sock.settimeout(self.io_timeout)
            except OSError:  # pragma: no cover - socket died mid-op
                pass

    # -- heartbeat ------------------------------------------------------------

    def start_heartbeat(self) -> None:
        """Periodic BEAT frames on their own thread.  CONTROL class: the
        beat bypasses the credit gate, so a credit-stalled link (whose
        data frames park without touching the socket) keeps its
        liveness signal — the PS must never evict a rank for being
        *overloaded*."""
        if self.heartbeat_interval <= 0 or self._hb_thread is not None:
            return

        def beat():
            while not self._hb_stop.wait(self.heartbeat_interval):
                if self.link_down:
                    # Black-holed link (injected partition): the beat is
                    # swallowed like every other frame on it.
                    continue
                try:
                    self._send_control(b"BEAT")
                except TRANSPORT_ERRORS:
                    # The owner's loop heals the socket; a beat on a dead
                    # one is skipped — the next rides the new socket.
                    continue

        self._hb_thread = threading.Thread(target=beat, daemon=True,
                                           name="transport-beat")
        self._hb_thread.start()
