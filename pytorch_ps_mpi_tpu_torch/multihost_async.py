"""Multi-host asynchronous PS — AsySG-InCon across processes, over TCP.

Counterpart of `pytorch_ps_mpi_tpu/multihost_async.py`, its single-PS
deployment.  The reference's async design is multi-node: rank 0 receives
gradients from any source until a quota, steps, and re-broadcasts params
with inconsistent reads.  `async_ps.AsyncPS` runs that algorithm within
one process (workers are threads); here the PS is a process serving
parameters and consuming gradients over TCP, and each worker is an
independent process, on another host or on the same card, that pulls
params, computes grad + encode on its device and pushes back only the
*coded* payload, serialized by the port's copy of the native pipeline
(`native.serializer`).

The wire is the JAX package's protocol v12, and its frame heads are byte
for byte the JAX package's for the same values: the ``<II`` length/CRC
header (`transport`), PSA's fields, PARM's ``version | credits | codec``
and GRAD's ``bucket | n_buckets | seq | version | loss``.  The payloads
differ: the port's tree frame is ``PSTP`` where the JAX package's
(``PST2``) pickles a JAX ``PyTreeDef``, so a peer of the other package
fails loudly at its first payload — a port worker raises
`native.serializer.ForeignTreeFrameError` at its first PARM, and a
JAX-framed GRAD costs its own connection at a port server (counted in
``quarantined_frames``).  Code trees are keyed by the port's parameter
names; an order-dependent code is encoded in flax's element order
(`utils.interop.jax_order`), as the in-process PS does.

Frames (layouts in the JAX module's docstring):

* worker → PS ``HELO | flags | [prior_rank u32 if flags&1 |
  assigned_rank u32 if flags&2] | token`` → ``PSA | version | rank u32 |
  auth u8 | shard u16 | num_shards u16 | plan_digest u64 | credits u32 |
  wire_flags u8 | codec name`` (``NOAU`` on a bad token); flag 2 books a
  rank minted by shard 0 of a fleet verbatim, flag 4 a rank-less control
  connection;
* ``PULL | have u64`` → ``DONE`` or ``PARM | version u64 | credits u32 |
  codec u8 | [params]``, empty when ``have`` is the served version; each
  version is encoded once (``_parm_cache``) and fanned out;
* ``GRAD | bucket u16 | n_buckets u16 | seq u64 | version u64 | loss f64
  | codes`` (no reply), deduplicated per rank by ``seq``; a whole-tree
  gradient is ``(0, 1)``, a bucket-streamed one (`AsyncPSWorker`'s
  ``bucket_bytes``) is ``n_buckets`` frames sharing one ``seq``, each one
  bucket's code sub-tree, one code per parameter; the PS deduplicates per
  ``(seq, bucket)``, assembles per ``(rank, seq)`` in any arrival order,
  and the assembled tree enters the fill as a whole-tree frame does.  A
  partial assembly is retired, counted in ``bucket_partial_timeouts``,
  when a newer seq of the rank completes or its connection closes.  Flow
  control charges one credit per gradient, not per frame;
* ``BEAT`` (no reply); ``SPLN`` → ``SPLN | plan json``, the fleet's
  `shard.partition.ShardPlan` (empty on an unsharded PS), which a
  `shard.ShardRouter` adopts and checks against every shard's PSA digest;
* a reader's HELO carries flag 32 (a rank-less subscriber, counted in
  the ``subs_active`` gauge while its connection lives), then ``SUBS |
  have u64`` → ``DONE`` or ``DELT | version u64 | read credits u32 |
  flags u8 | codec u8 | [params]``: head-only with flag 1 when ``have``
  is the served version, head-only with flag 2 when the per-version
  read budget (``read_window``) is spent, else the version's
  encode-once payload, or under ``delta_parm`` a sparse diff against
  ``have`` (flag 4) from a ring of the recent post-decode trees.

Fault tolerance as in the JAX module: CRC-failed frames are frame-local
drops, silent ranks are evicted and the quota clamps, a reconnect
re-books its rank (`utils.backoff.Backoff`), admission sheds stale or
duplicate frames before decode under queue pressure, a credit window
bounds each sender (`transport.Session`), multi-MB decodes run on a small
off-GIL pool, and the serve loop auto-checkpoints every N updates in the
port's on-disk format (`utils.checkpoint`) with the serving version and
the rank allocation, so a killed PS resumes with continuous versions.

The fleet's frames (`shard.fleet.PSFleet` drives them over rank-less
control connections, HELO flag 4):

* aggregator → root ``AGGR | group u16 | n_contrib u16 | target u16 |
  bucket u16 | n_buckets u16 | seq u64 | version u64 | loss f64 |
  codes`` (no reply): the hierarchy's forward, one group-reduced
  per-contributor-mean gradient standing for ``n_contrib`` worker
  gradients (the root weights it by that multiplicity, so a short group
  fill moves the root pro-rata).  ``seq`` rides GRAD's per-rank dedup and
  the bucket fields work as on GRAD; ``agg_frames`` and the ``groups``
  view count assembled forwards, never bucket frames;
* primary → standby ``REPL | step u64 | codec u8 | checkpoint blob`` →
  ``ACKR | step u64 | credits u32``: hot-standby replication.  The blob is
  this package's checkpoint of the shard (`utils.checkpoint`, with the
  serving version and the rank allocation), its arrays through the
  server's wire codec; the standby keeps it as bytes of its own and
  decodes it at promotion.  A blob of another format (the JAX package's
  ``PST2`` tree frame) is refused at once, and counted;
* supervisor → shard ``SNAP | cut u64`` → ``SNAP | armed cut u64`` (0 =
  refused): the shard checkpoints at exactly fill boundary ``cut``
  (`_at_fill_boundary`), so K shards cut one consistent snapshot;
* supervisor → standby ``PROM | plan digest u64`` → ``PROM | replicated
  step u64`` (all ones: nothing replicated): the promotion fence; every
  later REPL is refused (``repl_refused``).

Two HELO flags carry the hierarchy's identity: flag 8 marks a group's
aggregator (``group u16 | target u16`` follow the optional rank field),
booked as a normal rank and named as group g's aggregator in the
``groups`` view; flag 16 marks a direct-fallback worker (``group u16``),
a worker whose aggregator died for good re-admitting itself at the root
(counted once in ``direct_fallbacks`` and listed under its group).

On the card:

* the serve loop is the only thread of the PS that touches the card:
  connection, accept and decode-pool threads run framing, CRC and the
  serializer (ctypes, the interpreter lock released) on host memory only;
* a fill's codes are stacked on the host into one staging buffer (pinned
  for a card) and cross in one copy; the update's params come back in one
  copy into fresh host memory each version — the encode-once PARM cache
  aliases the served host arrays as iovecs, so they are rebound, never
  written in place;
* a worker makes one host-to-device copy of a fresh pull (an unchanged
  conditional pull reuses its device tensors, keyed by the identity of
  the pulled host tree) and one device-to-host copy of its codes and loss
  a gradient, synchronized before they are serialized.
"""

from __future__ import annotations

import hmac
import math
import os
import queue
import socket
import struct
import sys
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

import numpy as np
import torch

from . import transport as _transport
from .async_ps import AsyncPS
from .errors import FillStarvedError, FleetDeadError, NotCompiledError
from .native import serializer
from .ops import codecs as _codecs
from .ops.codecs import Codec
from .parallel.mesh import resolve_device
from .transport import (_CONTROL_RANK, _NO_REPLICA, TRANSPORT_ERRORS,
                        Deadline, DeadlineExpired, FrameCRCError, Session,
                        frame_header, recv_frame, send_frame)
from .utils.backoff import Backoff
from .utils.bytes import bytes_of
from .utils.flatten import tree_flatten, tree_map, tree_unflatten

_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")
_U8 = struct.Struct("B")
_F64 = struct.Struct("<d")
# GRAD's bucket fields: a whole-tree gradient packs (0, 1).
_BKT = struct.Struct("<HH")
# AGGR's prefix: (group, contributor count, group fill target).
_GRP = struct.Struct("<HHH")
# Per-rank in-flight bucketed seqs remembered for dedup: older ones
# retire as a seq completed with missing buckets would (memory bounded
# against a flooding or seq-skipping peer).
_BUCKET_SEQ_WINDOW = 4
# Per-connection live partial assemblies: a peer streaming new seqs
# without completing one keeps at most this many (oldest retired and
# counted).
_ASSEMBLY_CAP = 4

# The JAX package's protocol version: the frame layouts above.
PROTOCOL_VERSION = 12
# Tree frames on the wire are store-framed (no shuffle+LZ: loopback and
# datacenter links are not thin).
_WIRE_LEVEL = 0
# PSA wire_flags: bit 1 = this server speaks the segmented wire.
_WIRE_SEGMENTED = 1
# Conditional-PULL "no cached version": an unconditional pull.
_UNVERSIONED = (1 << 64) - 1
# DELT reply flags (the serve tier): UNCHANGED = the subscriber's
# ``have`` equals the served version (head-only); SHED = the read-token
# budget of this version is spent (head-only, the reader backs off);
# DELTA = the payload is a sparse diff against ``have``.  Absent DELTA a
# payload is a full snapshot.
_DELT_UNCHANGED = 1
_DELT_SHED = 2
_DELT_DELTA = 4
# Delta ring depth: the recent post-decode versions kept for delta
# serving; a reader further behind gets a full snapshot.
_DELTA_RING = 4
# Read-token time floor: the read budget refills on every served-version
# advance, and after this many seconds at an unchanged version (an idle
# server still serves a bounded read rate).
_READ_REFILL_S = 0.25
# Worker-side same-version pacing: after this many consecutive unchanged
# pulls, the worker yields per further iteration, escalating with the
# streak — past a couple of in-flight gradients per version every extra
# one only deepens the server's backlog (staleness, never throughput).
_SAME_VERSION_PACE = 2
_SAME_VERSION_YIELD_S = 0.002
_SAME_VERSION_YIELD_MAX_S = 0.02
# A worker's heartbeat period, well inside the server's
# ``eviction_timeout``.
_HEARTBEAT_S = 2.0
# Frames at or above this payload size decode on the server's off-GIL
# pool; smaller ones inline.  A single-CPU host decodes inline always.
_DECODE_OFFLOAD_MIN = 1 << 16
try:
    _USABLE_CPUS = len(os.sched_getaffinity(0))
except (AttributeError, OSError):  # pragma: no cover - non-Linux
    _USABLE_CPUS = os.cpu_count() or 1
# In-flight offloaded decodes per connection.  Must stay strictly below
# the connection's RecvArena ring depth (3): an offloaded payload is a
# view into the arena, valid until its slot is refilled nbufs-1 receives
# later.
_DECODE_DEPTH = 2
_RECV_NBUFS = 3
assert _DECODE_DEPTH < _RECV_NBUFS

def control_connect(host: str, port: int, token: "str | None" = None,
                    timeout: float = 10.0) -> socket.socket:
    """`transport.control_connect` bound to this protocol version."""
    return _transport.control_connect(
        host, port, token=token, timeout=timeout,
        protocol_version=PROTOCOL_VERSION)


# ---------------------------------------------------------------------------
# Host <-> device trees: one copy each way
# ---------------------------------------------------------------------------

_ALIGN = 64


def _nbytes(shape, dtype: torch.dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def _host_leaf(x):
    """A host leaf as a CPU tensor (numpy arrays are shared, not
    copied)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def _wire_leaf(t: torch.Tensor):
    """A host tensor as the serializer's leaf: numpy, but for bfloat16
    (no numpy dtype), which stays a tensor."""
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _staging(specs, device: torch.device):
    """One host buffer (pinned when it feeds a card) carved into a tensor
    per ``(shape, dtype)`` spec at 64-byte aligned offsets.  Returns
    ``(buffer, offsets, views)``; `_ship` moves it in one copy."""
    offsets, pos = [], 0
    for shape, dtype in specs:
        offsets.append(pos)
        pos += (_nbytes(shape, dtype) + _ALIGN - 1) & ~(_ALIGN - 1)
    buf = torch.empty(max(pos, 1), dtype=torch.uint8,
                      pin_memory=device.type == "cuda")
    return buf, offsets, _carve(buf, offsets, specs)


def _carve(buf: torch.Tensor, offsets, specs) -> list:
    return [buf[o:o + _nbytes(shape, dtype)].view(dtype).view(shape)
            for o, (shape, dtype) in zip(offsets, specs)]


def _ship(buf, offsets, specs, views, device: torch.device) -> list:
    """The staged tensors on ``device``: one non-blocking copy of the
    whole buffer (the host views themselves on the CPU)."""
    if device.type == "cpu":
        return views
    return _carve(buf.to(device, non_blocking=True), offsets, specs)


def tree_to_device(tree, device: torch.device):
    """A host tree (numpy or CPU-tensor leaves) on ``device`` in one
    copy."""
    leaves, treedef = tree_flatten(tree)
    host = [_host_leaf(x) for x in leaves]
    specs = [(tuple(t.shape), t.dtype) for t in host]
    buf, offsets, views = _staging(specs, device)
    for v, t in zip(views, host):
        v.copy_(t)
    return tree_unflatten(treedef, _ship(buf, offsets, specs, views, device))


def stack_to_device(trees, device: torch.device):
    """The trees of a fill stacked leaf by leaf (a leading contributor
    dim) on the host, straight into the staging buffer, then on
    ``device`` in one copy."""
    flats, treedefs = zip(*(tree_flatten(t) for t in trees))
    cols = [[_host_leaf(x) for x in col] for col in zip(*flats)]
    specs = [((len(col),) + tuple(col[0].shape), col[0].dtype)
             for col in cols]
    buf, offsets, views = _staging(specs, device)
    for v, col in zip(views, cols):
        torch.stack(col, out=v)
    return tree_unflatten(treedefs[0],
                          _ship(buf, offsets, specs, views, device))


def tree_to_host(tree):
    """A device tree in fresh host memory with one device-to-host copy
    (synchronized): the leaves are packed into one device byte buffer at
    64-byte aligned offsets, copied, and carved into host views.  On the
    CPU the leaves are detached copies."""
    leaves, treedef = tree_flatten(tree)
    leaves = [x.detach() for x in leaves]
    if not leaves or leaves[0].device.type == "cpu":
        return tree_unflatten(treedef, [x.clone() for x in leaves])
    device = leaves[0].device
    pad = torch.zeros(_ALIGN, dtype=torch.uint8, device=device)
    parts, offsets, specs, pos = [], [], [], 0
    for x in leaves:
        x = x.contiguous()
        n = x.numel() * x.element_size()
        offsets.append(pos)
        specs.append((tuple(x.shape), x.dtype))
        parts.append(x.reshape(-1).view(torch.uint8))
        gap = (-n) % _ALIGN
        if gap:
            parts.append(pad[:gap])
        pos += n + gap
    host_buf = torch.cat(parts).cpu()
    return tree_unflatten(treedef, _carve(host_buf, offsets, specs))


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------

class AsyncPSServer(AsyncPS):
    """The rank-0 process of the multi-host async PS.

    Usage (PS host)::

        srv = AsyncSGDServer(named_params, lr=0.1, quota=8, port=5555)
        srv.compile_step(loss_fn)          # the code structure to expect
        history = srv.serve(steps=1000)    # serves until done, then stops
                                           # workers via DONE on their pulls

    Reuses the in-process `AsyncPS` machinery (codec, update rules, the
    fill loop, the robust reducers, checkpoint state, timing dicts); only
    the transport differs — gradients arrive from sockets instead of
    worker threads.  ``device`` holds the params and optimizer state: the
    card unless the caller passes ``"cpu"``.
    """

    def __init__(self, named_params, *, quota: int,
                 host: str = "127.0.0.1", port: int = 0,
                 device=None,
                 token: "str | None" = None,
                 conn_timeout: float = 60.0, shard_info=None,
                 standby: bool = False, replica_addr=None,
                 replica_every: int = 1,
                 op_deadline: "float | None" = None,
                 read_window: int = 0, wire_codec: str = "identity",
                 delta_parm: bool = False, **kw):
        device = resolve_device("cuda" if device is None else device)
        super().__init__(named_params, quota=quota, devices=[device], **kw)
        # Credit-based flow control: the window advertised in PSA/PARM
        # replies is the remaining queue room divided across the live
        # senders (`_advertised_credits`); the net queue is never smaller
        # than the window.
        self._credit_window = self.credit_window or max(quota * 2, 8)
        # The READ-class budget (the serve tier): at most this many
        # full-payload DELT replies per served-version advance (with the
        # idle-server time floor `_READ_REFILL_S`), so a reader flood
        # sheds head-only (``read_shed``) instead of competing with GRAD
        # service.  "Unchanged" replies are token-free.
        if read_window < 0:
            raise ValueError(
                f"read_window must be >= 0, got {read_window}")
        self._read_window = int(read_window) or max(4, quota)
        self._read_lock = threading.Lock()
        self._read_tokens = self._read_window  # guarded by _read_lock
        self._read_tokens_version = -1  # guarded by _read_lock
        self._read_tokens_t = 0.0  # guarded by _read_lock
        # The budget of this server's own client operations: the REPL
        # round trip to its standby (workers carry their own).
        self.op_deadline = op_deadline
        # Hot standby: ``standby=True`` is the receiving side (REPL blobs
        # stashed, PROM fences answered, no fills until promoted);
        # ``replica_addr`` the sending side (every ``replica_every``-th
        # update's checkpoint blob streamed to the standby).
        if standby and replica_addr is not None:
            raise ValueError("a standby cannot itself replicate onward "
                             "(chained replication is not supported)")
        if replica_every < 1:
            raise ValueError(
                f"replica_every must be >= 1, got {replica_every}")
        self._standby = standby
        self.replica_addr = (tuple(replica_addr)
                             if replica_addr is not None else None)
        self.replica_every = int(replica_every)
        self._repl_lock = threading.Lock()
        self._repl_step: "int | None" = None  # guarded by _repl_lock
        self._repl_blob: "bytes | None" = None  # guarded by _repl_lock
        # The codec byte of the newest REPL frame: promotion decodes the
        # stashed blob's arrays with it (the primary's wire codec).
        self._repl_codec = 0  # guarded by _repl_lock
        self._promoted = False  # guarded by _repl_lock
        # The sending side's state, touched by the serve loop only: the
        # replication stream rides a credit-gated session (REPL is a data
        # frame), so a slow standby sheds replication payloads instead of
        # blocking the serve loop.
        self._repl_session: "Session | None" = None
        self._last_acked = 0
        # Coordinated-snapshot markers: cuts armed by SNAP frames
        # (connection threads), written at the fill boundary (the serve
        # loop); both under _stats_lock.
        self._snap_cuts: "set[int]" = set()
        self._snap_path = None
        # The fleet identity (`shard.partition.ShardInfo`, duck-typed): the
        # slice of the plan this server owns, advertised in every PSA and
        # served in full over SPLN.  An unsharded PS advertises the trivial
        # (0, 1, digest=0) triple and serves an empty plan.
        if shard_info is not None:
            self._shard_index = int(shard_info.index)
            self._shard_count = int(shard_info.count)
            self._plan_digest = int(shard_info.digest)
            self._plan_json = bytes(shard_info.plan_json)
        else:
            self._shard_index, self._shard_count = 0, 1
            self._plan_digest = 0
            self._plan_json = b""
        # A peer that stops mid-frame costs its connection after this
        # long (healthy workers heartbeat every ~2 s).
        self.conn_timeout = conn_timeout
        # Optional shared-secret admission (not encryption): every
        # message before an authenticated HELO is refused.  "" is unset.
        self.token = token or None
        self._host = host
        self._listener = socket.create_server((host, port))
        self.address: "tuple[str, int]" = self._listener.getsockname()[:2]
        self._conn_threads: "list[threading.Thread]" = []
        self._net_queue: "queue.Queue" = queue.Queue(
            maxsize=max(self._credit_window, quota * 2, 8))
        self._net_stop = threading.Event()
        # Permanent-shutdown latch: only close() sets it.
        self._closed = threading.Event()
        self._next_rank = 0  # guarded by _rank_lock
        # Lock order: _rank_lock before _stats_lock (the snapshot takes
        # both); the session send lock is outer to _stats_lock too.
        self._rank_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        # The leaf-wise serving snapshot (host arrays) and its version —
        # the surface remote PULLs read.  Only the serve loop writes it,
        # rebinding existing keys leaf by leaf (mid-update pulls see
        # mixed leaves: AsySG-InCon); the arrays are never written in
        # place, since a cached PARM aliases them.
        self._served = self._host_params()
        self._served_version = 0
        # Encode-once PARM fanout: the segment set of the current served
        # version, built by the first pull at that version.
        self._parm_lock = threading.Lock()
        self._parm_cache = None  # guarded by _parm_lock
        # The server-side parameter wire codec, applied inside the
        # encode-once cache; validated here, not at the first pull.
        self._wire_codec = str(wire_codec)
        self._wire_codec_id = _codecs.wire_codec_id(self._wire_codec)
        # Delta snapshots (the DELT path only): a ring of the recent
        # post-decode trees (what a reader holds after decoding a frame)
        # and the encoded diff of each (have, version) pair, both under
        # `_parm_lock` with the PARM cache; `load_state_dict` clears all
        # three.
        self._delta_parm = bool(delta_parm)
        self._delta_ring = OrderedDict()  # guarded by _parm_lock
        self._delta_cache = {}  # guarded by _parm_lock
        # Off-GIL decode pool (ctypes releases the interpreter lock): a
        # connection thread is back in recv_into while its previous
        # frame decodes.  A single-CPU host decodes inline.
        self._decode_pool = ThreadPoolExecutor(
            max_workers=min(2, max(1, _USABLE_CPUS - 1)),
            thread_name_prefix="ps-decode")
        self._decode_offload_min: "int | None" = (
            _DECODE_OFFLOAD_MIN if _USABLE_CPUS > 1 else None)
        self._idle_timeout = 300.0
        self._workers_seen = 0  # guarded by _rank_lock
        self._conn_drops = 0  # guarded by _stats_lock
        self._last_drop: "BaseException | None" = None
        self._last_drop_warn = 0.0
        self._serve_t0: "float | None" = None
        self._fill_next_step = 0  # guarded by _stats_lock
        # Set when a FaultPlan kills this PS: shutdown is then abrupt (no
        # DONE on pending PULLs), so workers reconnect to its successor.
        self._dying = False
        # Per-rank liveness (guarded by _rank_lock): last-seen time, live
        # connection count, the live/evicted partition the quota clamps
        # to, and the high-water GRAD seq for dedup.
        self._last_seen: "dict[int, float]" = {}
        self._conns_for_rank: "dict[int, int]" = {}
        self._live_ranks: "set[int]" = set()
        self._evicted: "set[int]" = set()
        self._last_seq: "dict[int, int]" = {}
        # Bucket-stream dedup: per rank, the buckets seen of each
        # in-flight bucketed seq (at most `_BUCKET_SEQ_WINDOW`);
        # `_last_seq` advances when a bucketed seq completes.
        self._bucket_seen: "dict[int, dict[int, set]]" = {}
        # The hierarchy's groups view (guarded by _rank_lock): per group,
        # its aggregator's rank (HELO flag 8), the group fill target, the
        # AGGR forwards admitted, the last forward's contributor count,
        # and the ranks that re-admitted themselves direct (flag 16).
        self._groups: "dict[int, dict]" = {}
        # Transport counters on top of the admission counters `AsyncPS`
        # installs (connection threads bump them: `_bump` takes a lock).
        self.fault_stats.update({
            "evictions": 0, "reconnects": 0, "crc_dropped": 0,
            "quarantined_frames": 0, "accept_errors": 0,
            "duplicate_dropped": 0, "evicted_dropped": 0,
            # REPL frames sent (primary), applied and refused after the
            # PROM fence (standby), the primary's unacked-lag gauge, and
            # the SNAP-cut checkpoints written at fill boundaries.
            "repl_sent": 0, "repl_received": 0, "repl_refused": 0,
            "repl_lag": 0, "snapshot_barriers": 0,
            # AGGR forwards admitted (one an assembled forward), and
            # workers booked as direct fallbacks after their aggregator
            # died.
            "agg_frames": 0, "direct_fallbacks": 0,
            "dropped_queue_full": {},
        })

    # -- the published host params --------------------------------------------

    def _host_params(self) -> "dict[str, Any]":
        """The params in fresh host memory, one copy (the serializer's
        leaves: numpy, a bf16 leaf a CPU tensor)."""
        return {n: _wire_leaf(t)
                for n, t in tree_to_host(self.params).items()}

    def _publish(self) -> None:
        """Rebind the served leaves to this update's params (one copy,
        fresh host memory) and advance the version."""
        host = self._host_params()
        for n, a in host.items():   # leaf by leaf: InCon reads
            self._served[n] = a
        self._served_version += 1

    # -- the code structure GRAD payloads must carry --------------------------

    def compile_step(self, loss_fn) -> None:
        super().compile_step(loss_fn)
        # A worker running another codec would enqueue a mismatched tree
        # that explodes inside the serve loop's stack/apply; validating
        # at decode costs only the bad connection.
        with torch.no_grad():
            dummy = OrderedDict(
                (n, self.code.encode(torch.zeros(shape, dtype=dtype,
                                                 device=self.ps_device)))
                for n, (shape, dtype) in self._metas.items())
        self._index_code_meta(dummy)

    def _index_code_meta(self, dummy) -> None:
        """The validation indexes of incoming payloads, from one encoded
        zero tree: the whole tree's (treedef, leaf meta), and the same
        per parameter, which a bucket's sub-tree is checked against (the
        worker chooses a bucket's names; the assembly checks that the
        buckets cover the tree)."""
        leaves, self._code_treedef = tree_flatten(dummy)
        self._code_leaf_meta = [(tuple(x.shape), x.dtype) for x in leaves]
        self._code_nbytes = sum(x.numel() * x.element_size()
                                for x in leaves)
        self._code_meta_by_name = {}
        for n, c in dummy.items():
            sub, sub_def = tree_flatten(c)
            self._code_meta_by_name[n] = (
                sub_def, [(tuple(x.shape), x.dtype) for x in sub])

    def _validate_codes(self, codes) -> None:
        leaves, treedef = tree_flatten(codes)
        meta = [(tuple(x.shape), x.dtype) for x in leaves]
        if treedef != self._code_treedef or meta != self._code_leaf_meta:
            raise ValueError(
                "gradient payload does not match the server codec's code "
                "structure (worker running a different codec?)")

    def _validate_codes_bucket(self, codes) -> None:
        """A bucket's payload: every name a parameter of this server, and
        each name's code of the compiled structure (the assembly checks
        that the buckets cover the tree)."""
        if not isinstance(codes, dict) or not codes:
            raise ValueError(
                "bucket payload is not a name-keyed code sub-tree")
        for n, c in codes.items():
            expected = self._code_meta_by_name.get(n)
            if expected is None:
                raise ValueError(
                    f"bucket payload names unknown parameter {n!r}")
            sub, sub_def = tree_flatten(c)
            meta = [(tuple(x.shape), x.dtype) for x in sub]
            if sub_def != expected[0] or meta != expected[1]:
                raise ValueError(
                    f"bucket payload for {n!r} does not match the server "
                    f"codec's code structure (worker running a different "
                    f"codec?)")

    def _decode_codes(self, payload):
        """CRC-verify + decode + validate one GRAD payload (host only: the
        work the decode pool runs off the connection thread)."""
        codes = tree_map(_host_leaf, serializer.loads(payload))
        self._validate_codes(codes)
        return codes

    def _decode_codes_bucket(self, payload):
        """`_decode_codes` for one bucket's frame: validated per name."""
        codes = tree_map(_host_leaf, serializer.loads(payload))
        self._validate_codes_bucket(codes)
        return codes

    def _norm_fn(self, codes):
        return super()._norm_fn(
            tree_map(lambda x: x.to(self.ps_device), codes))

    # -- rank liveness bookkeeping --------------------------------------------

    def _register_conn(self, prior: "int | None",
                       assigned: "int | None" = None) -> int:
        """Book an authenticated HELO: a fresh worker gets the next rank;
        a reconnect (``prior`` set) re-books the same rank, un-evicting
        it; ``assigned`` books a rank minted elsewhere verbatim."""
        now = time.monotonic()
        with self._rank_lock:
            if prior is not None:
                rank = prior
                self._next_rank = max(self._next_rank, rank + 1)
            elif assigned is not None:
                rank = assigned
                self._next_rank = max(self._next_rank, rank + 1)
                if rank not in self._last_seen:
                    self._workers_seen += 1
            else:
                rank = self._next_rank
                self._next_rank += 1
                self._workers_seen += 1
            self._live_ranks.add(rank)
            self._evicted.discard(rank)
            self._last_seen[rank] = now
            self._conns_for_rank[rank] = \
                self._conns_for_rank.get(rank, 0) + 1
        if prior is not None:
            self._bump("reconnects")
        return rank

    def _release_conn(self, rank: int) -> None:
        with self._rank_lock:
            self._conns_for_rank[rank] = \
                self._conns_for_rank.get(rank, 1) - 1

    def _mark_alive(self, rank: int) -> None:
        """Refresh a rank's last-seen age, and reverse its eviction when
        traffic resumed on a connection that never died."""
        with self._rank_lock:
            self._last_seen[rank] = time.monotonic()
            if rank in self._evicted:
                self._evicted.discard(rank)
                self._live_ranks.add(rank)
                print(f"async PS: worker rank {rank} resumed after "
                      f"eviction — re-admitted", file=sys.stderr)

    def _bump(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.fault_stats[key] += n

    # -- the hierarchy's groups view -----------------------------------------

    def _group_entry(self, group: int) -> dict:
        """Group ``group``'s entry of the view (holds ``_rank_lock``)."""
        return self._groups.setdefault(int(group), {
            "aggregator_rank": None, "group_target": 0, "agg_frames": 0,
            "last_contributors": 0, "fallback_ranks": []})

    def _note_aggregator(self, group: int, rank: int,
                         target: int) -> None:
        """Book a HELO flag-8 connection: ``rank`` is group ``group``'s
        aggregator (a restarted aggregator re-presenting its rank
        re-claims the entry: no churn in the view)."""
        with self._rank_lock:
            entry = self._group_entry(group)
            entry["aggregator_rank"] = rank
            entry["group_target"] = int(target)

    def _note_fallback(self, group: int, rank: int) -> None:
        """Book a HELO flag-16 connection: ``rank`` is a worker of group
        ``group`` re-admitting itself direct after its aggregator died."""
        with self._rank_lock:
            entry = self._group_entry(group)
            if rank not in entry["fallback_ranks"]:
                entry["fallback_ranks"].append(rank)
        self._bump("direct_fallbacks")

    def _note_group_frame(self, group: int, rank: int,
                          n_contrib: int) -> None:
        with self._rank_lock:
            entry = self._group_entry(group)
            entry["aggregator_rank"] = rank
            entry["agg_frames"] += 1
            entry["last_contributors"] = int(n_contrib)

    def _evict_dead(self, eviction_timeout: float,
                    dead_conn_grace: float) -> None:
        """Evict live ranks that went silent: past ``eviction_timeout``
        with no frame, or past ``dead_conn_grace`` with no connection."""
        now = time.monotonic()
        with self._rank_lock:
            dead = []
            for r in list(self._live_ranks):
                age = now - self._last_seen.get(r, now)
                gone = self._conns_for_rank.get(r, 0) <= 0
                if age > eviction_timeout or (gone and age > dead_conn_grace):
                    self._live_ranks.discard(r)
                    self._evicted.add(r)
                    dead.append(r)
        for r in dead:
            self._bump("evictions")
            # A ghost frozen at its pre-death pace would skew the fleet
            # medians behind latency weighting and the adaptive deadline.
            self._latency.forget(r)
            print(f"async PS: evicted worker rank {r} "
                  f"(silent/disconnected)", file=sys.stderr)

    def _effective_quota(self) -> int:
        """The quota clamped to the live fleet once an eviction has
        happened (during a healthy ramp-up the configured quota stands),
        shrunk by quarantined ranks under rank-distinct fills, never below
        the reducer's breakdown size (`_shrink_floor`)."""
        with self._rank_lock:
            if not self._evicted:
                q = self.quota
            else:
                q = max(1, min(self.quota, len(self._live_ranks) or 1))
        if self._rank_distinct and self._scoreboard is not None:
            nq = len(self._scoreboard.quarantined_ranks())
            q = max(1, q - nq)
        return self._shrink_floor(q, "eviction/quarantine")

    def _eligible_rank_count(self) -> int:
        with self._rank_lock:
            live = set(self._live_ranks) - self._evicted
        if self._scoreboard is not None:
            live -= set(self._scoreboard.quarantined_ranks())
        return len(live)

    # -- fill-admission hooks (the shared loop is `AsyncPS._fill_gradients`) --

    def _fill_target(self) -> int:
        return self._effective_quota()

    def _fleet_ranks(self) -> "set[int]":
        with self._rank_lock:
            return set(self._live_ranks)

    def _drop_before_admit(self, rank) -> bool:
        """An evicted rank's in-flight gradient must not satisfy a fill;
        re-admission happens on live traffic (`_mark_alive`)."""
        if rank is None:
            return False
        with self._rank_lock:
            evicted_now = rank in self._evicted
        if evicted_now:
            self._bump("evicted_dropped")
        return evicted_now

    def _check_fill_starved(self, n_filled: int, t0: float) -> None:
        """With no quorum to close short, a fill holding one frame from
        every eligible rank that still needs more distinct ranks can never
        complete: fail after ``idle_timeout`` instead of spinning."""
        eligible = self._eligible_rank_count()
        if (self.quorum is None and eligible > 0
                and n_filled >= eligible
                and time.perf_counter() > t0 + self._idle_timeout):
            raise FillStarvedError(
                f"fill starved for {self._idle_timeout:.0f}s: aggregate="
                f"{self.aggregate!r} admits one contribution per rank per "
                f"fill and the fill target is {self._effective_quota()}, "
                f"but only {eligible} distinct eligible rank(s) are "
                f"connected — add workers, lower --quota, or set "
                f"--quorum/--fill-deadline")

    def _fault_stats_snapshot(self) -> "dict[str, Any]":
        now = time.monotonic()
        with self._rank_lock, self._stats_lock:
            snap = self._base_fault_snapshot()
            snap["conn_drops"] = self._conn_drops
            snap["workers_seen"] = self._workers_seen
            drops_total = sum(
                self.fault_stats["dropped_queue_full"].values())
            elapsed = (time.perf_counter() - self._serve_t0
                       if self._serve_t0 is not None else 0.0)
            snap["dropped_queue_full_rate"] = (
                round(drops_total / elapsed, 4) if elapsed > 0 else 0.0)
            snap["live_ranks"] = sorted(self._live_ranks)
            snap["evicted_ranks"] = sorted(self._evicted)
            snap["heartbeat_ages"] = {
                r: round(now - t, 3) for r, t in self._last_seen.items()}
            if self._groups:
                # The hierarchy's per-group detail, keyed by group id as a
                # string (as "shards" is).
                snap["groups"] = {str(g): dict(info)
                                  for g, info in sorted(
                                      self._groups.items())}
        return snap

    # -- connection handling --------------------------------------------------

    def _accept_loop(self):
        _transport.accept_pump(
            self._listener, self._net_stop, self._conn_loop,
            on_error=lambda: self._bump("accept_errors"),
            threads=self._conn_threads)

    def _advertised_credits(self) -> int:
        """The remaining net-queue room shared across the live senders:
        at least one credit per sender while any room exists, 0 when the
        server is saturated (senders stall-then-shed at their end)."""
        room = self._credit_window - self._net_queue.qsize()
        if room <= 0:
            return 0
        with self._rank_lock:
            live = len(self._live_ranks)
        return max(1, room // max(1, live))

    def _refill_read_tokens(self, version: int, now: float) -> None:
        """Refill the read-token bucket when the served version moved
        (``read_window`` full-payload reads per unit of training
        progress) or after the idle-server time floor.  Holds
        ``_read_lock``."""
        if (version != self._read_tokens_version
                or now - self._read_tokens_t >= _READ_REFILL_S):
            self._read_tokens_version = version
            self._read_tokens_t = now
            self._read_tokens = self._read_window

    def _take_read_token(self) -> bool:
        """One full-payload DELT permit, or False = shed this read
        (head-only SHED reply, counted).  Connection threads race for
        tokens under ``_read_lock`` alone."""
        version = self._served_version
        now = time.monotonic()
        with self._read_lock:
            self._refill_read_tokens(version, now)
            if self._read_tokens <= 0:
                return False
            self._read_tokens -= 1
            return True

    def _advertised_read_credits(self) -> int:
        """The READ window advertised in every DELT reply, which seeds
        the subscriber's sender-side gate (`Session.send_read`): the
        tokens still available at the current version."""
        version = self._served_version
        now = time.monotonic()
        with self._read_lock:
            self._refill_read_tokens(version, now)
            return max(0, self._read_tokens)

    def _under_pressure(self) -> bool:
        """Queue at >= half the credit window: pre-decode admission
        shedding turns on."""
        return self._net_queue.qsize() * 2 >= self._credit_window

    def _shed_before_decode(self, rank, seq: int, version: int,
                            bucket: int = 0, n_buckets: int = 1) -> bool:
        """Under queue pressure, a GRAD frame the policy would reject
        anyway (stale beyond the clamp, or a per-rank duplicate, per
        bucket on a bucket stream) is shed from its header alone, before
        decode (``admission_shed``)."""
        if rank is None or not self._under_pressure():
            return False
        stale = (self.max_staleness is not None
                 and self._served_version - version > self.max_staleness)
        with self._rank_lock:
            dup = seq <= self._last_seq.get(rank, -1)
            if not dup and n_buckets > 1:
                dup = bucket in self._bucket_seen.get(rank, {}).get(
                    seq, ())
        if stale or dup:
            self._bump("admission_shed")
            return True
        return False

    def _burn_seq(self, rank: int, seq: int, bucket: int = 0,
                  n_buckets: int = 1) -> bool:
        """Per-rank monotone dedup at receive time, in wire order: True
        when the frame is fresh.  A whole-tree frame keeps the high-water
        rule.  A bucket frame is fresh while its seq is above the mark and
        its bucket unseen for that seq; the seq's last bucket advances
        the mark and retires the seq's set, so a late duplicate bucket
        still reads as a duplicate by the high-water rule."""
        with self._rank_lock:
            last = self._last_seq.get(rank, -1)
            if seq <= last:
                return False
            if n_buckets <= 1:
                self._last_seq[rank] = seq
                # A whole-tree frame above the mark retires the in-flight
                # bucketed seqs at or below it.
                seen = self._bucket_seen.get(rank)
                if seen:
                    for s in [s for s in seen if s <= seq]:
                        del seen[s]
                return True
            seen = self._bucket_seen.setdefault(rank, {})
            got = seen.setdefault(seq, set())
            if bucket in got:
                return False
            got.add(bucket)
            if len(got) >= n_buckets:
                self._last_seq[rank] = max(last, seq)
                del seen[seq]
            elif len(seen) > _BUCKET_SEQ_WINDOW:
                del seen[min(seen)]
            return True

    def _recv_arena_hint(self) -> int:
        """Each receive slot pre-sized to the expected GRAD frame."""
        total = getattr(self, "_code_nbytes", None)
        if not total:
            return 1 << 16
        return int(total) + 256 * len(self._code_leaf_meta) + 4096

    def _parm_payload(self):
        """Encode-once PARM fanout: ``(version, meta_blob, segments)`` of
        the current served version, encoded by the first pull at that
        version (``parm_encodes``) and reused by every later one
        (``parm_fanout_reuse``).  The snapshot read races the serve
        loop's leaf-wise publish: the inconsistent read of AsySG-InCon,
        paid once a version."""
        with self._parm_lock:
            version = self._served_version
            cache = self._parm_cache
            fresh = cache is None or cache[0] != version
            if fresh:
                leaves = OrderedDict(
                    (n, self._served[n]) for n in self._served)
                wire = _codecs.encode_wire_tree(self._wire_codec, leaves)
                meta_blob, segs = serializer.encode_segments(
                    wire, level=_WIRE_LEVEL)
                cache = (version, meta_blob, segs)
                self._parm_cache = cache
                raw = _codecs.tree_raw_nbytes(leaves)
                if self._delta_parm:
                    # The ring keeps the post-decode tree, so the
                    # server's diffs match a reader's patches bitwise.
                    # Under identity it aliases the served leaves, which
                    # the serve loop rebinds to fresh host memory each
                    # version and never writes in place.
                    if self._wire_codec_id == 0:
                        decoded = leaves
                    else:
                        decoded = _codecs.decode_wire_tree(
                            self._wire_codec_id, wire)
                    ring = self._delta_ring
                    ring[version] = decoded
                    while len(ring) > _DELTA_RING:
                        old, _ = ring.popitem(last=False)
                        for key in [k for k in self._delta_cache
                                    if k[0] == old]:
                            del self._delta_cache[key]
        if fresh:
            self._bump("parm_encodes")
            self._bump("parm_bytes_raw", raw)
            self._bump("parm_bytes_wire", cache[2].wire_len)
        else:
            self._bump("parm_fanout_reuse")
        return cache

    def _delta_payload(self, have: int):
        """One encoded delta ``(version, meta_blob, segs)`` for a
        subscriber at version ``have``, or None on a ring miss or when the
        delta is not smaller than the full frame (the caller serves the
        full snapshot).  The diff of a (have, version) pair is computed
        once and fanned out, as `_parm_payload` is."""
        version, meta_blob, segs = self._parm_payload()
        cached = (None, None)
        with self._parm_lock:
            base = self._delta_ring.get(have)
            cur = self._delta_ring.get(version)
            if (version == self._served_version and base is not None
                    and cur is not None and have != version):
                cached = self._delta_cache.get((have, version))
                if cached is None:
                    delta, nbytes = _codecs.diff_wire_delta(base, cur)
                    # A delta bigger than the full frame serves nobody.
                    if nbytes >= segs.wire_len:
                        cached = (None, None)
                    else:
                        cached = serializer.encode_segments(
                            delta, level=_WIRE_LEVEL)
                    self._delta_cache[(have, version)] = cached
        hit = cached[0] is not None
        self._bump("delta_hits" if hit else "delta_misses")
        return (version, *cached) if hit else None

    # -- the per-connection decode pipeline -----------------------------------

    def _finish_decode(self, decodes) -> None:
        """Complete the oldest in-flight decode and enqueue its item —
        FIFO, so enqueue order stays receive order per connection.  A
        bucket frame (``binfo`` set) goes to its assembly instead, which
        enqueues once the gradient is complete."""
        fut, tail, rank, _frame, binfo = decodes.popleft()
        try:
            codes = fut.result()
        except Exception:
            self._bump("quarantined_frames")
            raise
        self._deliver(codes, tail, rank, binfo)

    def _deliver(self, codes, tail, rank, binfo) -> None:
        if binfo is None:
            self._enqueue_grad((codes, *tail), rank)
        else:
            self._assemble_bucket(binfo, codes, tail, rank)

    def _assemble_bucket(self, binfo, codes, tail, rank) -> None:
        """Fold one decoded bucket into its ``(rank, seq)`` assembly.  Once
        every bucket of the seq has landed, the sub-trees are merged in
        the server's parameter order and the gradient is enqueued: it
        enters the fill exactly as a whole-tree frame does.

        A newer seq completing from the same rank retires that rank's
        older partial assemblies (their missing buckets were shed or lost
        and can no longer arrive, since `_burn_seq` moved the mark), and
        so does the `_ASSEMBLY_CAP`; each retirement counts
        ``bucket_partial_timeouts``.  The gradient is absent, a straggler
        the fill already absorbs."""
        assembler, seq, bucket, n_buckets, on_complete = binfo
        key = (rank, seq)
        entry = assembler.get(key)
        if entry is None:
            entry = assembler[key] = {"n": n_buckets, "parts": {},
                                      "tail": tail}
            if len(assembler) > _ASSEMBLY_CAP:
                oldest = min(assembler,
                             key=lambda k: (k[1], k[0] is None, k[0]))
                if oldest != key:
                    del assembler[oldest]
                    self._bump("bucket_partial_timeouts")
        entry["parts"][bucket] = codes
        if len(entry["parts"]) < entry["n"]:
            return
        del assembler[key]
        for old in [k for k in assembler if k[0] == rank and k[1] < seq]:
            del assembler[old]
            self._bump("bucket_partial_timeouts")
        flat: dict = {}
        for sub in entry["parts"].values():
            flat.update(sub)
        if set(flat) != set(self.params):
            # Valid buckets whose union is not the tree: the worker's
            # bucket plan does not match this server's parameters.
            self._bump("quarantined_frames")
            raise ValueError(
                f"assembled bucket stream covers {len(flat)} parameter(s) "
                f"but this server owns {len(self.params)} — worker bucket "
                f"plan does not match the served tree")
        self._bump("buckets_filled", entry["n"])
        if on_complete is not None:
            # Per-gradient bookkeeping (an AGGR forward's agg_frames and
            # groups view) counts the assembled gradient, never a frame.
            on_complete()
        self._enqueue_grad(
            (OrderedDict((n, flat[n]) for n in self.params),
             *entry["tail"]), rank)

    def _dispatch_decode(self, decodes, payload, tail,
                         rank: "int | None", frame_idx: int,
                         binfo=None) -> None:
        """Decode one admitted GRAD payload and enqueue ``(codes,
        *tail)``: multi-MB frames on the decode pool (``decode_offloaded``),
        at most `_DECODE_DEPTH` deep per connection; small ones inline.
        ``frame_idx`` is the arena's receive count at dispatch, which the
        connection loop's pre-receive drain checks.  ``binfo`` marks a
        bucket frame, ``(assembler, seq, bucket, n_buckets,
        on_complete)``: decoded like any frame (bucket b decodes while b+1
        is on the wire), then handed to `_assemble_bucket`, which calls
        ``on_complete`` (or None) once the gradient is assembled."""
        decode = (self._decode_codes if binfo is None
                  else self._decode_codes_bucket)
        if (self._decode_offload_min is not None
                and payload.nbytes >= self._decode_offload_min):
            while len(decodes) >= _DECODE_DEPTH:
                self._finish_decode(decodes)
            decodes.append((self._decode_pool.submit(decode, payload),
                            tail, rank, frame_idx, binfo))
            self._bump("decode_offloaded")
            while decodes and decodes[0][0].done():
                self._finish_decode(decodes)
            return
        while decodes:  # keep per-connection enqueue order
            self._finish_decode(decodes)
        try:
            codes = decode(payload)
        except Exception:
            self._bump("quarantined_frames")
            raise
        self._deliver(codes, tail, rank, binfo)

    def _enqueue_grad(self, item, rank: "int | None",
                      patience: "float | None" = None) -> bool:
        """Bounded put with backpressure; a gradient abandoned because the
        run is shutting down, or stuck behind a full queue past the
        patience budget (``conn_timeout``), is counted per rank and
        reported (rate-limited live, once per worker at the end)."""
        wait = Deadline(self.conn_timeout if patience is None
                        else patience)
        while not self._net_stop.is_set() and not wait.expired():
            try:
                self._net_queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        now = time.monotonic()
        with self._stats_lock:
            d = self.fault_stats["dropped_queue_full"]
            key = -1 if rank is None else rank
            d[key] = d.get(key, 0) + 1
            total = sum(d.values())
            warn = now - self._last_drop_warn > 5.0
            if warn:
                self._last_drop_warn = now
        if warn:
            print(f"async PS warning: net queue full — {total} "
                  f"gradient(s) dropped so far (consumer overloaded or "
                  f"shutting down; see dropped_queue_full_rate in "
                  f"fault_stats)", file=sys.stderr)
        return False

    def _conn_loop(self, conn: socket.socket):
        """Serve one connection.  Any failure (disconnect, malformed or
        refused frame, stray bytes) is connection-local: it closes this
        socket and is counted, never aborting the run.  A frame failing
        its CRC on an authenticated worker connection is dropped and
        counted; the connection lives on (up to a bounded streak)."""
        authed = self.token is None
        rank: "int | None" = None
        is_sub = False  # a subscriber (HELO flag 32): subs_active gauge
        crc_streak = 0
        # Every frame lands in a rotating receive ring: ``msg`` is a view
        # into it, valid for nbufs-1 further receives.
        arena = _transport.RecvArena(self._recv_arena_hint(),
                                     nbufs=_RECV_NBUFS)
        decodes: "deque" = deque()
        # This connection's partial bucket assemblies, by (rank, seq).
        assembler: dict = {}
        try:
            with conn:
                if self.conn_timeout:
                    conn.settimeout(self.conn_timeout)
                try:
                    conn.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
                except OSError:
                    pass  # non-TCP test sockets (socketpair)
                while True:
                    # Finish any offloaded decode whose payload slot the
                    # next receive would overwrite (every frame rotates
                    # the ring, control frames included).
                    while (decodes and arena.frames - decodes[0][3]
                            >= arena.window):
                        self._finish_decode(decodes)
                    try:
                        msg = arena.recv_frame(conn)
                    except FrameCRCError:
                        self._bump("crc_dropped")
                        crc_streak += 1
                        if rank is None or crc_streak > 16:
                            raise
                        continue
                    crc_streak = 0
                    kind, body = bytes(msg[:4]), msg[4:]
                    if kind == b"HELO":
                        flags = body[0] if body else 0
                        off = 1 if body else 0
                        prior: "int | None" = None
                        assigned: "int | None" = None
                        agg_group: "int | None" = None
                        agg_target = 0
                        fb_group: "int | None" = None
                        if flags & 1:
                            (prior,) = struct.unpack_from("<I", body, off)
                            off += 4
                        elif flags & 2:
                            (assigned,) = struct.unpack_from(
                                "<I", body, off)
                            off += 4
                        if flags & 8:
                            # This connection is group g's aggregator.
                            agg_group, agg_target = struct.unpack_from(
                                "<HH", body, off)
                            off += 4
                        if flags & 16:
                            # A worker of group g whose aggregator died
                            # for good, re-admitting itself direct.
                            (fb_group,) = struct.unpack_from(
                                "<H", body, off)
                            off += 2
                        if self.token is not None:
                            if not hmac.compare_digest(
                                    bytes(body[off:]),
                                    self.token.encode()):
                                send_frame(conn, b"NOAU")
                                raise ValueError("bad admission token")
                        authed = True
                        if flags & 32 and not is_sub:
                            # A serve-tier reader: rank-less like a
                            # control connection, counted in the
                            # subs_active gauge while it lives.
                            is_sub = True
                            self._bump("subs_active")
                        if flags & (4 | 32):
                            # A control connection or a subscriber:
                            # authenticated but rank-less (no worker
                            # identity, eviction, quota or workers_seen
                            # entry).
                            rank = None
                        else:
                            rank = self._register_conn(prior, assigned)
                            if agg_group is not None:
                                self._note_aggregator(agg_group, rank,
                                                      agg_target)
                            if fb_group is not None and prior is None:
                                # A fallback reconnect (prior set) is the
                                # same worker riding a blip: only the
                                # first direct admission counts.
                                self._note_fallback(fb_group, rank)
                        send_frame(conn, b"PSA"
                                   + bytes([PROTOCOL_VERSION])
                                   + struct.pack("<I",
                                                 _CONTROL_RANK
                                                 if rank is None else rank)
                                   + (b"\x01" if self.token is not None
                                      else b"\x00")
                                   + struct.pack("<HHQ",
                                                 self._shard_index,
                                                 self._shard_count,
                                                 self._plan_digest)
                                   + _U32.pack(self._advertised_credits())
                                   + bytes([_WIRE_SEGMENTED])
                                   + self.code.name.encode())
                    elif not authed:
                        raise ValueError(
                            f"{kind!r} before authenticated HELO")
                    elif kind == b"BEAT":
                        if rank is not None:
                            self._mark_alive(rank)
                    elif kind == b"SPLN":
                        if rank is not None:
                            self._mark_alive(rank)
                        send_frame(conn, b"SPLN" + self._plan_json)
                    elif kind == b"REPL":
                        self._take_repl(conn, body)
                    elif kind == b"SNAP":
                        # Coordinated-snapshot marker: arm a checkpoint
                        # at exactly fill boundary ``cut`` (written by
                        # `_at_fill_boundary`).  A cut this shard has
                        # reached already is answered 0, so the
                        # supervisor proposes a later one.
                        (cut,) = _U64.unpack_from(body, 0)
                        with self._stats_lock:
                            armable = (not self._standby
                                       and self._snap_path is not None
                                       and cut > self._fill_next_step)
                            if armable:
                                self._snap_cuts.add(cut)
                        send_frame(conn, b"SNAP"
                                   + _U64.pack(cut if armable else 0))
                    elif kind == b"PROM":
                        # The promotion fence: only a standby of the same
                        # fleet (plan digest) is fenced; the reply is the
                        # replicated step.  Every later REPL is refused.
                        if not self._standby:
                            self._bump("quarantined_frames")
                            raise ValueError(
                                "PROM sent to a non-standby server")
                        (digest,) = _U64.unpack_from(body, 0)
                        if digest != self._plan_digest:
                            raise ValueError(
                                f"PROM plan digest {digest:#x} does not "
                                f"match this standby's "
                                f"{self._plan_digest:#x} — wrong fleet")
                        with self._repl_lock:
                            self._promoted = True
                            step = self._repl_step
                        send_frame(conn, b"PROM" + _U64.pack(
                            _NO_REPLICA if step is None else step))
                    elif kind == b"PULL":
                        if rank is not None:
                            self._mark_alive(rank)
                        if self._net_stop.is_set():
                            if self._dying:
                                return  # a crash: vanish, like kill -9
                            send_frame(conn, b"DONE")
                            return
                        have = None
                        if len(body) >= _U64.size:
                            (have,) = _U64.unpack_from(body, 0)
                        version_now = self._served_version
                        if have is not None and have == version_now:
                            send_frame(conn, b"PARM"
                                       + _U64.pack(version_now)
                                       + _U32.pack(
                                           self._advertised_credits())
                                       + _U8.pack(self._wire_codec_id))
                            self._bump("parm_unchanged")
                            continue
                        version, meta_blob, segs = self._parm_payload()
                        head = (b"PARM" + _U64.pack(version)
                                + _U32.pack(self._advertised_credits())
                                + _U8.pack(self._wire_codec_id))
                        _transport.send_frame_segments(
                            conn, [head, meta_blob, *segs],
                            cached=(segs.wire_crc, segs.wire_len))
                        self._bump("segments_sent", len(segs) + 2)
                    elif kind == b"SUBS":
                        if self._standby:
                            self._bump("quarantined_frames")
                            raise ValueError(
                                "SUBS sent to a standby server — "
                                "standbys hold replicated blobs, not a "
                                "served snapshot; subscribe to the "
                                "primary")
                        if not self._serve_subs(conn, body):
                            return
                    elif kind == b"GRAD":
                        if rank is not None:
                            self._mark_alive(rank)
                        try:
                            bucket, n_buckets = _BKT.unpack_from(body, 0)
                            seq = _U64.unpack_from(body, _BKT.size)[0]
                            version = _U64.unpack_from(
                                body, _BKT.size + _U64.size)[0]
                            loss = _F64.unpack_from(
                                body, _BKT.size + 2 * _U64.size)[0]
                            if n_buckets < 1 or bucket >= n_buckets:
                                raise ValueError(
                                    f"bad bucket header "
                                    f"({bucket}/{n_buckets})")
                        except Exception:
                            self._bump("quarantined_frames")
                            raise
                        if self._shed_before_decode(rank, seq, version,
                                                    bucket, n_buckets):
                            continue
                        # The (seq, bucket) burns at receive time, in
                        # wire order: pipelined decodes may finish out of
                        # order, and a duplicate never pays a decode.
                        if rank is not None and not self._burn_seq(
                                rank, seq, bucket, n_buckets):
                            self._bump("duplicate_dropped")
                            continue
                        binfo = ((assembler, seq, bucket, n_buckets, None)
                                 if n_buckets > 1 else None)
                        self._dispatch_decode(
                            decodes,
                            body[_BKT.size + 2 * _U64.size + _F64.size:],
                            (version, rank, loss), rank, arena.frames,
                            binfo)
                    elif kind == b"AGGR":
                        # The hierarchy's forward: admitted as a GRAD is
                        # (validation, dedup, the fill loop), its item
                        # carrying the contributor multiplicity the root
                        # weights it by.
                        if rank is not None:
                            self._mark_alive(rank)
                        try:
                            group, n_contrib, gtarget = _GRP.unpack_from(
                                body, 0)
                            bucket, n_buckets = _BKT.unpack_from(
                                body, _GRP.size)
                            seq = _U64.unpack_from(
                                body, _GRP.size + _BKT.size)[0]
                            version = _U64.unpack_from(
                                body, _GRP.size + _BKT.size + _U64.size)[0]
                            loss = _F64.unpack_from(
                                body,
                                _GRP.size + _BKT.size + 2 * _U64.size)[0]
                            if n_buckets < 1 or bucket >= n_buckets:
                                raise ValueError(
                                    f"bad bucket header "
                                    f"({bucket}/{n_buckets})")
                        except Exception:
                            self._bump("quarantined_frames")
                            raise
                        if self._shed_before_decode(rank, seq, version,
                                                    bucket, n_buckets):
                            continue
                        # Header-first dedup, as GRAD.
                        if rank is not None and not self._burn_seq(
                                rank, seq, bucket, n_buckets):
                            self._bump("duplicate_dropped")
                            continue

                        def aggr_done(g=group, r=rank, nc=n_contrib):
                            if r is not None:
                                self._note_group_frame(g, r, nc)
                            self._bump("agg_frames")

                        binfo = None
                        if n_buckets > 1:
                            # Counted once the forward is assembled.
                            binfo = (assembler, seq, bucket, n_buckets,
                                     aggr_done)
                        else:
                            aggr_done()
                        self._dispatch_decode(
                            decodes,
                            body[_GRP.size + _BKT.size + 2 * _U64.size
                                 + _F64.size:],
                            (version, rank, loss,
                             float(max(int(n_contrib), 1))), rank,
                            arena.frames, binfo)
                    else:
                        self._bump("quarantined_frames")
                        raise ValueError(f"unknown message kind {kind!r}")
        except ConnectionError:
            pass  # normal worker departure
        except Exception as exc:
            with self._stats_lock:
                self._conn_drops += 1
                self._last_drop = exc
        finally:
            # Gradients already received (and seq-burned) reach the queue
            # even when the connection died right after delivering them.
            while decodes:
                try:
                    self._finish_decode(decodes)
                except Exception:
                    break
            if assembler:
                # Partial assemblies die with their connection: a worker
                # that redials computes a fresh gradient under a fresh
                # seq and never resends old frames.
                self._bump("bucket_partial_timeouts", len(assembler))
            if rank is not None:
                self._release_conn(rank)
            if is_sub:
                self._bump("subs_active", -1)

    def _take_repl(self, conn: socket.socket, body) -> None:
        """One REPL frame at a standby: stash the newest blob as bytes of
        its own (never a view of the receive ring) with its codec byte,
        and answer ACKR with the credit window (REPL is a data frame).
        The blob is a checkpoint in this package's format: a tree frame of
        another format (the JAX package's) is refused before it is
        stashed.  Refused too: REPL at a non-standby, and after the PROM
        fence (a zombie primary must not write into its successor's
        past).  Each refusal costs the connection and is counted."""
        (step,) = _U64.unpack_from(body, 0)
        (repl_codec,) = _U8.unpack_from(body, _U64.size)
        blob = body[_U64.size + _U8.size:]
        if self._standby:
            try:
                serializer.check_tree_frame(blob)
            except ValueError:
                self._bump("quarantined_frames")
                raise
        with self._repl_lock:
            fenced = self._promoted
            if not fenced and self._standby:
                self._repl_step = step
                self._repl_codec = repl_codec
                self._repl_blob = bytes(blob)
        if fenced:
            # Checked first: a promoted successor is no longer a standby,
            # but its zombie primary's stream is the fence refusal it is.
            self._bump("repl_refused")
            raise ValueError(
                "standby already promoted — replication stream fenced off")
        if not self._standby:
            self._bump("quarantined_frames")
            raise ValueError("REPL sent to a non-standby server")
        self._bump("repl_received")
        send_frame(conn, b"ACKR" + _U64.pack(step)
                   + _U32.pack(self._advertised_credits()))

    def _serve_subs(self, conn: socket.socket, body) -> bool:
        """Answer one SUBS: conditional like a PULL (``have`` at the
        served version answers head-only "unchanged"), but READ-class: a
        payload reply costs a read token and a spent budget sheds
        head-only.  A payload fans out the encode-once PARM cache, or
        under ``delta_parm`` the (have, version) diff.  Counters move
        before the reply is sent: a reader acts on a reply the moment it
        lands, and the server's counters must not lag it.  A finished run
        answers DONE (nothing, after a simulated crash) and returns False:
        the connection ends."""
        if self._net_stop.is_set():
            if not self._dying:
                send_frame(conn, b"DONE")
            return False
        have = _UNVERSIONED
        if len(body) >= _U64.size:
            (have,) = _U64.unpack_from(body, 0)
        version_now = self._served_version
        if have == version_now:
            self._bump("reads_served")
            send_frame(conn, b"DELT" + _U64.pack(version_now)
                       + _U32.pack(self._advertised_read_credits())
                       + bytes([_DELT_UNCHANGED])
                       + _U8.pack(self._wire_codec_id))
            return True
        if not self._take_read_token():
            # A zero window in the head closes the reader's sender gate.
            self._bump("read_shed")
            send_frame(conn, b"DELT" + _U64.pack(version_now)
                       + _U32.pack(0) + bytes([_DELT_SHED])
                       + _U8.pack(self._wire_codec_id))
            return True
        dpay = None
        if self._delta_parm and have != _UNVERSIONED:
            dpay = self._delta_payload(have)
        if dpay is not None:
            version, meta_blob, segs = dpay
            dflags = _DELT_DELTA
        else:
            version, meta_blob, segs = self._parm_payload()
            dflags = 0
        dhead = (b"DELT" + _U64.pack(version)
                 + _U32.pack(self._advertised_read_credits())
                 + bytes([dflags]) + _U8.pack(self._wire_codec_id))
        self._bump("reads_served")
        self._bump("delta_frames")
        self._bump("segments_sent", len(segs) + 2)
        _transport.send_frame_segments(
            conn, [dhead, meta_blob, *segs],
            cached=(segs.wire_crc, segs.wire_len))
        return True

    # -- checkpoint / resume --------------------------------------------------

    def load_state_dict(self, sd: dict) -> None:
        super().load_state_dict(sd)
        # Republish (remote PULLs read the serving snapshot), and drop the
        # encode-once cache: a restored version number may match with
        # other bytes.
        self._served = self._host_params()
        # The delta ring and its diffs describe pre-restore versions: a
        # diff across the restore would patch a reader onto bytes never
        # published, so every subscriber's next read is a full frame.
        with self._parm_lock:
            self._parm_cache = None
            self._delta_ring.clear()
            self._delta_cache.clear()

    def _resume_extra(self) -> dict:
        """What every durable copy of this server carries: the serving
        version (continuous staleness across a restart) and the rank
        allocation (no rank minted twice)."""
        with self._rank_lock:
            next_rank, workers_seen = self._next_rank, self._workers_seen
        return {"served_version": self._served_version,
                "next_rank": next_rank,
                "workers_seen": workers_seen}

    def _apply_resume_extra(self, extra: dict) -> None:
        self._served_version = int(extra.get("served_version") or 0)
        with self._rank_lock:
            self._next_rank = max(self._next_rank,
                                  int(extra.get("next_rank") or 0))
            self._workers_seen = max(self._workers_seen,
                                     int(extra.get("workers_seen") or 0))

    def resume_from(self, path) -> int:
        """Restore optimizer state and the serving version from an
        auto-checkpoint (``serve(checkpoint_every=...)``).  Returns the
        global step to continue from — pass it back as ``start_step``."""
        from .utils import checkpoint as _checkpoint

        info = _checkpoint.load_optimizer(path, self)
        self._apply_resume_extra(info.get("extra") or {})
        return int(info.get("step") or 0)

    def _auto_checkpoint(self, path, step: int) -> None:
        from .utils import checkpoint as _checkpoint

        _checkpoint.save_optimizer(path, self, step=step,
                                   extra=self._resume_extra())

    # -- hot-standby replication (the primary's side) -------------------------

    def _replicate(self, step: int) -> None:
        """Stream the post-update state to the standby as one REPL frame
        (a checkpoint of this server, store-framed, its arrays through the
        wire codec) and consume the ACKR, all under
        ``Deadline(op_deadline)``.
        Best-effort: a dead or fenced standby costs a growing ``repl_lag``
        and a redial at the next cadence, never the serve loop.  The
        stream rides a credit-gated session with one pending frame: a
        standby that stops acking stops granting credits, and the
        session is dropped (a parked REPL would never be acked)."""
        from .utils import checkpoint as _checkpoint

        wire_encode = None
        if self._wire_codec_id != 0:
            wire_encode = (lambda tree: _codecs.encode_wire_tree(
                self._wire_codec, tree))
        arrays, meta = _checkpoint.optimizer_payload(
            self, step=step, extra=self._resume_extra(),
            wire_encode=wire_encode)
        # Store-framed like every frame of this wire (`_WIRE_LEVEL`) and
        # sent as segments: the blob is never assembled on this side (the
        # arrays are this call's own copies of the state).
        meta_blob, segs = serializer.encode_segments(
            arrays, level=_WIRE_LEVEL, meta=meta)
        head = b"REPL" + _U64.pack(step) + _U8.pack(self._wire_codec_id)
        dl = Deadline(self.op_deadline)
        try:
            if self._repl_session is None:
                host, port = self.replica_addr
                sock = control_connect(host, port, token=self.token,
                                       timeout=5.0)
                self._repl_session = Session(
                    sock, io_timeout=5.0, max_pending=1,
                    stall_hook=lambda: self._bump("credits_stalled"),
                    shed_hook=lambda: self._bump("shed_data_frames"))
            sent = self._repl_session.send_data_segments(
                [head, meta_blob, *segs], deadline=dl,
                cached=(segs.wire_crc, segs.wire_len))
            if sent:
                reply = self._repl_session.recv(dl)
                if reply[:4] == b"ACKR":
                    (acked,) = _U64.unpack_from(reply, 4)
                    (credits,) = _U32.unpack_from(reply, 4 + _U64.size)
                    self._last_acked = max(self._last_acked, acked)
                    self._repl_session.replenish(credits)
                self._bump("repl_sent")
            else:
                self._repl_session.close()
                self._repl_session = None
        except TRANSPORT_ERRORS + (ValueError,):
            # A fenced standby drops the stream (this primary is a zombie
            # past a promotion); protocol refusals too.  None of them may
            # end the serve loop.
            if sys.exc_info()[0] is DeadlineExpired:
                self._bump("deadline_expired")
            if self._repl_session is not None:
                self._repl_session.close()
                self._repl_session = None
        with self._stats_lock:
            self.fault_stats["repl_lag"] = step - self._last_acked

    # -- hot-standby promotion (the standby's side, driven by the fleet) ------

    def replica_step(self) -> "int | None":
        """The newest replicated step this standby holds (None before the
        first REPL)."""
        with self._repl_lock:
            return self._repl_step

    def promote_from_replica(self) -> "int | None":
        """Apply the replicated blob to this standby and fence the
        replication stream.  Returns the step to serve on from, or None
        when nothing was replicated.  The blob's arrays rode the
        primary's wire codec: they are decoded back to f32 first, so the
        successor's optimizer state is plain tensors on its device, like
        any resumed server's.  The supervisor calls it after the wire
        PROM fence; the fence is latched here too."""
        with self._repl_lock:
            self._promoted = True
            step, blob = self._repl_step, self._repl_blob
            repl_codec = self._repl_codec
        if blob is None:
            return None
        from .utils import checkpoint as _checkpoint

        arrays, meta = _checkpoint.loads_tree(
            blob, with_meta=True, source="<replication stream>")
        arrays = _codecs.decode_wire_tree(repl_codec, arrays)
        info = _checkpoint.apply_optimizer(
            self, arrays, meta, source="<replication stream>")
        self._apply_resume_extra(info.get("extra") or {})
        # The successor is a primary now: it serves fills, arms SNAP cuts
        # and replicates onward; its zombie predecessor's late REPL stays
        # refused by the fence, which outlives the role.
        self._standby = False
        return int(info.get("step") or 0)

    def rebind(self, port: int) -> None:
        """Move the listener to ``port``, the takeover step of a
        promotion: reconnecting workers land on the successor without
        being re-pointed.  Call it with the accept loop stopped."""
        try:
            self._listener.close()
        except OSError:  # pragma: no cover - close best-effort
            pass
        self._listener = socket.create_server((self._host, port))
        self.address = self._listener.getsockname()[:2]

    def _start_accept_thread(self) -> threading.Thread:
        """The accept loop without serve(): a standby's frame surface
        (REPL and PROM are connection-thread work).  Promotion stops it
        and rebinds, and serve() starts a fresh one."""
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="async-ps-standby-accept")
        t.start()
        return t

    # -- coordinated snapshots (SNAP markers) ---------------------------------

    def applied_updates(self) -> int:
        """Updates applied so far (the current fill boundary): what the
        fleet supervisor reads to propose a cut every shard is short of."""
        with self._stats_lock:
            return self._fill_next_step

    def _at_fill_boundary(self) -> None:
        """At the boundary before the fill of update g, an armed cut g is
        the agreed fleet-wide cut "g updates applied": the step-tagged
        checkpoint is written now, before any gradient moves this shard
        past it."""
        with self._stats_lock:
            boundary = self._fill_next_step
            due = boundary in self._snap_cuts
            if due:
                self._snap_cuts.discard(boundary)
            path = self._snap_path
        if due and path is not None:
            from .utils import checkpoint as _checkpoint

            self._auto_checkpoint(_checkpoint.step_path(path, boundary),
                                  boundary)
            self._bump("snapshot_barriers")

    # -- the PS loop ----------------------------------------------------------

    def _stack(self, batch_codes):
        """A fill's host codes stacked on the host, on the PS's device in
        one copy."""
        return stack_to_device(batch_codes, self.ps_device)

    def serve(self, steps: int, log_every: int = 0,
              idle_timeout: float = 300.0, *,
              eviction_timeout: float = 30.0,
              dead_conn_grace: float = 2.0,
              checkpoint_path=None, checkpoint_every: int = 0,
              start_step: int = 0,
              warmup_steps: int = 0) -> "dict[str, Any]":
        """Serve until ``steps`` updates have been applied, then stop
        (every later PULL answers ``DONE``, shutting workers down).

        ``idle_timeout``: the longest wait between gradients — a dead (or
        never-started) fleet errors out instead of hanging.
        ``eviction_timeout`` / ``dead_conn_grace``: a rank past the
        timeout with no frame, or past the grace with no connection, is
        evicted and the quota clamps to the live fleet.
        ``checkpoint_every``/``checkpoint_path``: an atomic checkpoint
        every N updates — a killed PS restarts, calls `resume_from` and
        serves the rest while workers reconnect.  ``warmup_steps``:
        updates before the steady-state clock starts
        (``history["steady_wall_time"]``)."""
        if self._worker_fn is None:
            raise NotCompiledError(
                "call compile_step(loss_fn) before serve()")
        if checkpoint_every and not checkpoint_path:
            raise ValueError("checkpoint_every needs a checkpoint_path")
        if self._closed.is_set():
            raise FleetDeadError(
                "serve() called on a closed server — this PS was shut "
                "down permanently")
        self._net_stop.clear()
        accept = threading.Thread(target=self._accept_loop, daemon=True,
                                  name="async-ps-accept")
        accept.start()
        poll = min(0.5, max(idle_timeout / 4.0, 0.02))
        self._idle_timeout = idle_timeout
        # SNAP markers write their cuts as step-tagged siblings of the
        # auto-checkpoint path (no path: markers are answered 0).
        with self._stats_lock:
            self._snap_path = checkpoint_path
            self._fill_next_step = start_step
        idle = Deadline(idle_timeout)
        plan = self.fault_plan

        def receive(timeout):
            try:
                item = self._net_queue.get(timeout=timeout)
            except queue.Empty:
                if self._closed.is_set():
                    raise FleetDeadError(
                        "PS closed while serving — shutdown requested "
                        "before the run completed")
                self._evict_dead(eviction_timeout, dead_conn_grace)
                if idle.expired():
                    self._bump("deadline_expired")
                    with self._stats_lock:
                        conn_drops = self._conn_drops
                        last_drop = self._last_drop
                    with self._rank_lock:
                        workers_seen = self._workers_seen
                    detail = (f"; last dropped connection: {last_drop!r}"
                              if last_drop else "")
                    raise FleetDeadError(
                        f"no gradient received for {idle_timeout:.0f}s "
                        f"({workers_seen} workers ever connected, "
                        f"{conn_drops} connections dropped{detail}) — "
                        f"fleet dead or never started") from last_drop
                return None
            idle.restart()
            if plan is not None and plan.slow_consumer > 0:
                time.sleep(plan.slow_consumer)
                self._bump("slow_consumed")
            return item

        def drain_nowait():
            try:
                return self._net_queue.get_nowait()
            except queue.Empty:
                return None

        history: "dict[str, Any]" = {"losses": [], "staleness": [],
                                     "versions": [], "contributors": [],
                                     "grads_consumed": 0}
        t_start = time.perf_counter()
        t_steady = t_start
        self._serve_t0 = t_start
        try:
            for update in range(steps):
                if update == warmup_steps and warmup_steps > 0:
                    t_steady = time.perf_counter()
                gstep = start_step + update
                # The kill fires only if this serve() started before the
                # planned step: a relaunch with --resume lands at
                # start_step == kill_ps_at and must not die again.
                if (plan is not None and plan.should_kill_ps(gstep)
                        and (gstep > start_step or start_step == 0)):
                    from .utils.faults import SimulatedCrash
                    self._dying = True
                    raise SimulatedCrash(
                        f"FaultPlan: PS killed before update {gstep}")
                data: "dict[str, float]" = {}
                t0 = time.perf_counter()
                with self._stats_lock:
                    self._fill_next_step = gstep
                self._evict_dead(eviction_timeout, dead_conn_grace)
                idle.restart()
                (batch_codes, stalenesses, losses, ranks, contribs,
                 fill_target, _short) = self._fill_gradients(
                    receive, drain_nowait,
                    current_version=lambda: self._served_version,
                    base_timeout=poll)
                data["comm_wait"] = time.perf_counter() - t0

                t0 = time.perf_counter()
                with torch.no_grad():
                    stacked = self._stack(batch_codes)
                    self.params, self.state = self._apply_weighted(
                        stacked, stalenesses, ranks, data,
                        n_target=fill_target, contribs=contribs)
                data["optim_step_time"] = time.perf_counter() - t0

                t0 = time.perf_counter()
                # One copy to fresh host memory (it waits for the update
                # on the card), then the leaf-wise publish.
                self._publish()
                data["isend_time"] = time.perf_counter() - t0
                data["msg_bytes"] = float(bytes_of(batch_codes[0]))

                mean_loss = float(np.mean(losses))
                mean_stale = float(np.mean(stalenesses))
                history["losses"].append(mean_loss)
                history["staleness"].append(mean_stale)
                history["versions"].append(self._served_version)
                history["contributors"].append(list(ranks))
                history["grads_consumed"] += len(batch_codes)
                self.timings.append(data)
                if checkpoint_every and (gstep + 1) % checkpoint_every == 0:
                    self._auto_checkpoint(checkpoint_path, gstep + 1)
                if (self.replica_addr is not None
                        and (gstep + 1) % self.replica_every == 0):
                    # At the default cadence (1) the standby is never
                    # behind: a promotion rewinds no update.
                    self._replicate(gstep + 1)
                if log_every and (update + 1) % log_every == 0:
                    print(f"async update {update + 1:5d}  loss "
                          f"{mean_loss:.4f}  staleness {mean_stale:.2f}")
        finally:
            self._net_stop.set()
            self._listener.close()
            accept.join(timeout=5.0)
            if self._repl_session is not None:
                self._repl_session.close()
                self._repl_session = None
            with self._stats_lock:
                drops = dict(self.fault_stats["dropped_queue_full"])
            for r in sorted(drops):
                who = "unranked conn" if r == -1 else f"worker rank {r}"
                print(f"async PS warning: {who}: {drops[r]} gradient(s) "
                      f"dropped (net queue full at shutdown)",
                      file=sys.stderr)
        history["wall_time"] = time.perf_counter() - t_start
        history["steady_wall_time"] = time.perf_counter() - t_steady
        history["warmup_steps"] = warmup_steps
        history["fault_stats"] = self._fault_stats_snapshot()
        return history

    def close(self, join_timeout: float = 5.0):
        """Shut down for good: stop serving, close the listener and give
        the connection threads ``join_timeout`` seconds in all to finish
        (a thread left inside torch at interpreter exit aborts it)."""
        self._closed.set()
        self._net_stop.set()
        self._decode_pool.shutdown(wait=False)
        try:
            self._listener.close()
        except OSError as exc:  # pragma: no cover - close rarely fails
            self._bump("accept_errors")
            with self._stats_lock:
                self._last_drop = exc
        end = Deadline(join_timeout)
        for t in list(self._conn_threads):
            t.join(end.timeout())


class AsyncSGDServer(AsyncPSServer):
    def __init__(self, named_params, **kw):
        kw["optim"] = "sgd"
        super().__init__(named_params, **kw)


class AsyncAdamServer(AsyncPSServer):
    def __init__(self, named_params, **kw):
        kw["optim"] = "adam"
        super().__init__(named_params, **kw)


# ---------------------------------------------------------------------------
# The worker
# ---------------------------------------------------------------------------

class AsyncPSWorker:
    """A worker process: pull params, grad + encode on the local device,
    push coded gradients::

        w = AsyncPSWorker("ps-host", 5555, code="blockq")
        w.run(loss_fn, batch_fn)     # returns when the PS answers DONE

    ``batch_fn(rank, it)`` supplies this worker's ``it``-th local batch
    (numpy or tensors); the rank is assigned by the server at connect
    time.  ``device`` is the card unless the caller passes ``"cpu"``: a
    worker that finds no card raises (it does not fall back to the CPU).

    Transport faults heal instead of killing the worker: a lost
    connection reconnects with jittered exponential backoff, re-presenting
    this worker's rank; a PS that stays gone past ``reconnect_retries``
    attempts ends the run cleanly, as a DONE would.  ``fault_plan``
    injects deterministic chaos: planned death, NaN gradients, wire
    mangling of outbound GRAD frames, overload.

    The hierarchy's identities: ``agg_group`` presents this link as
    group g's aggregator (HELO flag 8, with the group fill target
    ``agg_target`` for the root's view; `shard.hierarchy.LocalAggregator`'s
    upstream links, which forward with `push_agg`); ``fallback_group``
    marks a worker re-admitting itself at the root after its aggregator
    died (flag 16).  ``max_pending``, ``stall_hook`` and ``pace_hook``
    reach the link's `transport.Session`.

    ``bucket_bytes`` streams each gradient as bucket frames (None: one
    whole-tree frame; 0: `parallel.overlap.auto_bucket_bytes`'s size): the
    plan is built at the first pull (`plan_overlap`), and the buckets go
    out last bucket first, each as soon as it is on the host
    (`push_buckets`).  ``fused_encode`` encodes each bucket inside
    backward (`parallel.overlap.make_async_bucket_step`); it needs a
    bucket plan.
    """

    def __init__(self, host: str, port: int,
                 code: "Codec | str | None" = None,
                 device=None,
                 token: "str | None" = None,
                 fault_plan=None,
                 io_timeout: float = 60.0,
                 reconnect_retries: int = 3,
                 backoff_base: float = 0.1,
                 backoff_max: float = 1.0,
                 heartbeat_interval: float = _HEARTBEAT_S,
                 assigned_rank: "int | None" = None,
                 expect_shard: "int | None" = None,
                 agg_group: "int | None" = None,
                 agg_target: int = 0,
                 fallback_group: "int | None" = None,
                 op_deadline: "float | None" = None,
                 credit_cap: "int | None" = None,
                 max_pending: int = 4,
                 stall_hook=None, pace_hook=None,
                 bucket_bytes: "int | None" = None,
                 fused_encode: bool = False):
        from .ops.codecs import get_codec

        if bucket_bytes is not None and bucket_bytes < 0:
            raise ValueError(
                f"bucket_bytes must be >= 0 (0 = auto) or None, got "
                f"{bucket_bytes}")
        if fused_encode and bucket_bytes is None:
            raise ValueError(
                "fused_encode fuses the PER-BUCKET encode into the grad "
                "program — it needs bucket streaming (set bucket_bytes; "
                "0 auto-tunes); without a plan the flag would be "
                "silently inert")
        self.bucket_bytes = bucket_bytes
        self.fused_encode = bool(fused_encode)
        self._bucket_plan = None
        self.code = get_codec(code)
        self.device = resolve_device("cuda" if device is None else device)
        self.token = token or None  # "" behaves exactly like unset
        self.host, self.port = host, port
        self.io_timeout = io_timeout
        self.reconnect_retries = reconnect_retries
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.heartbeat_interval = heartbeat_interval
        self.fault_plan = fault_plan
        self.reconnects = 0
        # Each pull round trip runs under ``Deadline(op_deadline)``; a
        # blown budget is counted and heals through the reconnect ladder.
        self.op_deadline = op_deadline
        self._credit_cap = credit_cap
        self._max_pending = max_pending
        self._stall_hook = stall_hook
        self._pace_hook = pace_hook
        # Worker-side counters; the session's stall/shed counts merge in
        # via `fault_snapshot` (the JAX worker's keys).
        self.fault_stats: "dict[str, int]" = {
            "deadline_expired": 0, "flood_injected": 0,
            "burst_injected": 0, "parm_unchanged": 0,
            # Bucket frames handed to the transport, and fused bucketed
            # grad + encode steps run.
            "buckets_sent": 0, "fused_encodes": 0}
        # The fleet identity (`shard.ShardRouter`'s links):
        # ``assigned_rank`` books shard 0's minted rank verbatim (HELO flag
        # 2); ``expect_shard`` pins the fleet slot this connection must
        # land on (a swapped endpoint is refused at connect time).  A plain
        # worker (both None) refuses a fleet shard: it would push
        # whole-tree gradients at a slice owner.
        self._assigned_rank = assigned_rank
        self._expect_shard = expect_shard
        self._agg_group = agg_group
        self._agg_target = int(agg_target)
        self._fallback_group = fallback_group
        self.shard_index = 0
        self.num_shards = 1
        self.plan_digest = 0
        # Monotone GRAD sequence id: survives reconnects, so the PS tells
        # a wire-duplicated frame from a fresh gradient.
        self._push_seq = 0
        self.rank: "int | None" = None
        self._session: "Session | None" = None
        self._wire_segmented = False
        # PARM replies land in a receive ring, decoded before the next
        # receive (nbufs=2).
        self._recv_arena = _transport.RecvArena(nbufs=2)
        # Conditional-pull cache: the last decoded (version, host params).
        self._parm_cache: "tuple[int, Any] | None" = None
        # The codec's element order per leaf, from the first pull's
        # shapes (`utils.interop.jax_order`).
        self._orders: "dict[str, tuple]" = {}
        # Gradients computed over every run: pushed, or lost to a
        # transport error (the kernels' launch counts are per computed
        # gradient).
        self.grads_computed = 0
        # The bucket stream's device-to-host copies (`_to_host_after`).
        self._d2h_stream = None
        # Test/diagnostic knob: after a push, pull until the served
        # version moves past the one the gradient was computed from — with
        # a quota-1 server, sequential SGD through the wire.  Never the
        # default: a barrier.
        self._lockstep = False
        self._connect(prior_rank=None)
        self._rng = np.random.default_rng(np.random.SeedSequence(
            [fault_plan.seed if fault_plan is not None else 0,
             self.rank, 0xB0FF]))
        self._mangler = (fault_plan.wire_mangler(self.rank)
                         if fault_plan is not None
                         and fault_plan.any_wire_faults() else None)

    # -- the session ----------------------------------------------------------

    @property
    def sock(self) -> "socket.socket | None":
        return self._session.sock if self._session is not None else None

    @property
    def link_down(self) -> bool:
        """The session's partition latch (a `FaultPlan` black hole:
        heartbeats stop, the socket stays)."""
        return (self._session.link_down
                if self._session is not None else False)

    @link_down.setter
    def link_down(self, value: bool) -> None:
        if self._session is not None:
            self._session.link_down = bool(value)

    def fault_snapshot(self) -> "dict[str, int]":
        """This worker's counters plus its session's stall/shed counts —
        one dict `utils.timing.format_fault_stats` renders."""
        snap = dict(self.fault_stats)
        if self._session is not None:
            for k, v in self._session.stats.items():
                snap[k] = snap.get(k, 0) + v
        return snap

    def _connect(self, prior_rank: "int | None") -> None:
        """Dial the PS and run the HELO handshake under one
        ``Deadline(io_timeout)``; the session adopts the new socket
        (credit/pending state and the heartbeat survive a redial).
        ``prior_rank`` marks a reconnect, so the PS re-books the rank."""
        dial = Deadline(self.io_timeout)
        sock = socket.create_connection((self.host, self.port),
                                        timeout=dial.timeout())
        try:
            sock.settimeout(dial.timeout())
            try:
                sock.setsockopt(socket.IPPROTO_TCP,
                                socket.TCP_NODELAY, 1)
            except OSError:  # pragma: no cover - non-TCP transports
                pass
            if prior_rank is not None:
                flags, extra = 1, struct.pack("<I", prior_rank)
            elif self._assigned_rank is not None:
                # The fleet-wide rank from shard 0, booked here too (not a
                # reconnect: the server does not count it as one).
                flags, extra = 2, struct.pack("<I", self._assigned_rank)
            else:
                flags, extra = 0, b""
            if self._agg_group is not None:
                # The aggregator identity composes with a prior or
                # assigned rank (a restarted aggregator re-claims its rank
                # and its group in one HELO).
                flags |= 8
                extra += struct.pack("<HH", self._agg_group,
                                     self._agg_target)
            if self._fallback_group is not None:
                flags |= 16
                extra += struct.pack("<H", self._fallback_group)
            send_frame(sock, b"HELO" + bytes([flags]) + extra
                       + (self.token.encode() if self.token else b""))
            reply = recv_frame(sock)
            if reply == b"NOAU":
                raise ValueError(
                    "server refused the admission token (launch the worker "
                    "with the server's --token)")
            if reply[:3] != b"PSA":
                raise ValueError(
                    "incompatible protocol: the server's HELO reply carries "
                    "no PSA magic — it speaks a pre-versioning (or foreign) "
                    "protocol; upgrade both peers to the same release")
            if reply[3] != PROTOCOL_VERSION:
                raise ValueError(
                    f"incompatible protocol version: server speaks "
                    f"{reply[3]}, this worker speaks {PROTOCOL_VERSION} — "
                    f"run matching releases on both ends")
            (rank,) = struct.unpack_from("<I", reply, 4)
            auth_enforced = reply[8:9] == b"\x01"
            if self.token and not auth_enforced:
                raise ValueError(
                    "this worker was given an admission token but the "
                    "server is not enforcing one — refusing to run against "
                    "an open PS port (launch the server with --token)")
            shard_index, num_shards, plan_digest = struct.unpack_from(
                "<HHQ", reply, 9)
            if self._expect_shard is None and num_shards > 1:
                raise ValueError(
                    f"this server is shard {shard_index} of a "
                    f"{num_shards}-shard PS fleet; a plain worker would "
                    f"push full-tree gradients at a slice owner — connect "
                    f"through shard.ShardRouter (CLI: --connect with all "
                    f"{num_shards} endpoints)")
            if (self._expect_shard is not None
                    and shard_index != self._expect_shard):
                raise ValueError(
                    f"endpoint order mismatch: expected fleet shard "
                    f"{self._expect_shard} at {self.host}:{self.port} but "
                    f"the server identifies as shard {shard_index} of "
                    f"{num_shards} — list --connect endpoints in shard "
                    f"order")
            self.shard_index, self.num_shards = shard_index, num_shards
            self.plan_digest = plan_digest
            (credits,) = _U32.unpack_from(reply, 21)
            self._wire_segmented = bool(reply[25] & _WIRE_SEGMENTED)
            server_codec = reply[26:].decode()
            if server_codec and server_codec != self.code.name:
                raise ValueError(
                    f"codec mismatch: the server decodes {server_codec!r} "
                    f"codes but this worker encodes {self.code.name!r} — "
                    f"launch the worker with the server's codec")
        except BaseException:
            sock.close()
            raise
        if self._session is None:
            self._session = Session(
                sock, io_timeout=self.io_timeout,
                heartbeat_interval=self.heartbeat_interval,
                max_pending=self._max_pending,
                credit_cap=self._credit_cap,
                stall_hook=self._stall_hook,
                pace_hook=self._pace_hook)
        else:
            self._session.adopt(sock)
        self.rank = rank
        # Versions are comparable only within one server lifetime: a
        # restored server may serve an earlier number with other bytes,
        # so the read cache does not survive the dial.
        self._parm_cache = None
        self._session.replenish(credits)

    def _reconnect(self) -> bool:
        """Jittered backoff redial, re-presenting our rank.  ValueError
        refusals propagate: a configuration error does not heal."""
        ladder = Backoff(base=self.backoff_base, maximum=self.backoff_max,
                         retries=self.reconnect_retries, rng=self._rng)
        for _attempt in ladder.sleeps():
            try:
                self._connect(prior_rank=self.rank)
            except TRANSPORT_ERRORS:
                continue
            self.reconnects += 1
            return True
        return False

    def _send(self, payload: bytes) -> None:
        self._session.send(payload)

    def _recv(self, deadline: "Deadline | None" = None, *, into=None):
        return self._session.recv(deadline, into=into)

    def _push_grad(self, payload: bytes) -> None:
        """A GRAD frame through the fault plan's wire mangler (which owns
        the raw framing, bypassing the credit gate)."""
        wire = frame_header(payload) + payload
        chunks, close_after = self._mangler(wire)
        self._session.raw_send(chunks)
        if close_after:
            try:
                self.sock.close()
            except OSError:  # pragma: no cover - close best-effort
                pass
            raise ConnectionResetError(
                "FaultPlan: frame truncated, connection killed")

    # -- protocol round trips -------------------------------------------------

    def pull(self, force: bool = False) -> "tuple[int, Any] | None":
        """One PULL round trip under the op `Deadline`: ``(version, host
        params)``, or None on DONE.  The PARM credit field replenishes the
        session's window.  The pull is conditional on the cached version:
        an unchanged server answers head-only (``parm_unchanged``) and the
        cached host tree is returned again (the same object).
        ``force=True`` pulls unconditionally."""
        dl = Deadline(self.op_deadline)
        have = (self._parm_cache[0]
                if self._parm_cache is not None and not force
                else _UNVERSIONED)
        self._send(b"PULL" + _U64.pack(have))
        try:
            reply = self._session.recv(dl, into=self._recv_arena)
        except DeadlineExpired:
            self.fault_stats["deadline_expired"] += 1
            raise
        kind = bytes(reply[:4])
        if kind == b"DONE":
            return None
        if kind == b"PARM":
            version = _U64.unpack_from(reply, 4)[0]
            credits = _U32.unpack_from(reply, 4 + _U64.size)[0]
            codec = _U8.unpack_from(reply, 4 + _U64.size + _U32.size)[0]
            self._session.replenish(credits)
            payload = reply[4 + _U64.size + _U32.size + _U8.size:]
            if len(payload) == 0:
                if (self._parm_cache is None
                        or self._parm_cache[0] != version):
                    raise ValueError(
                        "empty PARM payload for a version this worker "
                        "never decoded — protocol violation")
                self.fault_stats["parm_unchanged"] += 1
                return self._parm_cache
            params = _codecs.decode_wire_tree(
                codec, serializer.loads(payload))
            self._parm_cache = (version, params)
            return self._parm_cache
        raise ValueError(f"unexpected reply {kind!r}")

    def push(self, codes_host, version: int, loss: float) -> None:
        """Serialize one host code tree and hand it to the transport as a
        GRAD frame tagged with the params ``version`` it was computed
        from.  Under the credit gate "pushed" means gate-entered: at zero
        credits the frame parks and may be shed oldest-first (the
        session's ``credits_stalled``/``shed_data_frames``).  The seq is
        burned even if the send fails.  The caller keeps ``codes_host``:
        its leaves go out as zero-copy views inside this call, or are
        copied on park."""
        seq = self._push_seq
        self._push_seq += 1
        self._send_tree(b"GRAD" + _BKT.pack(0, 1) + _U64.pack(seq)
                        + _U64.pack(version) + _F64.pack(float(loss)),
                        codes_host)

    def push_agg(self, codes_host, version: int, loss: float, *,
                 group: int, n_contrib: int, target: int) -> None:
        """Forward one group-reduced code tree as an AGGR frame (the
        hierarchy's forward, `shard.hierarchy.LocalAggregator`):
        ``n_contrib`` is how many worker gradients it stands for, and the
        seq is burned as `push` burns it."""
        seq = self._push_seq
        self._push_seq += 1
        self._send_tree(b"AGGR" + _GRP.pack(int(group), int(n_contrib),
                                            int(target))
                        + _BKT.pack(0, 1) + _U64.pack(seq)
                        + _U64.pack(version) + _F64.pack(float(loss)),
                        codes_host)

    def _send_tree(self, head: bytes, codes_host) -> None:
        """One data frame ``head | tree``: segmented through the credit
        gate, or as one blob (a wire mangler armed, or a peer without the
        segmented wire)."""
        if self._mangler is None and self._wire_segmented:
            meta_blob, segs = serializer.encode_segments(
                codes_host, level=_WIRE_LEVEL)
            self._session.send_data_segments(
                [head, meta_blob, *segs],
                cached=(segs.wire_crc, segs.wire_len))
            return
        blob = serializer.dumps(codes_host, level=_WIRE_LEVEL)
        if self._mangler is None:
            self._send(head + blob)
        else:
            self._push_grad(head + blob)

    def push_buckets(self, buckets, n_buckets: int, version: int,
                     loss: float) -> None:
        """Stream one gradient as ``n_buckets`` GRAD frames sharing one
        seq.  ``buckets`` yields host code sub-trees, or lists of them: a
        list is a ready group, sent in one gather-send
        (`Session.send_data_parts`).  The run loop hands in
        `parallel.overlap.iter_ready_groups`, so a bucket whose encode
        still runs on the card waits while its predecessors are on the
        wire.

        Flow control charges one credit for the whole gradient: the first
        bucket consults the gate once (`Session.begin_data_parts`); a
        closed gate collects every bucket and parks the gradient as one
        entry, shed as a unit.  The caller keeps every buffer it hands in,
        as in `push`.  With a wire mangler armed, or a peer without the
        segmented wire, each bucket goes out as a frame of its own."""
        seq = self._push_seq
        self._push_seq += 1
        tail = _U64.pack(seq) + _U64.pack(version) + _F64.pack(float(loss))
        self._stream_buckets(
            lambda b: b"GRAD" + _BKT.pack(b, int(n_buckets)) + tail,
            buckets)

    def push_agg_buckets(self, buckets, n_buckets: int, version: int,
                         loss: float, *, group: int, n_contrib: int,
                         target: int) -> None:
        """`push_buckets` for the hierarchy's forward: the aggregator
        reduces per bucket and streams each reduced sub-tree as an
        AGGR-bucket frame, one credit for the whole forward, so the send
        of bucket b overlaps the reduce of bucket b+1."""
        seq = self._push_seq
        self._push_seq += 1
        grp = _GRP.pack(int(group), int(n_contrib), int(target))
        tail = _U64.pack(seq) + _U64.pack(version) + _F64.pack(float(loss))
        self._stream_buckets(
            lambda b: b"AGGR" + grp + _BKT.pack(b, int(n_buckets)) + tail,
            buckets)

    def _stream_buckets(self, head_of, buckets) -> None:
        """The bucket frames of one gradient, ``head_of(b) | sub-tree``,
        through the gate as `push_buckets` describes."""
        direct: "bool | None" = None
        parked: list = []
        b = 0
        for item in buckets:
            group = item if isinstance(item, (list, tuple)) else [item]
            batch: list = []
            for codes_host in group:
                head = head_of(b)
                b += 1
                self.fault_stats["buckets_sent"] += 1
                if self._mangler is not None or not self._wire_segmented:
                    blob = serializer.dumps(codes_host, level=_WIRE_LEVEL)
                    if self._mangler is None:
                        self._send(head + blob)
                    else:
                        self._push_grad(head + blob)
                    continue
                meta_blob, segs = serializer.encode_segments(
                    codes_host, level=_WIRE_LEVEL)
                batch.append((head, meta_blob, segs))
            if not batch:
                continue
            if direct is None:
                direct = self._session.begin_data_parts()
            if not direct:
                parked.extend([h, m, *sg] for h, m, sg in batch)
            elif len(batch) == 1:
                head, meta_blob, segs = batch[0]
                self._session.send_data_part(
                    [head, meta_blob, *segs],
                    cached=(segs.wire_crc, segs.wire_len))
            else:
                self._session.send_data_parts(
                    [([h, m, *sg], (sg.wire_crc, sg.wire_len))
                     for h, m, sg in batch])
        if parked:
            self._session.park_data_parts(parked)

    def close(self) -> None:
        if self._session is not None:
            self._session.close()

    # -- the worker loop ------------------------------------------------------

    def _codes_to_host(self, codes, loss) -> "tuple[Any, float]":
        """The code tree and the loss in fresh host memory, one copy
        (synchronized): the serializer's leaves."""
        host_codes, host_loss = tree_to_host((codes, loss))
        return (tree_map(_wire_leaf, host_codes),
                float(host_loss.to(torch.float64)))

    def _to_host_after(self, tree, event):
        """``tree`` in fresh host memory as the serializer's leaves, one
        copy once ``event`` has completed.  On the card the copy runs on a
        stream of its own that waits for ``event`` alone, so a finished
        bucket reaches the host while the rest of backward still runs."""
        if event is None:
            return tree_map(_wire_leaf, tree_to_host(tree))
        if self._d2h_stream is None:
            self._d2h_stream = torch.cuda.Stream(device=self.device)
        with torch.cuda.stream(self._d2h_stream):
            self._d2h_stream.wait_event(event)
            host = tree_to_host(tree)
        return tree_map(_wire_leaf, host)

    def run(self, loss_fn: Callable, batch_fn: Callable[[int, int], Any],
            max_iters: "int | None" = None) -> int:
        """Work until the PS says DONE (or ``max_iters``).  Returns the
        number of gradients pushed."""
        from .async_ps import make_worker_step
        from .parallel.overlap import make_async_bucket_step, plan_overlap
        from .utils.interop import jax_order

        plan = self.fault_plan
        # The Byzantine map runs on the raw gradients before encoding.
        transform = (plan.byzantine_transform(self.rank)
                     if plan is not None else None)
        fn = None
        pushed = 0
        it = 0
        # Device params for the conditional pull, keyed by the identity
        # of the pulled host tree: an unchanged pull returns the same
        # object; a fresh decode (or a re-served version number after a
        # reconnect) is a new one.
        dev_params = None
        dev_src = None
        unchanged_streak = 0
        last_version = None
        self._session.start_heartbeat()
        try:
            while max_iters is None or it < max_iters:
                if (plan is not None
                        and plan.should_kill_worker(self.rank, it)):
                    from .utils.faults import SimulatedCrash
                    raise SimulatedCrash(
                        f"FaultPlan: worker {self.rank} killed at "
                        f"iteration {it}")
                if plan is not None and plan.should_slow(self.rank):
                    time.sleep(plan.slow_delay_s)
                try:
                    pulled = self.pull()
                    while (self._lockstep and pulled is not None
                           and last_version is not None
                           and pulled[0] <= last_version):
                        time.sleep(0.001)
                        pulled = self.pull()
                except TRANSPORT_ERRORS:
                    # Server unreachable (restarting PS, network blip, a
                    # lost DONE): redial; a server that stays gone ends
                    # the run as a DONE would.
                    if self._reconnect():
                        continue
                    break
                if pulled is None:  # DONE
                    break
                version, params = pulled
                if fn is None:
                    if self.code.ordered:
                        self._orders = {
                            n: o for n, p in params.items()
                            if (o := jax_order(n, tuple(p.shape)))
                            is not None}
                    if self.bucket_bytes is None:
                        fn = make_worker_step(loss_fn, self.code, transform,
                                              orders=self._orders)
                    else:
                        # The plan needs the parameters' shapes, which
                        # come with the first pull.
                        self._bucket_plan = plan_overlap(
                            OrderedDict((n, _host_leaf(p))
                                        for n, p in params.items()),
                            self.bucket_bytes, record=False)
                        fn = make_async_bucket_step(
                            loss_fn, self.code, self._bucket_plan,
                            transform, fused=self.fused_encode,
                            orders=self._orders)
                if params is not dev_src:
                    dev_params = tree_to_device(params, self.device)
                    dev_src = params
                    unchanged_streak = 0
                else:
                    # Same-version pacing: several gradients are already
                    # in flight at this version — yield so the serve
                    # loop drains instead of deepening the backlog.
                    unchanged_streak += 1
                    over = unchanged_streak - _SAME_VERSION_PACE
                    if over >= 0:
                        time.sleep(min(
                            _SAME_VERSION_YIELD_S * (over + 1),
                            _SAME_VERSION_YIELD_MAX_S))
                batch = tree_map(
                    lambda x: torch.as_tensor(x).to(self.device,
                                                    non_blocking=True),
                    batch_fn(self.rank, it))
                if self._bucket_plan is not None:
                    if not self._push_bucket_stream(fn, dev_params, batch,
                                                    version, plan, it):
                        if self._reconnect():
                            continue  # this gradient is lost
                        break
                    last_version = version
                    pushed += 1
                    it += 1
                    continue
                loss, codes = fn(dev_params, batch)
                self.grads_computed += 1
                codes_host, loss_f = self._codes_to_host(codes, loss)
                if (plan is not None
                        and plan.inject_nonfinite(self.rank, it)):
                    from .utils.faults import poison_nonfinite
                    codes_host = poison_nonfinite(codes_host)
                try:
                    self.push(codes_host, version, loss_f)
                except TRANSPORT_ERRORS:
                    if self._reconnect():
                        continue  # this gradient is lost; pull afresh
                    break
                self._inject_overload(plan, it, codes_host, version, loss_f)
                last_version = version
                pushed += 1
                it += 1
        finally:
            self.close()
        return pushed

    def _push_bucket_stream(self, fn, dev_params, batch, version: int,
                            plan, it: int) -> bool:
        """One bucket-streamed gradient: compute it, then stream its
        buckets last bucket first (backward makes the output layers'
        gradients first; the server assembles by name, so the order is
        free), each as soon as it is on the host, a run of finished
        buckets in one gather-send (`iter_ready_groups`).  False when the
        transport failed (the gradient is lost)."""
        from .parallel.overlap import iter_ready_groups

        loss, bucket_codes = fn(dev_params, batch)
        self.grads_computed += 1
        if self.fused_encode:
            self.fault_stats["fused_encodes"] += 1
        # The loss was computed before any bucket: the first bucket's
        # event covers it.
        (loss_host,) = self._to_host_after((loss,), bucket_codes[-1].event)
        loss_f = float(loss_host)
        poison = plan is not None and plan.inject_nonfinite(self.rank, it)
        host_parts: list = []

        def to_host(sub):
            host = self._to_host_after(sub, sub.event)
            if poison and not host_parts:
                from .utils.faults import poison_nonfinite
                host = poison_nonfinite(host)
            host_parts.append(host)
            return host

        try:
            self.push_buckets(
                iter_ready_groups(reversed(bucket_codes), to_host),
                self._bucket_plan.n_buckets, version, loss_f)
        except TRANSPORT_ERRORS:
            return False
        self._inject_overload_buckets(plan, it, host_parts, version, loss_f)
        return True

    def _inject_overload(self, plan, it: int, codes_host, version: int,
                         loss: float) -> None:
        """Overload injectors (flood_rank / burst_at): extra copies of this
        gradient under fresh seqs; send failures are swallowed."""
        if plan is None:
            return
        flood, burst = plan.overload_extras(self.rank, it)
        for i in range(flood + burst):
            try:
                self.push(codes_host, version, loss)
            except TRANSPORT_ERRORS:
                return
            self.fault_stats["flood_injected" if i < flood
                             else "burst_injected"] += 1

    def _inject_overload_buckets(self, plan, it: int, host_parts,
                                 version: int, loss: float) -> None:
        """`_inject_overload` for the bucket stream: each extra copy
        re-streams the buckets already on the host, as one ready group,
        under a fresh seq."""
        if plan is None:
            return
        flood, burst = plan.overload_extras(self.rank, it)
        for i in range(flood + burst):
            try:
                self.push_buckets(iter([list(host_parts)]),
                                  len(host_parts), version, loss)
            except TRANSPORT_ERRORS:
                return
            self.fault_stats["flood_injected" if i < flood
                             else "burst_injected"] += 1
