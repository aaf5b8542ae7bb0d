"""The serve tier on a single PS (`serve.subscribe`, the server's SUBS/DELT
read path, `ops.codecs`' delta framing) against the JAX package's, on the
CPU.

* `diff_wire_delta`/`apply_wire_delta` are bitwise the JAX package's on
  identity, bf16 and int8 decoded trees and on bfloat16 host leaves (a
  CPU tensor here, an ``ml_dtypes`` array there): the same uint32
  indices, values, byte counts and ``__psd_full`` fallback.
* Raw-socket conversations: the same HELO flag 32 and SUBS frames to a
  JAX server and a port server built from the same MLP params get DELT
  heads byte for byte equal (unchanged, shed, full and delta replies),
  and payloads equal after each package's own ``loads``.
* The subscriber cases of the JAX package's `tests/test_serve.py` and
  `tests/test_codec_wire.py` against the port server and the port
  `Subscriber`; its tree at each version is bitwise the server's
  post-decode tree, and the JAX `Subscriber`'s on the same sequence.
* The CLI's serve-tier refusals equal the JAX CLI's; one CLI run of a
  server, a worker and an inference reader in processes of their own.

Every spawned process has a timeout of at most 90 s, its stderr goes to a
file, every thread is joined with a timeout, and no test waits on a
reconnect ladder.
"""

import os
import socket
import struct
import sys
import threading
import time
from collections import OrderedDict

import ml_dtypes
import numpy as np
import pytest
import torch
from procs import first_line, reap, spawn

import pytorch_ps_mpi_tpu.multihost_async as jma
import pytorch_ps_mpi_tpu.transport as jtransport
import pytorch_ps_mpi_tpu_torch.multihost_async as tma
import pytorch_ps_mpi_tpu_torch.transport as ttransport
from pytorch_ps_mpi_tpu import train as jtrain
from pytorch_ps_mpi_tpu.models import mlp_loss_fn as jmlp_loss
from pytorch_ps_mpi_tpu.native import serializer as jser
from pytorch_ps_mpi_tpu.ops import codecs as jcodecs
from pytorch_ps_mpi_tpu.serve import Subscriber as JSubscriber
from pytorch_ps_mpi_tpu.utils.timing import \
    format_fault_stats as jformat_fault_stats
from pytorch_ps_mpi_tpu_torch import train as ttrain
from pytorch_ps_mpi_tpu_torch.async_ps import AsyncPS, dataset_batch_fn
from pytorch_ps_mpi_tpu_torch.errors import (FleetDeadError,
                                             SnapshotRewindError)
from pytorch_ps_mpi_tpu_torch.models import init_mlp, mlp_loss_fn
from pytorch_ps_mpi_tpu_torch.native import serializer as tser
from pytorch_ps_mpi_tpu_torch.ops import codecs as tcodecs
from pytorch_ps_mpi_tpu_torch.serve import FleetSubscriber, Subscriber
from pytorch_ps_mpi_tpu_torch.utils.faults import FaultPlan
from pytorch_ps_mpi_tpu_torch.transport import (Deadline, frame_header,
                                                recv_exact)
from pytorch_ps_mpi_tpu_torch.utils.timing import format_fault_stats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (16, 32, 4)
TIMEOUT = 60  # every serve() and join in this file
CPU = ["--force-cpu-devices", "1"]
ENV = {**os.environ, "OMP_NUM_THREADS": "2"}
CODECS = ["identity", "bf16", "int8"]
# The serve-tier counters `format_fault_stats` renders.
SERVE_COUNTERS = ("reads_served", "read_shed", "delta_frames", "subs_active",
                  "reads_stalled", "version_rewinds", "infer_requests",
                  "infer_shed", "param_swaps", "delta_hits", "delta_misses")
_U64 = struct.Struct("<Q")
_HEAD = 4 + 8 + 4 + 1 + 1  # DELT | version | credits | flags | codec


def _params():
    return init_mlp(np.random.RandomState(0), SIZES)


def _teacher(seed=7):
    rng = np.random.RandomState(seed)
    x = rng.randn(256, SIZES[0]).astype(np.float32)
    w = rng.randn(SIZES[0], SIZES[-1]).astype(np.float32)
    return x, (x @ w).argmax(1).astype(np.int64)


def _port_server(quota=1, **kw):
    srv = tma.AsyncSGDServer(list(_params().items()), lr=0.05, momentum=0.5,
                             quota=quota, device="cpu", **kw)
    srv.compile_step(mlp_loss_fn)
    return srv


def _jax_server(quota=1, **kw):
    srv = jma.AsyncSGDServer(list(_params().items()), lr=0.05, momentum=0.5,
                             quota=quota, **kw)
    srv.compile_step(jmlp_loss)
    return srv


def _accepting(srv):
    """Run only the accept loop (connections served, no fills)."""
    t = threading.Thread(target=srv._accept_loop, daemon=True)
    t.start()
    return srv


def _serving(srv, steps):
    box = {}

    def run():
        try:
            box["hist"] = srv.serve(steps=steps, idle_timeout=TIMEOUT)
        except BaseException as exc:  # noqa: BLE001 - surfaced by the test
            box["error"] = exc

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


def _worker_thread(port):
    x, y = _teacher()
    box = {}

    def run():
        try:
            w = tma.AsyncPSWorker("127.0.0.1", port, device="cpu",
                                  reconnect_retries=2)
            box["pushed"] = w.run(mlp_loss_fn, dataset_batch_fn(x, y, 32))
        except BaseException as exc:  # noqa: BLE001 - surfaced by the test
            box["error"] = exc

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


def _join(t, what):
    t.join(TIMEOUT)
    assert not t.is_alive(), f"{what} did not end"


def _wait(pred, timeout=10.0, what="condition"):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def _publish(srv, n_changed=8, frac=0.25):
    """Advance the served snapshot by hand (the serve loop's
    rebind-never-mutate contract), moving the ``n_changed``
    smallest-magnitude entries of the first leaf by ``frac`` of its
    largest magnitude: a delta-shaped update that leaves the int8 wire's
    block scales alone."""
    served = {n: np.array(p, copy=True) for n, p in srv._served.items()}
    flat = served[next(iter(served))].reshape(-1)
    idx = np.argsort(np.abs(flat), kind="stable")[:n_changed]
    flat[idx] += np.float32(frac) * np.abs(flat).max()
    srv._served = served
    srv._served_version += 1


def _post_decode(codecs, codec, served):
    return codecs.decode_wire_tree(codec,
                                   codecs.encode_wire_tree(codec, served))


def _bits(a):
    a = a.view(torch.int16).numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint8)


def _assert_tree_bitwise(got, want):
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_array_equal(_bits(got[n]), _bits(want[n]),
                                      err_msg=n)


# ---------------------------------------------------------------------------
# The constants and the READ class: the JAX module's
# ---------------------------------------------------------------------------

def test_delt_constants_equal_jax():
    for name in ("_DELT_UNCHANGED", "_DELT_SHED", "_DELT_DELTA",
                 "_DELTA_RING", "_READ_REFILL_S", "_UNVERSIONED",
                 "PROTOCOL_VERSION"):
        assert getattr(tma, name) == getattr(jma, name), name
    assert (tma._DELT_UNCHANGED, tma._DELT_SHED, tma._DELT_DELTA) == (1, 2, 4)
    assert ttransport.READ_FRAME_KINDS == jtransport.READ_FRAME_KINDS \
        == frozenset((b"SUBS",))
    assert not ttransport.READ_FRAME_KINDS & ttransport.DATA_FRAME_KINDS
    # Every frame and HELO flag of the protocol is answered now: the
    # refusal tables went with the hierarchy's slice, whose AGGR prefix
    # is the JAX module's.
    assert not hasattr(tma, "_REFUSED_FRAMES")
    assert not hasattr(tma, "_REFUSED_HELO_FLAGS")
    assert tma._GRP.format == jma._GRP.format == "<HHH"


def _gate_separate(mod, a, b):
    s = mod.Session(a)
    s.replenish(0)
    out = [s.send(b"SUBS" + b"\x00" * 8), mod.recv_frame(b)[:4]]
    s.replenish_read(0)
    out += [s.send(b"GRAD" + b"x")]
    s.replenish(1)
    out += [s.send(b"BEAT"), mod.recv_frame(b), mod.recv_frame(b),
            s.send_read(b"SUBS2345"), s.stats["reads_stalled"]]
    return out


def _gate_parks_then_sheds(mod, a, b):
    s = mod.Session(a, max_pending=2)
    s.replenish_read(0)
    frames = [b"SUBS" + bytes([i]) * 4 for i in range(3)]
    out = [s.send_read(f) for f in frames]
    out += [s.read_pending_count(), s.stats["read_shed"],
            s.stats["reads_stalled"]]
    s.replenish_read(8)
    out += [s.read_pending_count(), mod.recv_frame(b), mod.recv_frame(b)]
    return out


def _gate_sheds_now(mod, a, b):
    s = mod.Session(a)
    s.replenish_read(0)
    return [s.send_read(b"SUBSxxxx", deadline=mod.Deadline(0.0)),
            s.read_pending_count(), s.stats["read_shed"]]


def _gate_valve(mod, a, b):
    s = mod.Session(a)
    s.replenish_read(0)
    out = [s.send_read(b"SUBSxxxx", deadline=mod.Deadline(0.0))]
    s.open_read()
    out += [s.send_read(b"SUBSxxxx"),
            s.send_read(b"SUBSyyyy", deadline=mod.Deadline(0.0)),
            mod.recv_frame(b)]
    s.reset_read()
    out += [s.read_credits()]
    return out


@pytest.mark.parametrize("script", [
    _gate_separate, _gate_parks_then_sheds, _gate_sheds_now, _gate_valve],
    ids=["separate-budget", "parks-then-sheds", "sheds-now", "valve"])
def test_read_gate_behaves_as_jax(script):
    """The port's transport is the JAX module's: the READ gate's budget,
    oldest-first shed, shed-now and `open_read` valve give the same
    transcript on both Sessions."""
    transcripts = []
    for mod in (jtransport, ttransport):
        a, b = socket.socketpair()
        try:
            transcripts.append(script(mod, a, b))
        finally:
            a.close()
            b.close()
    assert transcripts[1] == transcripts[0]


# ---------------------------------------------------------------------------
# Delta framing: bitwise the JAX package's
# ---------------------------------------------------------------------------

def _delta_trees(seed=0):
    """A base and a current tree with ~10% of one leaf changed, a
    ``+0.0 -> -0.0`` pair, a NaN in both, a NaN that appears, and an
    unchanged leaf."""
    rng = np.random.RandomState(seed)
    base = OrderedDict(
        w=(rng.randn(96, 64) * 3.0).astype(np.float32),
        b=rng.randn(64).astype(np.float32),
        same=rng.randn(5, 7).astype(np.float32),
        step=np.asarray(7, np.int64))
    base["w"].ravel()[:3] = [0.0, np.nan, 1.0]
    cur = OrderedDict((k, np.array(v, copy=True)) for k, v in base.items())
    idx = rng.choice(cur["w"].size, cur["w"].size // 10, replace=False)
    cur["w"].ravel()[idx] += np.float32(1.0)
    cur["w"].ravel()[0] = -0.0  # +0.0 -> -0.0: unchanged by value
    cur["w"].ravel()[2] = np.nan  # appears
    cur["b"][:4] += np.float32(0.5)
    return base, cur


def _delta_equal(td, jd):
    assert set(td) == set(jd)
    for n in jd:
        assert set(td[n]) == set(jd[n]), n
        for k in jd[n]:
            np.testing.assert_array_equal(_bits(td[n][k]), _bits(jd[n][k]),
                                          err_msg=f"{n}/{k}")
            if k == "__psd_i":
                assert np.asarray(td[n][k]).dtype == np.uint32


@pytest.mark.parametrize("codec", CODECS)
def test_wire_delta_bitwise_to_jax(codec):
    base, cur = _delta_trees()
    tb, tc = (_post_decode(tcodecs, codec, t) for t in (base, cur))
    jb, jc = (_post_decode(jcodecs, codec, t) for t in (base, cur))
    _assert_tree_bitwise(tb, jb)
    _assert_tree_bitwise(tc, jc)
    tdelta, tbytes = tcodecs.diff_wire_delta(tb, tc)
    jdelta, jbytes = jcodecs.diff_wire_delta(jb, jc)
    assert tbytes == jbytes
    _delta_equal(tdelta, jdelta)
    tpatched = tcodecs.apply_wire_delta(tb, tdelta)
    _assert_tree_bitwise(tpatched, jcodecs.apply_wire_delta(jb, jdelta))
    assert tdelta["same"]["__psd_i"].size == 0
    assert tpatched["same"] is tb["same"]  # unchanged leaves alias
    for n in ("b", "same", "step"):
        np.testing.assert_array_equal(_bits(tpatched[n]), _bits(tc[n]))
    pw, cw = tpatched["w"].ravel(), tc["w"].ravel()
    if codec == "int8":
        # The int8 wire decodes -0.0 as +0.0 and a block holding a NaN at
        # scale 1.0: the patch is the full decode, bit for bit.
        np.testing.assert_array_equal(_bits(pw), _bits(cw))
        return
    # The values compare as numpy does: +0.0 == -0.0 is no change, and a
    # NaN always is one ...
    w_idx = set(tdelta["w"]["__psd_i"].tolist())
    assert 0 not in w_idx and {1, 2} <= w_idx
    # ... so the patch keeps the base's +0.0 where the full decode has
    # -0.0 (a reference caveat, the JAX package's too); every other bit
    # is the full decode's.
    assert np.signbit(cw[0]) and not np.signbit(pw[0])
    np.testing.assert_array_equal(_bits(pw[1:]), _bits(cw[1:]))


def test_wire_delta_full_fallback_on_shape_or_dtype_change():
    base, _ = _delta_trees()
    for cur in ({**base, "w": np.zeros((3, 3), np.float32)},
                {**base, "b": base["b"].astype(np.float16)},
                {**base, "new": np.ones(4, np.float32)}):
        tdelta, tbytes = tcodecs.diff_wire_delta(base, cur)
        jdelta, jbytes = jcodecs.diff_wire_delta(base, cur)
        assert tbytes == jbytes
        _delta_equal(tdelta, jdelta)
        _assert_tree_bitwise(tcodecs.apply_wire_delta(base, tdelta),
                             jcodecs.apply_wire_delta(base, jdelta))


def test_wire_delta_on_bf16_host_leaves_matches_jax():
    """A bfloat16 leaf is a CPU tensor in the port's host trees and an
    ``ml_dtypes`` array in the JAX package's: the same indices, values,
    bytes and patch (the port's delta through its serializer); a leaf
    that changes between bf16 and f32 ships whole."""
    base, cur = _delta_trees(seed=3)
    jb = {n: base[n].astype(ml_dtypes.bfloat16) for n in ("w", "b")}
    jc = {n: cur[n].astype(ml_dtypes.bfloat16) for n in ("w", "b")}
    tb = {n: torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
          for n, a in jb.items()}
    tc = {n: torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
          for n, a in jc.items()}
    tdelta, tbytes = tcodecs.diff_wire_delta(tb, tc)
    jdelta, jbytes = jcodecs.diff_wire_delta(jb, jc)
    assert tbytes == jbytes
    assert tdelta["w"]["__psd_v"].dtype == torch.bfloat16
    _delta_equal(tdelta, jdelta)
    tdelta = tser.loads(tser.dumps(tdelta))
    patched = tcodecs.apply_wire_delta(tb, tdelta)
    want = jcodecs.apply_wire_delta(jb, jdelta)
    _assert_tree_bitwise(patched, want)
    assert patched["w"] is not tb["w"]
    # The base is never written: a patch lands in fresh memory.
    np.testing.assert_array_equal(_bits(tb["w"]), _bits(jb["w"]))
    mixed, _ = tcodecs.diff_wire_delta(tb, {**tc, "w": cur["w"]})
    assert "__psd_full" in mixed["w"]


def test_apply_wire_delta_never_writes_the_base():
    base, cur = _delta_trees()
    keep = {n: np.array(a, copy=True) for n, a in base.items()}
    delta, _ = tcodecs.diff_wire_delta(base, cur)
    patched = tcodecs.apply_wire_delta(base, delta)
    for n in keep:
        np.testing.assert_array_equal(_bits(base[n]), _bits(keep[n]))
    assert not np.shares_memory(patched["w"], base["w"])


# ---------------------------------------------------------------------------
# The raw-socket conversation, both servers
# ---------------------------------------------------------------------------

class Raw:
    def __init__(self, port):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=10)

    def send(self, payload: bytes):
        self.sock.sendall(frame_header(payload) + payload)

    def recv_raw(self) -> bytes:
        head = recv_exact(self.sock, 8)
        n = struct.unpack("<II", head)[0]
        return head + recv_exact(self.sock, n)

    def close(self):
        self.sock.close()


def _subs(have):
    return b"SUBS" + _U64.pack(have)


@pytest.mark.parametrize("codec", CODECS)
def test_delt_replies_equal_jax(codec, monkeypatch):
    """A reader's conversation with both servers: HELO flag 32, a full
    snapshot (flags 0), an unchanged poll (1, head only), a delta after a
    publish (4), and a shed once the one read token is spent (2, head
    only).  Heads are byte for byte equal (whole frames where head-only);
    payloads equal after each package's own ``loads``."""
    for mod in (jma, tma):
        monkeypatch.setattr(mod, "_READ_REFILL_S", 60.0)
    replies = {}
    for name, make in (("jax", _jax_server), ("torch", _port_server)):
        srv = _accepting(make(wire_codec=codec, delta_parm=True,
                              read_window=1))
        try:
            c = Raw(srv.address[1])
            c.send(b"HELO" + bytes([32]))
            got = [c.recv_raw()]
            for step in range(4):
                if step == 2:
                    _publish(srv)
                    with srv._read_lock:  # the delta's token
                        srv._read_tokens = 1
                c.send(_subs((jma._UNVERSIONED, 0, 0,
                              jma._UNVERSIONED)[step]))
                got.append(c.recv_raw())
            _wait(lambda: srv.fault_stats["subs_active"] == 1,
                  what="subs_active")
            fs = {k: srv.fault_stats[k] for k in (
                "reads_served", "read_shed", "delta_frames", "subs_active",
                "delta_hits", "delta_misses", "parm_encodes")}
            c.close()
            _wait(lambda: srv.fault_stats["subs_active"] == 0,
                  what="subs_active back to 0")
            replies[name] = (got, fs, srv._workers_seen)
        finally:
            srv.close()
    (jgot, jfs, jseen), (tgot, tfs, tseen) = replies["jax"], replies["torch"]
    assert tfs == jfs and tseen == jseen == 0
    assert tfs["reads_served"] == 3 and tfs["delta_hits"] == 1
    assert tgot[0] == jgot[0]  # PSA
    flags = [r[8 + 16] for r in tgot[1:]]
    assert flags == [0, tma._DELT_UNCHANGED, tma._DELT_DELTA, tma._DELT_SHED]
    for i, (t, j) in enumerate(zip(tgot[1:], jgot[1:])):
        assert t[8:8 + _HEAD] == j[8:8 + _HEAD], i
        assert t[8 + 17] == tcodecs.wire_codec_id(codec)
        if flags[i] in (tma._DELT_UNCHANGED, tma._DELT_SHED):
            assert t == j and len(t) == 8 + _HEAD
    tfull = tcodecs.decode_wire_tree(codec, tser.loads(tgot[1][8 + _HEAD:]))
    jfull = jcodecs.decode_wire_tree(codec, jser.loads(jgot[1][8 + _HEAD:]))
    _assert_tree_bitwise(tfull, jfull)
    _delta_equal(tser.loads(tgot[3][8 + _HEAD:]),
                 jser.loads(jgot[3][8 + _HEAD:]))


def test_a_finished_server_answers_subs_with_done():
    replies = []
    for make in (_jax_server, _port_server):
        srv = _accepting(make())
        try:
            c = Raw(srv.address[1])
            c.send(b"HELO" + bytes([32]))
            c.recv_raw()
            srv._net_stop.set()  # the run finished
            c.send(_subs(0))
            replies.append(c.recv_raw())
            c.close()
        finally:
            srv.close()
    assert replies[1] == replies[0] and replies[1][8:] == b"DONE"


# ---------------------------------------------------------------------------
# The subscriber against the port server (the JAX package's cases)
# ---------------------------------------------------------------------------

def test_subscriber_full_snapshot_then_deltas_then_done():
    srv = _port_server(quota=1)
    try:
        t, out = _serving(srv, steps=8)
        sub = Subscriber("127.0.0.1", srv.address[1])
        v0, params0 = sub.snapshot()
        assert v0 == 0 and set(params0) == set(srv.params)
        wt, wbox = _worker_thread(srv.address[1])
        seen = [v0]
        for _ in range(1200):
            version, params, changed = sub.poll()
            if changed:
                seen.append(version)
            if sub.done:
                break
            time.sleep(0.005)
        _join(t, "serve")
        _join(wt, "worker")
        assert "error" not in out and "error" not in wbox
        assert sub.done
        assert seen == sorted(seen)
        assert sub.fault_stats["version_rewinds"] == 0
        assert sub.fault_stats["delta_frames"] >= 2
        assert (sub.fault_stats["reads_served"]
                > sub.fault_stats["delta_frames"])
        fs = out["hist"]["fault_stats"]
        assert fs["reads_served"] > 0 and fs["delta_frames"] >= 2
        assert fs["subs_active"] in (0, 1)
        # A reader is rank-less: it is no worker and books no rank.
        assert fs["workers_seen"] == 1 and fs["live_ranks"] == [0]
        sub.close()
        _wait(lambda: srv.fault_stats["subs_active"] == 0,
              what="subs_active back to 0")
    finally:
        srv.close()


def test_unchanged_short_circuit_costs_no_encode():
    srv = _accepting(_port_server(quota=1))
    try:
        sub = Subscriber("127.0.0.1", srv.address[1])
        v, params = sub.snapshot()
        encodes_after_first = srv.fault_stats["parm_encodes"]
        for _ in range(5):
            version, again, changed = sub.poll()
            assert not changed and version == v and again is params
        assert srv.fault_stats["parm_encodes"] == encodes_after_first
        assert sub.fault_stats["reads_served"] >= 6
        assert sub.fault_stats["delta_frames"] == 1
        sub.close()
    finally:
        srv.close()


def test_sender_side_read_gate_closes_on_zeroed_window(monkeypatch):
    """read_window=1: the first full read spends the token and its reply
    advertises 0, so the sender's gate closes and the next forced poll
    sheds locally; past the backoff the `open_read` valve probes."""
    monkeypatch.setattr(tma, "_READ_REFILL_S", 60.0)
    srv = _accepting(_port_server(quota=1, read_window=1))
    try:
        sub = Subscriber("127.0.0.1", srv.address[1], read_backoff=0.01)
        v, params = sub.snapshot()
        version, cached, changed = sub.poll(force=True)
        assert not changed and cached is params
        snap = sub.fault_snapshot()
        assert snap["reads_stalled"] >= 1 and snap["read_shed"] >= 1
        with srv._read_lock:
            srv._read_tokens = 1
        time.sleep(0.05)
        changed = False
        for _ in range(8):
            version, params2, changed = sub.poll(force=True)
            if changed:
                break
            time.sleep(0.02)
        assert changed and version == v
        sub.close()
    finally:
        srv.close()


def test_server_read_budget_sheds_a_second_reader(monkeypatch):
    monkeypatch.setattr(tma, "_READ_REFILL_S", 60.0)
    srv = _accepting(_port_server(quota=1, read_window=1))
    try:
        sub_a = Subscriber("127.0.0.1", srv.address[1])
        sub_a.snapshot()
        sub_b = Subscriber("127.0.0.1", srv.address[1], read_backoff=0.01)
        version, params, changed = sub_b.poll(force=True)
        assert not changed and params is None
        assert sub_b.fault_stats["read_shed"] >= 1
        assert srv.fault_stats["read_shed"] >= 1
        with srv._read_lock:
            srv._read_tokens = 1
        time.sleep(0.05)
        changed = False
        for _ in range(8):
            version, params, changed = sub_b.poll(force=True)
            if changed:
                break
            time.sleep(0.02)
        assert changed and params is not None
        # A budget the server never grants back: snapshot() gives up
        # loudly after its bounded attempts.
        sub_c = Subscriber("127.0.0.1", srv.address[1], read_backoff=0.01)
        with pytest.raises(FleetDeadError, match="read budget"):
            sub_c.snapshot(attempts=3, wait=0.0)
        for s in (sub_a, sub_b, sub_c):
            s.close()
    finally:
        srv.close()


def test_subs_active_gauge_tracks_live_subscribers():
    srv = _accepting(_port_server(quota=1))
    try:
        subs = [Subscriber("127.0.0.1", srv.address[1]) for _ in range(2)]
        for s in subs:
            s.snapshot()
        assert srv.fault_stats["subs_active"] == 2
        assert srv._workers_seen == 0 and not srv._live_ranks
        subs[0].close()
        _wait(lambda: srv.fault_stats["subs_active"] == 1, what="gauge 1")
        subs[1].close()
        _wait(lambda: srv.fault_stats["subs_active"] == 0, what="gauge 0")
    finally:
        srv.close()


def test_encode_once_fanout_across_many_subscribers():
    srv = _port_server(quota=1, read_window=64)
    try:
        t, out = _serving(srv, steps=6)
        subs = [Subscriber("127.0.0.1", srv.address[1]) for _ in range(4)]
        stop = threading.Event()

        def reader(sub):
            while not stop.is_set() and not sub.done:
                try:
                    sub.poll(force=True)
                except OSError:
                    break
                time.sleep(0.002)

        threads = [threading.Thread(target=reader, args=(s,), daemon=True)
                   for s in subs]
        for th in threads:
            th.start()
        wt, wbox = _worker_thread(srv.address[1])
        _join(t, "serve")
        stop.set()
        for th in threads:
            _join(th, "reader")
        _join(wt, "worker")
        assert "error" not in out
        fs = out["hist"]["fault_stats"]
        versions = len(out["hist"]["versions"])
        reads = sum(s.fault_stats["delta_frames"] for s in subs)
        assert fs["parm_encodes"] <= versions + 2, fs
        assert reads > fs["parm_encodes"], (reads, fs["parm_encodes"])
        for s in subs:
            s.close()
    finally:
        srv.close()


def test_nonblock_heal_keeps_poll_fast_while_ps_is_down():
    srv = _accepting(_port_server(quota=1))
    try:
        sub = Subscriber("127.0.0.1", srv.address[1], nonblock_heal=True,
                         read_backoff=0.05, reconnect_retries=30)
        v, params = sub.snapshot()
    finally:
        srv.close()
    time.sleep(0.1)
    t0 = time.perf_counter()
    for _ in range(3):
        version, cached, changed = sub.poll()
        assert not changed and cached is params
    assert time.perf_counter() - t0 < 2.0
    sub.close()


def test_redial_resets_the_read_gate():
    srv = _accepting(_port_server(quota=1))
    try:
        sub = Subscriber("127.0.0.1", srv.address[1], read_backoff=30.0)
        sub.snapshot()
        sub._session.replenish_read(0)
        version, cached, changed = sub.poll(force=True)
        assert not changed
        sub._connect()
        assert sub._session.read_credits() is None
        version, params, changed = sub.poll(force=True)
        assert changed
        assert sub.fault_stats["version_rewinds"] == 0
        sub.close()
    finally:
        srv.close()


@pytest.mark.parametrize("on_rewind", ["count", "raise"])
def test_a_rewound_server_is_counted_or_refused(on_rewind):
    """A server restored to an older version (other bytes behind a lower
    number): counted and adopted, or `SnapshotRewindError`."""
    srv = _accepting(_port_server(quota=1))
    try:
        sub = Subscriber("127.0.0.1", srv.address[1], on_rewind=on_rewind)
        for _ in range(3):
            _publish(srv)
        assert sub.snapshot()[0] == 3
        srv.load_state_dict(srv.state_dict())
        srv._served_version = 1
        if on_rewind == "raise":
            with pytest.raises(SnapshotRewindError, match="rewound 3 -> 1"):
                sub.poll()
        else:
            version, params, changed = sub.poll()
            assert changed and version == 1
        assert sub.fault_stats["version_rewinds"] == 1
        sub.close()
    finally:
        srv.close()


def test_plain_subscriber_refuses_a_fleet_shard_and_a_plan():
    srv = _accepting(_port_server(quota=1))
    try:
        sub = Subscriber("127.0.0.1", srv.address[1])
        with pytest.raises(ValueError, match="no shard plan"):
            sub._fetch_plan()
        sub.close()
        srv._shard_index, srv._shard_count = 1, 2
        with pytest.raises(ValueError, match="FleetSubscriber"):
            Subscriber("127.0.0.1", srv.address[1])
    finally:
        srv.close()


def test_subscriber_token_must_match():
    srv = _accepting(_port_server(quota=1, token="s3cret"))
    try:
        with pytest.raises(ValueError, match="refused the subscription"):
            Subscriber("127.0.0.1", srv.address[1], token="wrong")
        sub = Subscriber("127.0.0.1", srv.address[1], token="s3cret")
        assert sub.snapshot()[0] == 0
        sub.close()
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# The subscriber's tree: the server's post-decode tree, the JAX reader's
# ---------------------------------------------------------------------------

def _reader_sequence(make, subscriber, codecs, codec, ring):
    """One reader through full, delta, ring-miss (full) and delta reads
    against a server advanced by hand; returns each read's (version,
    tree copy, server post-decode tree) and the server's hit/miss
    counts."""
    srv = _accepting(make(wire_codec=codec, delta_parm=True,
                          read_window=64))
    try:
        sub = subscriber("127.0.0.1", srv.address[1])
        fresh = subscriber("127.0.0.1", srv.address[1])
        fresh.snapshot()
        reads = []

        def read(expect_changed=True):
            version, params, changed = sub.poll()
            assert changed == expect_changed
            reads.append((version, params,
                          {n: np.array(a) if not isinstance(a, torch.Tensor)
                           else a.clone() for n, a in params.items()},
                          _post_decode(codecs, codec, srv._served)))

        v0, _ = sub.snapshot()
        reads.append((v0, sub.params,
                      {n: np.array(a) for n, a in sub.params.items()},
                      _post_decode(codecs, codec, srv._served)))
        for _ in range(2):  # the delta route
            _publish(srv)
            fresh.poll()
            read()
        for _ in range(ring + 1):  # age the reader's base out of the ring
            _publish(srv)
            fresh.poll()
        read()  # the full route (a ring miss)
        _publish(srv, n_changed=3, frac=-0.25)
        read()  # a delta again
        fs = (srv.fault_stats["delta_hits"], srv.fault_stats["delta_misses"])
        sub.close()
        fresh.close()
        return reads, fs
    finally:
        srv.close()


@pytest.mark.parametrize("codec", CODECS)
def test_subscriber_tree_is_the_servers_post_decode_tree(codec):
    treads, tfs = _reader_sequence(_port_server, Subscriber, tcodecs, codec,
                                   tma._DELTA_RING)
    jreads, jfs = _reader_sequence(_jax_server, JSubscriber, jcodecs, codec,
                                   jma._DELTA_RING)
    assert [r[0] for r in treads] == [r[0] for r in jreads] \
        == [0, 1, 2, 7, 8]
    assert tfs == jfs == (10, 1)
    for (_v, tree, copy, post), (_jv, _jt, jcopy, _jp) in zip(treads,
                                                              jreads):
        _assert_tree_bitwise(copy, post)
        _assert_tree_bitwise(copy, jcopy)
        # The cached tree owns its memory: later receives left it whole.
        _assert_tree_bitwise(tree, copy)


# ---------------------------------------------------------------------------
# The delta ring (the JAX package's `test_codec_wire.py` cases)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", CODECS)
def test_subscriber_delta_hits_patch_bitwise(codec):
    srv = _accepting(_port_server(quota=1, wire_codec=codec,
                                  delta_parm=True))
    try:
        sub = Subscriber("127.0.0.1", srv.address[1])
        v0, _ = sub.snapshot()
        for i in range(3):
            _publish(srv)
            version, params, changed = sub.poll()
            assert changed and version == v0 + i + 1
            assert srv.fault_stats["delta_hits"] == i + 1
        assert srv.fault_stats["delta_misses"] == 0
        _assert_tree_bitwise(params, _post_decode(tcodecs, codec,
                                                  srv._served))
        sub.close()
    finally:
        srv.close()


def test_a_delta_bigger_than_the_full_frame_is_a_miss():
    srv = _accepting(_port_server(quota=1, delta_parm=True))
    try:
        sub = Subscriber("127.0.0.1", srv.address[1])
        sub.snapshot()
        _publish(srv, n_changed=10 ** 6)  # every element of the leaf
        served = {n: np.array(p) + np.float32(1.0)
                  for n, p in srv._served.items()}
        srv._served = served  # ... and of every leaf
        version, params, changed = sub.poll()
        assert changed and srv.fault_stats["delta_misses"] == 1
        assert srv.fault_stats["delta_hits"] == 0
        _assert_tree_bitwise(params, srv._served)
        sub.close()
    finally:
        srv.close()


def test_load_state_dict_clears_the_delta_ring():
    srv = _accepting(_port_server(quota=1, wire_codec="bf16",
                                  delta_parm=True))
    try:
        sub = Subscriber("127.0.0.1", srv.address[1])
        sub.snapshot()
        _publish(srv)
        sub.poll()
        assert srv.fault_stats["delta_hits"] == 1
        srv.load_state_dict(srv.state_dict())
        assert srv._delta_ring == {} and srv._delta_cache == {}
        _publish(srv)
        version, params, changed = sub.poll()
        assert changed and srv.fault_stats["delta_misses"] >= 1
        assert sub.fault_stats["version_rewinds"] == 0
        sub.close()
    finally:
        srv.close()


def test_redial_presents_unversioned_and_pays_one_full_read():
    srv = _accepting(_port_server(quota=1, wire_codec="bf16",
                                  delta_parm=True))
    try:
        sub = Subscriber("127.0.0.1", srv.address[1], reconnect_retries=10,
                         backoff_max=0.2)
        sub.snapshot()
        _publish(srv)
        sub.poll()
        hits_before = srv.fault_stats["delta_hits"]
        sub._session.sock.close()
        _publish(srv)
        changed = False
        for _ in range(50):
            try:
                version, params, changed = sub.poll()
            except OSError:
                time.sleep(0.02)
                continue
            if changed:
                break
            time.sleep(0.02)
        assert changed
        assert srv.fault_stats["delta_hits"] == hits_before
        assert srv.fault_stats["delta_misses"] == 0
        assert sub.fault_stats["version_rewinds"] == 0
        _assert_tree_bitwise(params, _post_decode(tcodecs, "bf16",
                                                  srv._served))
        sub.close()
    finally:
        srv.close()


def test_delta_encode_is_cached_across_subscribers():
    srv = _accepting(_port_server(quota=1, wire_codec="bf16",
                                  delta_parm=True))
    try:
        subs = [Subscriber("127.0.0.1", srv.address[1]) for _ in range(3)]
        for s in subs:
            s.snapshot()
        _publish(srv)
        for s in subs:
            assert s.poll()[2]
        assert srv.fault_stats["delta_hits"] == 3
        with srv._parm_lock:
            assert len(srv._delta_cache) == 1
        for s in subs:
            s.close()
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# Counters: the JAX package's keys and rendering
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", SERVE_COUNTERS)
def test_serve_counter_renders_as_jax(key):
    assert format_fault_stats({key: 3}) == jformat_fault_stats({key: 3}) \
        == f"{key}=3"


def test_serve_counters_key_parity():
    inproc = AsyncPS([("w", np.zeros((2,), np.float32))], quota=1,
                     devices=[torch.device("cpu")])
    srv = _accepting(_port_server(quota=1))
    jsrv = _jax_server(quota=1)
    try:
        for key in SERVE_COUNTERS[:5] + ("infer_requests", "infer_shed",
                                         "delta_hits", "delta_misses"):
            assert key in inproc.fault_stats and key in srv.fault_stats
        for key in SERVE_COUNTERS:
            if key not in ("version_rewinds", "param_swaps"):
                assert key in jsrv.fault_stats and key in srv.fault_stats
        sub = Subscriber("127.0.0.1", srv.address[1])
        jsub_keys = {"reads_served", "read_shed", "delta_frames",
                     "version_rewinds", "deadline_expired"}
        assert set(sub.fault_stats) == jsub_keys
        assert set(inproc._base_fault_snapshot()) <= \
            set(srv._fault_stats_snapshot())
        sub.close()
    finally:
        srv.close()
        jsrv.close()


def test_server_validates_read_window_as_jax():
    for make in (_port_server, _jax_server):
        with pytest.raises(ValueError, match="read_window must be >= 0"):
            make(read_window=-1)
    srv, jsrv = _port_server(), _jax_server()
    try:
        assert srv._read_window == jsrv._read_window == 4
    finally:
        srv.close()
        jsrv.close()


# ---------------------------------------------------------------------------
# The CLI: refusals as the JAX CLI's, and one run
# ---------------------------------------------------------------------------

SERVE_REFUSALS = [
    ["--model", "mlp", "--subscribe", "127.0.0.1:1", "--serve", "0"],
    ["--model", "mlp", "--subscribe", "127.0.0.1:1", "--connect",
     "127.0.0.1:1"],
    ["--model", "mlp", "--async-ps", "--subscribe", "127.0.0.1:1"],
    ["--model", "transformer", "--infer-serve"],
    ["--model", "transformer", "--infer-serve", "--connect", "127.0.0.1:1"],
    ["--model", "mlp", "--subscribe", "127.0.0.1:1", "--infer-serve"],
    ["--model", "mlp", "--read-window", "4"],
    ["--model", "mlp", "--connect", "127.0.0.1:1", "--read-window", "4"],
    ["--model", "mlp", "--subscribe", "127.0.0.1:1", "--read-window", "4"],
    ["--model", "mlp", "--serve", "0", "--read-window", "-1"],
    ["--model", "mlp", "--subscribe", "127.0.0.1:1", "--delta-parm"],
    ["--model", "mlp", "--connect", "127.0.0.1:1", "--delta-parm"],
    ["--model", "mlp", "--subscribe", "127.0.0.1:1", "--wire-codec",
     "bf16"],
]


@pytest.mark.parametrize("argv", SERVE_REFUSALS,
                         ids=[" ".join(a[2:]) for a in SERVE_REFUSALS])
def test_cli_serve_tier_refusals_match_jax(argv):
    msgs = []
    for main in (jtrain.main, ttrain.main):
        with pytest.raises(SystemExit) as e:
            main(argv + ["--steps", "1", "--force-cpu-devices", "1"])
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]
    assert "not ported" not in msgs[1]


def test_cli_refuses_the_fleet_forms_and_inert_flash():
    """The fleet forms of ``--subscribe`` (several endpoints, or one with
    ``--shards K``) are ported: they dial every shard (here bound ports
    that do not listen); ``--attn flash`` on a reader stays refused."""
    with pytest.raises(SystemExit) as e:
        ttrain.main(["--model", "transformer", "--subscribe", "h:1",
                     "--infer-serve", "--attn", "flash", "--steps", "1"]
                    + CPU)
    assert str(e.value).startswith(
        "--attn flash on --subscribe would be silently inert")
    with socket.socket() as a, socket.socket() as b:
        a.bind(("127.0.0.1", 0))
        b.bind(("127.0.0.1", 0))
        pa, pb = a.getsockname()[1], b.getsockname()[1]
        for argv in (["--subscribe", f"127.0.0.1:{pa},127.0.0.1:{pb}"],
                     ["--subscribe", f"127.0.0.1:{pa}", "--shards", "2"]):
            with pytest.raises(ConnectionRefusedError):
                ttrain.main(argv + ["--steps", "1", "--reconnect-retries",
                                    "0"] + CPU)


def test_cli_serve_connect_and_infer_reader():
    import re

    """``--serve 0 --delta-parm --wire-codec bf16`` on the CLI's LM at a
    tiny vocabulary and length, one ``--connect`` worker and one
    ``--subscribe --infer-serve`` reader, each a process of its own: the
    reader's lines and the server's serve-tier counters."""
    lm = ["--model", "transformer", "--vocab", "64", "--seq-len", "16",
          "--batch-size", "4", "--n-examples", "32"] + CPU

    def cli(argv):
        return spawn([sys.executable, "-m", "pytorch_ps_mpi_tpu_torch.train",
                      *argv], cwd=REPO, env=ENV)

    def finish(proc, name, timeout=90):
        (rc, out, err), = reap([proc], timeout)
        assert rc == 0, (name, err[-3000:])
        return out, err

    procs = {}
    try:
        procs["server"] = cli(lm + [
            "--serve", "0", "--delta-parm", "--wire-codec", "bf16",
            "--steps", "12", "--quota", "1", "--lr", "0.01"])
        line = first_line(procs["server"], "serving on port ", 90)
        assert line.startswith("serving on port "), line
        port = int(line.split()[-1])
        procs["reader"] = cli(lm + [
            "--subscribe", f"127.0.0.1:{port}", "--infer-serve",
            "--steps", "4"])
        procs["worker"] = cli(lm + [
            "--connect", f"127.0.0.1:{port}", "--reconnect-retries", "2"])
        rout, rerr = finish(procs.pop("reader"), "reader")
        wout, werr = finish(procs.pop("worker"), "worker")
        sout, serr = finish(procs.pop("server"), "server")
    finally:
        for p in procs.values():
            p.kill()
        reap(list(procs.values()))
    assert rout.startswith("subscribed at version "), rout
    m = re.search(r"^infer done: (\d+) served, (\d+) shed, p50 [\d.]+s "
                  r"p95 [\d.]+s over (\d+) batch steps, (\d+) hot swaps$",
                  rerr, re.M)
    assert m is not None, rerr
    assert m.group(1) == "4" and m.group(2) == "0"
    assert int(m.group(3)) >= 8
    assert re.search(r"^done: 12 updates", serr, re.M), serr
    assert "reads_served=" in serr
    assert "worker rank 0 done:" in werr


# ---------------------------------------------------------------------------
# The fleet's reader (tests/test_serve.py:372, 389, 412)
# ---------------------------------------------------------------------------

def _port_fleet(**kw):
    from pytorch_ps_mpi_tpu_torch.shard import PSFleet

    fleet = PSFleet(list(_params().items()), num_shards=2, quota=1, lr=0.05,
                    momentum=0.5, device="cpu", **kw)
    fleet.compile_step(mlp_loss_fn)
    return fleet


def test_plain_subscriber_refuses_fleet_shard():
    fleet = _port_fleet()
    try:
        for srv in fleet.servers:
            _accepting(srv)
        with pytest.raises(ValueError, match="FleetSubscriber"):
            Subscriber("127.0.0.1", fleet.addresses[0][1])
        with pytest.raises(ValueError, match="endpoint order mismatch"):
            FleetSubscriber(list(reversed(fleet.addresses)))
        with pytest.raises(ValueError, match="every shard exactly once"):
            FleetSubscriber(fleet.addresses[:1])
    finally:
        fleet.close()


@pytest.mark.parametrize("wire_codec", CODECS)
def test_fleet_subscriber_assembles_full_tree(wire_codec):
    """The full tree from the two shards' slices, in the plan's order, each
    leaf bitwise the serving shard's post-decode leaf (the same read of a
    JAX fleet's shards gives the same leaves); a second poll is
    all-unchanged, a version advance on one shard re-assembles."""
    from pytorch_ps_mpi_tpu.shard import PSFleet as JFleet

    fleet = _port_fleet(wire_codec=wire_codec, delta_parm=True)
    jfleet = JFleet(list(_params().items()), num_shards=2, quota=1, lr=0.05,
                    momentum=0.5, wire_codec=wire_codec)
    jfleet.compile_step(jmlp_loss)
    try:
        for srv in fleet.servers + jfleet.servers:
            _accepting(srv)
        sub = FleetSubscriber(fleet.addresses)
        versions, tree = sub.snapshot()
        assert versions == (0, 0) and sub.version == (0, 0)
        assert list(tree) == list(fleet.plan.assignment)
        for k, srv in enumerate(fleet.servers):
            want = tcodecs.decode_wire_tree(
                srv._wire_codec_id, tcodecs.encode_wire_tree(
                    wire_codec, dict(srv._served)))
            for n in fleet.plan.names_for(k):
                assert np.asarray(tree[n]).tobytes() \
                    == np.asarray(want[n]).tobytes(), n
        from pytorch_ps_mpi_tpu.serve import FleetSubscriber as JFleetSub

        jsub = JFleetSub(jfleet.addresses)
        _, jtree = jsub.snapshot()
        for n in tree:
            assert np.asarray(tree[n]).tobytes() \
                == np.asarray(jtree[n]).tobytes(), n
        jsub.close()
        versions, tree2, changed = sub.poll()
        assert not changed and tree2 is tree
        # One shard advances: the next poll assembles a new tree.
        srv = fleet.servers[1]
        srv.params = {n: p + 1.0 for n, p in srv.params.items()}
        srv._publish()
        versions, tree3, changed = sub.poll()
        assert changed and versions == (0, 1) and tree3 is not tree
        for n in fleet.plan.names_for(0):
            assert tree3[n] is tree[n]
        sub.close()
    finally:
        fleet.close()
        jfleet.close()


def test_subscriber_survives_shard_failover_without_rewind(tmp_path):
    """A shard dies mid-run; its standby is promoted on the same port (or,
    here, the shard is restored from its checkpoint): the fleet reader's
    link redials, reads resume, and no link's version ever rewinds."""
    fleet = _port_fleet(fault_plan=FaultPlan(seed=0, kill_shard_at={1: 4}))
    out = {}
    ckpt = tmp_path / "ckpt.psz"

    def serve():
        try:
            out["hist"] = fleet.serve(steps=10, idle_timeout=TIMEOUT,
                                      checkpoint_path=str(ckpt),
                                      checkpoint_every=1)
        except BaseException as exc:  # noqa: BLE001 - surfaced below
            out["error"] = exc

    st = threading.Thread(target=serve, daemon=True)
    st.start()
    x, y = _teacher()
    from pytorch_ps_mpi_tpu_torch.shard import ShardRouter

    def worker():
        try:
            r = ShardRouter(fleet.addresses, device="cpu",
                            reconnect_retries=20, backoff_max=0.5)
            r.run(mlp_loss_fn, dataset_batch_fn(x, y, 32))
        except BaseException as exc:  # noqa: BLE001 - surfaced below
            out["worker_error"] = exc

    try:
        sub = FleetSubscriber(fleet.addresses, reconnect_retries=20,
                              backoff_max=0.5)
        wt = threading.Thread(target=worker, daemon=True)
        wt.start()
        seen_after_kill = 0
        restored = False
        seen = [0, 0]
        end = time.monotonic() + TIMEOUT
        while time.monotonic() < end:
            try:
                versions, tree, changed = sub.poll()
            except OSError:
                break
            for k, v in enumerate(versions):
                if v is not None:
                    assert v >= seen[k], (versions, seen)
                    seen[k] = v
            if fleet.fault_stats.get("shard_restores", 0) >= 1:
                restored = True
                if changed:
                    seen_after_kill += 1
            if sub.done:
                break
            time.sleep(0.005)
        st.join(TIMEOUT)
        wt.join(TIMEOUT)
        assert not st.is_alive() and not wt.is_alive()
        assert "error" not in out and "worker_error" not in out, out
        assert out["hist"]["fault_stats"]["shard_restores"] >= 1
        assert restored and seen_after_kill >= 1
        snap = sub.fault_snapshot()
        assert snap["version_rewinds"] == 0
        assert sub.links[1].reconnects >= 1
        sub.close()
    finally:
        fleet.close()
