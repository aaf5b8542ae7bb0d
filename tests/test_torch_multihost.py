"""The multihost async PS over TCP (`multihost_async`) against the JAX
package's, on the CPU.

* Raw-socket conversations: the same HELO and PULL frames to a JAX server
  and a port server built from the same MLP params get replies whose
  heads are byte for byte equal (PSA, NOAU, PARM's version, credits and
  codec byte), and payloads equal after each package's own `loads`.
* Apply parity: the same gradient codes (bitwise equal between the two
  packages' codecs), pushed one at a time to each server, leave served
  params within the async PS's apply tolerance (rtol 1e-6 / atol 2e-6:
  the JAX apply runs under ``jit``, where XLA contracts multiply-adds).
* Port worker processes train over TCP; the fault machinery (dedup, CRC
  drops, eviction, reconnect, refusals at connect, kill and resume); a
  peer of the other package fails loudly, never hangs; a malformed AGGR
  head costs its connection, and the hierarchy's HELO flags are booked
  as the JAX server books them.

Every spawned process and every ``serve()`` has its own timeout of at
most 60 s, and no subprocess pipe is left unread.
"""

import os
import socket
import struct
import subprocess
import sys
import threading
import time
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_ps_mpi_tpu.multihost_async as jma
import pytorch_ps_mpi_tpu_torch.multihost_async as tma
from pytorch_ps_mpi_tpu.models import mlp_loss_fn as jmlp_loss
from pytorch_ps_mpi_tpu.native import serializer as jser
from pytorch_ps_mpi_tpu.ops import codecs as jcodecs
from pytorch_ps_mpi_tpu_torch.async_ps import dataset_batch_fn
from pytorch_ps_mpi_tpu_torch.models import init_mlp, mlp_loss_fn
from pytorch_ps_mpi_tpu_torch.native import serializer as tser
from pytorch_ps_mpi_tpu_torch.native.serializer import ForeignTreeFrameError
from pytorch_ps_mpi_tpu_torch.ops import codecs as tcodecs
from pytorch_ps_mpi_tpu_torch.transport import frame_header, recv_exact
from pytorch_ps_mpi_tpu_torch.utils.faults import FaultPlan, SimulatedCrash

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (32, 64, 8)
TIMEOUT = 60  # every process and every serve() in this file
APPLY_TOL = dict(rtol=1e-6, atol=2e-6)
# Two intra-op threads a worker process (they share the host's cores).
ENV = {**os.environ, "OMP_NUM_THREADS": "2"}


def _params():
    return init_mlp(np.random.RandomState(0), SIZES)


def _teacher(seed=7, n=256):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, SIZES[0]).astype(np.float32)
    w = rng.randn(SIZES[0], SIZES[-1]).astype(np.float32)
    return x, (x @ w).argmax(1).astype(np.int64)


def _port_server(**kw):
    kw.setdefault("lr", 0.05)
    kw.setdefault("quota", 1)
    srv = tma.AsyncSGDServer(list(_params().items()), device="cpu", **kw)
    srv.compile_step(mlp_loss_fn)
    return srv


def _jax_server(**kw):
    kw.setdefault("lr", 0.05)
    kw.setdefault("quota", 1)
    srv = jma.AsyncSGDServer(list(_params().items()), **kw)
    srv.compile_step(jmlp_loss)
    return srv


def _accepting(srv):
    """Run only the accept loop (connections served, no fills)."""
    threading.Thread(target=srv._accept_loop, daemon=True).start()
    return srv


def _serving(srv, steps, **kw):
    """``srv.serve(steps)`` on a thread; returns (thread, result box)."""
    box = {}

    def run():
        try:
            box["hist"] = srv.serve(steps=steps, idle_timeout=TIMEOUT, **kw)
        except BaseException as exc:  # noqa: BLE001 - surfaced by the test
            box["error"] = exc

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


class Raw:
    """A raw framed client."""

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


def _helo(flags=0, extra=b"", token=b""):
    return b"HELO" + bytes([flags]) + extra + token


def _grad(seq, version, blob, loss=1.0, bucket=(0, 1)):
    return (b"GRAD" + struct.pack("<HH", *bucket) + struct.pack("<Q", seq)
            + struct.pack("<Q", version) + struct.pack("<d", loss) + blob)


def _wait(pred, timeout=20.0, what="condition"):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def _stats_clean(fs):
    for key in ("evictions", "crc_dropped", "quarantined_frames",
                "duplicate_dropped", "conn_drops", "stale_dropped",
                "nonfinite_dropped"):
        assert not fs.get(key), (key, fs)


# ---------------------------------------------------------------------------
# The raw-socket conversation, both packages
# ---------------------------------------------------------------------------

def test_mlp_params_match_jax_init():
    from pytorch_ps_mpi_tpu.models import init_mlp as jinit

    a, b = _params(), jinit(np.random.RandomState(0), SIZES)
    assert list(a) == list(b)
    for n in a:
        np.testing.assert_array_equal(a[n], b[n])


@pytest.mark.parametrize("server_token,helo_token", [
    (None, b""), ("s3cret", b"s3cret"), ("s3cret", b"wrong")],
    ids=["no-token", "right-token", "wrong-token"])
def test_helo_replies_equal_jax_byte_for_byte(server_token, helo_token):
    replies = {}
    for name, make in (("jax", _jax_server), ("torch", _port_server)):
        srv = _accepting(make(token=server_token, quota=2))
        try:
            c = Raw(srv.address[1])
            c.send(_helo(token=helo_token))
            replies[name] = [c.recv_raw()]
            if helo_token != b"wrong":
                # A second worker gets the next rank; a reconnect re-books.
                c2 = Raw(srv.address[1])
                c2.send(_helo(token=helo_token))
                replies[name].append(c2.recv_raw())
                c3 = Raw(srv.address[1])
                c3.send(_helo(1, struct.pack("<I", 0), helo_token))
                replies[name].append(c3.recv_raw())
                for x in (c2, c3):
                    x.close()
            c.close()
        finally:
            srv.close()
    assert replies["torch"] == replies["jax"]
    first = replies["torch"][0][8:]
    if helo_token == b"wrong":
        assert first == b"NOAU"
    else:
        assert first[:4] == b"PSA" + bytes([12])
        assert first.endswith(b"identity")


@pytest.mark.parametrize("wire_codec", ["identity", "bf16", "int8"])
def test_pull_replies_equal_jax(wire_codec):
    heads, trees, empties = {}, {}, {}
    for name, make, ser, codecs in (
            ("jax", _jax_server, jser, jcodecs),
            ("torch", _port_server, tser, tcodecs)):
        srv = _accepting(make(wire_codec=wire_codec))
        try:
            c = Raw(srv.address[1])
            c.send(_helo())
            c.recv_raw()
            c.send(b"PULL" + struct.pack("<Q", (1 << 64) - 1))
            frame = c.recv_raw()
            payload = frame[8:]
            heads[name] = payload[:17]
            trees[name] = codecs.decode_wire_tree(payload[16],
                                                  ser.loads(payload[17:]))
            c.send(b"PULL" + struct.pack("<Q", 0))  # have == version
            empties[name] = c.recv_raw()
            c.close()
        finally:
            srv.close()
    assert heads["torch"] == heads["jax"]
    assert heads["torch"][:4] == b"PARM"
    assert heads["torch"][16] == tcodecs.wire_codec_id(wire_codec)
    assert empties["torch"] == empties["jax"]
    assert len(empties["torch"]) == 8 + 17  # head only: "unchanged"
    assert list(trees["torch"]) == list(trees["jax"])
    for n in trees["jax"]:
        a, b = np.asarray(trees["torch"][n]), np.asarray(trees["jax"][n])
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), n


# ---------------------------------------------------------------------------
# Deterministic apply parity
# ---------------------------------------------------------------------------

def _codes(code: str, grads):
    """The same gradients encoded by each package's codec: the codes are
    held bitwise (the MLP's names take no `jax_order` permutation)."""
    jc = jcodecs.get_codec(None if code == "identity" else code)
    tc = tcodecs.get_codec(code)
    jt, tt = OrderedDict(), OrderedDict()
    for n, g in grads.items():
        jt[n] = jax.tree_util.tree_map(np.asarray, jc.encode(jnp.asarray(g)))
        tt[n] = jax.tree_util.tree_map(
            lambda x: x.numpy(), tc.encode(torch.from_numpy(g)))
    for (pj, a), b in zip(jax.tree_util.tree_leaves_with_path(jt),
                          jax.tree_util.tree_leaves(tt)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), pj
    return jt, tt


@pytest.mark.parametrize("code", ["identity", "blockq"])
def test_apply_parity_after_four_updates(code):
    steps = 4
    rng = np.random.default_rng(5)
    params = _params()
    pushes = [_codes(code, OrderedDict(
        (n, (rng.standard_normal(p.shape) * 0.1).astype(np.float32))
        for n, p in params.items())) for _ in range(steps)]
    out = {}
    for name, make, ser, which in (("jax", _jax_server, jser, 0),
                                   ("torch", _port_server, tser, 1)):
        srv = make(code=None if code == "identity" else code,
                   momentum=0.9, quota=1)
        t, box = _serving(srv, steps)
        try:
            c = Raw(srv.address[1])
            c.send(_helo())
            c.recv_raw()
            for k in range(steps):
                c.send(_grad(k, k, ser.dumps(pushes[k][which], level=0),
                             loss=0.5 + k))
                _wait(lambda k=k: srv._served_version == k + 1,
                      what=f"{name} version {k + 1}")
            t.join(TIMEOUT)
            c.close()
        finally:
            srv.close()
        assert "error" not in box, box.get("error")
        out[name] = (dict(srv._served), box["hist"])
    (tp, th), (jp, jh) = out["torch"], out["jax"]
    assert th["versions"] == jh["versions"] == [1, 2, 3, 4]
    assert th["staleness"] == jh["staleness"] == [0.0] * steps
    assert th["losses"] == jh["losses"]
    for n in jp:
        np.testing.assert_allclose(np.asarray(tp[n]), np.asarray(jp[n]),
                                   err_msg=n, **APPLY_TOL)


# ---------------------------------------------------------------------------
# Worker processes over TCP
# ---------------------------------------------------------------------------

WORKER_SCRIPT = r"""
import sys
import numpy as np
from pytorch_ps_mpi_tpu_torch.async_ps import dataset_batch_fn
from pytorch_ps_mpi_tpu_torch.models import mlp_loss_fn
from pytorch_ps_mpi_tpu_torch.multihost_async import AsyncPSWorker
from pytorch_ps_mpi_tpu_torch.utils.timing import format_fault_stats

port, code = int(sys.argv[1]), sys.argv[2]
rng = np.random.RandomState(7)
x = rng.randn(256, 32).astype(np.float32)
w = rng.randn(32, 8).astype(np.float32)
y = (x @ w).argmax(1).astype(np.int64)
worker = AsyncPSWorker("127.0.0.1", port, code=code, device="cpu",
                       io_timeout=30)
pushed = worker.run(mlp_loss_fn, dataset_batch_fn(x, y, 64, seed=3))
print(f"WORKER rank={worker.rank} pushed={pushed} "
      f"stats={format_fault_stats(worker.fault_snapshot())}")
"""


def _spawn_workers(port, code, n, tmp_path):
    procs = []
    for i in range(n):
        err = open(tmp_path / f"worker{i}.err", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", WORKER_SCRIPT, str(port), code],
            cwd=REPO, env=ENV, stdout=subprocess.PIPE, stderr=err,
            text=True), err))
    return procs


def _reap(procs, tmp_path):
    outs = []
    for i, (p, err) in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        err.close()
        outs.append((p.returncode, out,
                     (tmp_path / f"worker{i}.err").read_text()))
    return outs


@pytest.mark.parametrize("code", ["identity", "blockq"])
def test_two_worker_processes_train_over_tcp(code, tmp_path):
    # The PS consumes a gradient every 0.15 s at most, so the run outlasts
    # the second worker's start (a fast worker alone fills every quota).
    srv = _port_server(code=code, quota=2, lr=0.05, momentum=0.5,
                       fault_plan=FaultPlan(slow_consumer=0.15))
    steps = 24
    procs = _spawn_workers(srv.address[1], code, 2, tmp_path)
    try:
        hist = srv.serve(steps=steps, idle_timeout=TIMEOUT)
    finally:
        outs = _reap(procs, tmp_path)
        srv.close()
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{out}\n{err}"
    ranks = sorted(int(o.split("rank=")[1].split()[0]) for _, o, _ in outs)
    assert ranks == [0, 1]
    assert all(int(o.split("pushed=")[1].split()[0]) > 0
               for _, o, _ in outs)
    assert hist["grads_consumed"] == steps * 2
    assert hist["versions"] == list(range(1, steps + 1))
    k = steps // 3
    assert np.mean(hist["losses"][-k:]) < np.mean(hist["losses"][:k])
    fs = hist["fault_stats"]
    _stats_clean(fs)
    assert fs["workers_seen"] == 2 and fs["live_ranks"] == [0, 1]
    assert fs["parm_encodes"] >= 1


# ---------------------------------------------------------------------------
# Faults
# ---------------------------------------------------------------------------

def _blob(srv, scale=0.0):
    tree = OrderedDict((n, np.full(p.shape, scale, np.float32))
                       for n, p in _params().items())
    return tser.dumps(tree, level=0)


def test_repeated_seq_is_dropped():
    srv = _accepting(_port_server(quota=4))
    try:
        c = Raw(srv.address[1])
        c.send(_helo())
        c.recv_raw()
        blob = _blob(srv)
        for seq in (0, 0, 1, 1, 0):
            c.send(_grad(seq, 0, blob))
        _wait(lambda: srv.fault_stats["duplicate_dropped"] == 3,
              what="duplicates counted")
        assert srv._net_queue.qsize() == 2
        c.close()
    finally:
        srv.close()


def _worker_thread(port, box, key="pushed", **kw):
    x, y = _teacher()

    def run():
        try:
            w = tma.AsyncPSWorker("127.0.0.1", port, device="cpu",
                                  io_timeout=30, **kw)
            box["worker"] = w
            box[key] = w.run(mlp_loss_fn, dataset_batch_fn(x, y, 32, seed=1))
        except BaseException as exc:  # noqa: BLE001 - surfaced by the test
            box["error"] = exc

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def test_mangled_frames_are_crc_dropped_and_the_link_survives():
    srv = _port_server(quota=1)
    box = {}
    t = _worker_thread(srv.address[1], box,
                       fault_plan=FaultPlan(corrupt_every=3, seed=2))
    try:
        hist = srv.serve(steps=10, idle_timeout=TIMEOUT)
    finally:
        t.join(TIMEOUT)
        srv.close()
    assert "error" not in box, box.get("error")
    fs = hist["fault_stats"]
    assert fs["crc_dropped"] >= 2
    assert fs["conn_drops"] == 0 and fs["reconnects"] == 0
    assert box["worker"].reconnects == 0
    assert hist["grads_consumed"] == 10


def test_silent_rank_is_evicted_quota_clamps_and_reconnect_rebooks():
    srv = _port_server(quota=2)
    silent = Raw(srv.address[1])
    t_serve, sbox = _serving(srv, 6, eviction_timeout=30.0,
                             dead_conn_grace=0.3)
    box = {}
    try:
        silent.send(_helo())
        psa = silent.recv_raw()
        silent_rank = struct.unpack_from("<I", psa, 12)[0]
        silent.close()  # the rank goes silent: no connection left
        # The live worker paces itself, so the fills outlast the grace.
        t = _worker_thread(srv.address[1], box, fault_plan=FaultPlan(
            slow_rank=silent_rank + 1, slow_delay_s=0.15))
        t_serve.join(TIMEOUT)
        t.join(TIMEOUT)
        assert "error" not in sbox, sbox.get("error")
        fs = sbox["hist"]["fault_stats"]
        assert fs["evictions"] == 1
        assert fs["evicted_ranks"] == [silent_rank]
        # Once the rank is evicted, the quota clamps to the live fleet:
        # the last fills take the one live worker's gradient alone.
        assert [len(c) for c in sbox["hist"]["contributors"][-2:]] == [1, 1]
    finally:
        srv.close()
    # A reconnect presenting an evicted rank re-books it, and the quota
    # grows back.
    srv2 = _accepting(_port_server(quota=2))
    try:
        a = Raw(srv2.address[1])
        a.send(_helo())
        rank = struct.unpack_from("<I", a.recv_raw(), 12)[0]
        a.close()
        _wait(lambda: srv2._conns_for_rank.get(rank) == 0, what="release")
        srv2._evict_dead(eviction_timeout=30.0, dead_conn_grace=0.0)
        assert srv2._evicted == {rank}
        assert srv2._effective_quota() == 1
        b = Raw(srv2.address[1])
        b.send(_helo(1, struct.pack("<I", rank)))
        assert struct.unpack_from("<I", b.recv_raw(), 12)[0] == rank
        assert srv2.fault_stats["reconnects"] == 1
        assert rank in srv2._live_ranks and not srv2._evicted
        assert srv2._effective_quota() == 2
        b.close()
    finally:
        srv2.close()


def test_codec_mismatch_is_refused_at_connect():
    srv = _accepting(_port_server())
    try:
        with pytest.raises(ValueError, match="codec mismatch"):
            tma.AsyncPSWorker("127.0.0.1", srv.address[1], code="blockq",
                              device="cpu")
    finally:
        srv.close()


def _fake_server(reply: bytes):
    """A listener answering the first HELO with ``reply``."""
    lst = socket.create_server(("127.0.0.1", 0))

    def serve():
        conn, _ = lst.accept()
        with conn:
            n = struct.unpack("<II", recv_exact(conn, 8))[0]
            recv_exact(conn, n)
            conn.sendall(frame_header(reply) + reply)
            time.sleep(0.5)
        lst.close()

    threading.Thread(target=serve, daemon=True).start()
    return lst.getsockname()[1]


def test_protocol_version_mismatch_is_refused_at_connect():
    psa11 = (b"PSA" + bytes([11]) + struct.pack("<I", 0) + b"\x00"
             + struct.pack("<HHQ", 0, 1, 0) + struct.pack("<I", 8)
             + b"\x01identity")
    port = _fake_server(psa11)
    with pytest.raises(ValueError, match="server speaks 11, this worker "
                                         "speaks 12"):
        tma.AsyncPSWorker("127.0.0.1", port, device="cpu")
    port = _fake_server(b"HTTP/1.1 400")
    with pytest.raises(ValueError, match="no PSA magic"):
        tma.AsyncPSWorker("127.0.0.1", port, device="cpu")


def test_kill_ps_and_resume_continue_the_versions(tmp_path):
    ck = str(tmp_path / "ps.psz")
    srv = _port_server(quota=1, momentum=0.9,
                       fault_plan=FaultPlan(kill_ps_at=3))
    port = srv.address[1]
    box = {}
    t = _worker_thread(port, box, reconnect_retries=40, backoff_base=0.05,
                       backoff_max=0.2)
    with pytest.raises(SimulatedCrash):
        srv.serve(steps=6, idle_timeout=TIMEOUT, checkpoint_path=ck,
                  checkpoint_every=2)
    srv.close()
    # The relaunch on the same port: resume, then serve the rest.
    srv2 = tma.AsyncSGDServer(list(_params().items()), lr=0.05, quota=1,
                              momentum=0.9, device="cpu", port=port)
    srv2.compile_step(mlp_loss_fn)
    try:
        start = srv2.resume_from(ck)
        assert start == 2 and srv2._served_version == 2
        hist = srv2.serve(steps=6 - start, idle_timeout=TIMEOUT,
                          start_step=start)
    finally:
        t.join(TIMEOUT)
        srv2.close()
    assert "error" not in box, box.get("error")
    assert hist["versions"] == [3, 4, 5, 6]
    assert box["worker"].reconnects >= 1
    assert hist["fault_stats"]["reconnects"] >= 1


# ---------------------------------------------------------------------------
# Mixed-package peers fail loudly
# ---------------------------------------------------------------------------

def test_port_worker_against_jax_server_raises_foreign_frame():
    srv = _accepting(_jax_server())
    t0 = time.monotonic()
    try:
        w = tma.AsyncPSWorker("127.0.0.1", srv.address[1], device="cpu",
                              io_timeout=10)
        with pytest.raises(ForeignTreeFrameError, match="PST2"):
            w.run(mlp_loss_fn, dataset_batch_fn(*_teacher(), 32))
    finally:
        srv.close()
    assert time.monotonic() - t0 < 15


def test_jax_framed_grad_is_quarantined_and_the_server_serves_on():
    srv = _port_server(quota=1)
    t_serve, sbox = _serving(srv, 3)
    try:
        c = Raw(srv.address[1])
        c.send(_helo())
        c.recv_raw()
        jtree = OrderedDict((n, np.zeros(p.shape, np.float32))
                            for n, p in _params().items())
        c.send(_grad(0, 0, jser.dumps(jtree, level=0)))
        _wait(lambda: srv.fault_stats["quarantined_frames"] == 1,
              what="quarantine")
        with pytest.raises((ConnectionError, OSError)):
            c.send(b"BEAT")
            c.recv_raw()
        c.close()
        box = {}
        t = _worker_thread(srv.address[1], box)
        t_serve.join(TIMEOUT)
        t.join(TIMEOUT)
    finally:
        srv.close()
    assert "error" not in sbox and "error" not in box
    assert sbox["hist"]["grads_consumed"] == 3
    assert isinstance(srv._last_drop, ForeignTreeFrameError)


# ---------------------------------------------------------------------------
# The hierarchy's frame and HELO flags (a malformed AGGR head costs only
# its own connection; the fleet's REPL, SNAP and PROM are in
# tests/test_torch_failover.py)
# ---------------------------------------------------------------------------

# A zero AGGR head carries n_buckets 0: the JAX server refuses it as a bad
# bucket header, and so does the port's.
REFUSED = [
    ("AGGR", b"AGGR" + bytes(40), "bad bucket header (0/0)"),
]


@pytest.mark.parametrize("frame,named", [r[1:] for r in REFUSED],
                         ids=[r[0] for r in REFUSED])
def test_unported_frames_are_refused_by_name(frame, named):
    """A malformed AGGR head costs its connection (counted in
    ``quarantined_frames``), as at a JAX server, and the server serves
    on."""
    for srv in (_accepting(_port_server()), _accepting(_jax_server())):
        try:
            c = Raw(srv.address[1])
            c.send(_helo())
            c.recv_raw()
            c.send(frame)
            _wait(lambda: srv._conn_drops == 1, what="connection dropped")
            assert srv.fault_stats["quarantined_frames"] == 1
            assert named in str(srv._last_drop)
            assert srv.fault_stats["agg_frames"] == 0
            c.close()
            # The server serves on: a fresh connection is answered.
            d = Raw(srv.address[1])
            d.send(_helo())
            assert d.recv_raw()[8:11] == b"PSA"
            d.close()
        finally:
            srv.close()


@pytest.mark.parametrize("flag,named", [
    (8, "a hierarchy aggregator"), (16, "a hierarchy direct-fallback")],
    ids=["agg", "fallback"])
def test_unported_helo_flags_are_refused_by_name(flag, named):
    """HELO flag 8 (``group u16 | target u16``: a group's aggregator) and
    flag 16 (``group u16``: a direct-fallback worker) book a rank; the PSA
    reply and the ``groups`` view are the JAX server's."""
    extra = struct.pack("<HH", 3, 2) if flag == 8 else struct.pack("<H", 3)
    replies, views = [], []
    for srv in (_accepting(_port_server()), _accepting(_jax_server())):
        try:
            c = Raw(srv.address[1])
            c.send(_helo(flag, extra))
            replies.append(c.recv_raw())
            snap = srv._fault_stats_snapshot()
            views.append((snap["groups"], snap["direct_fallbacks"],
                          snap["workers_seen"]))
            c.close()
        finally:
            srv.close()
    assert replies[0] == replies[1], named
    assert views[0] == views[1]
    groups, fallbacks, seen = views[0]
    assert seen == 1
    if flag == 8:
        assert groups == {"3": {"aggregator_rank": 0, "group_target": 2,
                                "agg_frames": 0, "last_contributors": 0,
                                "fallback_ranks": []}}
        assert fallbacks == 0
    else:
        assert groups["3"]["fallback_ranks"] == [0] and fallbacks == 1


def test_control_connection_books_no_rank_and_spln_is_empty():
    srv = _accepting(_port_server())
    try:
        sock = tma.control_connect("127.0.0.1", srv.address[1])
        sock.sendall(frame_header(b"SPLN") + b"SPLN")
        n = struct.unpack("<II", recv_exact(sock, 8))[0]
        assert recv_exact(sock, n) == b"SPLN"
        sock.close()
        assert srv._workers_seen == 0 and not srv._live_ranks
    finally:
        srv.close()


def test_nonfinite_injection_is_quarantined_at_the_server():
    srv = _port_server(quota=1, skip_nonfinite=True)
    box = {}
    t = _worker_thread(srv.address[1], box,
                       fault_plan=FaultPlan(nonfinite_at={(0, 1), (0, 3)}))
    try:
        hist = srv.serve(steps=5, idle_timeout=TIMEOUT)
    finally:
        t.join(TIMEOUT)
        srv.close()
    assert "error" not in box, box.get("error")
    assert hist["fault_stats"]["nonfinite_dropped"] == 2
    assert all(np.isfinite(np.asarray(p)).all()
               for p in srv._served.values())


def test_entry_points_default_to_the_card():
    """No ``device``: the server and the worker take the card, and raise
    where there is none (no fall back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible here")
    from pytorch_ps_mpi_tpu_torch import PSRuntimeError

    with pytest.raises(PSRuntimeError, match="no CUDA device"):
        tma.AsyncSGDServer(list(_params().items()), lr=0.1, quota=1)
    srv = _accepting(_port_server())
    try:
        with pytest.raises(PSRuntimeError, match="no CUDA device"):
            tma.AsyncPSWorker("127.0.0.1", srv.address[1])
    finally:
        srv.close()


@pytest.mark.parametrize("code,updates", [("identity", 6), ("blockq", 3)])
def test_lockstep_wire_equals_the_in_process_async_ps(code, updates):
    """One lockstep worker through the wire against a quota-1 server is
    sequential SGD, as the in-process PS's lockstep worker thread is: the
    same batches, codes and apply give bitwise equal params."""
    from pytorch_ps_mpi_tpu_torch import AsyncSGD

    x, y = _teacher()
    ref = AsyncSGD(list(_params().items()), lr=0.05, momentum=0.9, quota=1,
                   code=code, devices=[torch.device("cpu")])
    ref._lockstep = True
    ref.compile_step(mlp_loss_fn)
    rhist = ref.run(dataset_batch_fn(x, y, 32, seed=4), steps=updates)
    srv = _port_server(code=code, momentum=0.9, quota=1)
    t_serve, sbox = _serving(srv, updates)
    try:
        w = tma.AsyncPSWorker("127.0.0.1", srv.address[1], code=code,
                              device="cpu", reconnect_retries=1)
        w._lockstep = True
        pushed = w.run(mlp_loss_fn, dataset_batch_fn(x, y, 32, seed=4))
        t_serve.join(TIMEOUT)
    finally:
        srv.close()
    assert "error" not in sbox, sbox.get("error")
    assert pushed == updates == w.grads_computed
    assert sbox["hist"]["staleness"] == rhist["staleness"] == [0.0] * updates
    np.testing.assert_array_equal(sbox["hist"]["losses"], rhist["losses"])
    for n, p in ref.params.items():
        np.testing.assert_array_equal(srv.params[n].numpy(), p.numpy(),
                                      err_msg=n)


# Every counter of the JAX server and worker is ported: the hierarchy's
# ``agg_frames`` and ``direct_fallbacks`` came with it, the bucket
# stream's ``buckets_sent`` and ``fused_encodes`` and the fleet's
# replication and snapshot counters before.
_UNPORTED_SERVER_KEYS: set = set()
_UNPORTED_WORKER_KEYS: set = set()


def test_fault_stats_render_as_the_jax_package_renders_them():
    """The server's snapshot and the worker's counters carry the JAX
    package's keys, but for those of the unported slices, and
    `format_fault_stats` renders them alike."""
    from pytorch_ps_mpi_tpu.utils.timing import format_fault_stats as jfmt
    from pytorch_ps_mpi_tpu_torch.utils.timing import format_fault_stats

    port = _accepting(_port_server())
    ref = _accepting(_jax_server())
    try:
        tkeys = set(port._fault_stats_snapshot())
        jkeys = set(ref._fault_stats_snapshot())
        assert tkeys == jkeys - _UNPORTED_SERVER_KEYS, sorted(tkeys ^ jkeys)
        w = tma.AsyncPSWorker("127.0.0.1", port.address[1], device="cpu")
        jw = jma.AsyncPSWorker("127.0.0.1", ref.address[1])
        assert (set(w.fault_snapshot())
                == set(jw.fault_snapshot()) - _UNPORTED_WORKER_KEYS)
        w.close()
        jw.close()
        snap = port._fault_stats_snapshot()
        for i, k in enumerate(sorted(k for k, v in snap.items()
                                     if isinstance(v, int))):
            snap[k] = i + 1
        snap["dropped_queue_full"] = {1: 2, -1: 1}
        snap["evicted_ranks"] = [1]
        assert format_fault_stats(snap) == jfmt(snap)
        assert format_fault_stats(port._fault_stats_snapshot()) == "clean"
    finally:
        port.close()
        ref.close()
