"""The fleet's availability layer (hot standbys with promotion, coordinated
snapshots with their manifest, partition-tolerant routers) against the
JAX package's, on the CPU.

* Frame heads: SNAP and PROM replies of a port shard and standby to the
  JAX package's ``control_connect`` are byte for byte a JAX server's; a
  JAX primary's REPL at a port standby (its checkpoint format is not the
  port's) is refused, counted, and costs the connection — it never hangs,
  and the JAX primary serves on.
* The state carried across: a promoted successor's parameters and
  optimizer state are bitwise the primary's at the replicated step, and
  bitwise the replicated blob, under every wire codec.
* The cases of the JAX package's ``tests/test_failover.py`` (replication
  within its cadence, promotion with zero rewind, the PROM fence,
  rank-less control connections, one consistent snapshot cut, the
  manifest refusal matrix and skew, a partition that degrades and heals
  or escalates in bounds, key parity, the CLI's refusals), run against
  the port.
* One CLI run: ``--serve 0 --shards 2 --replicas 1 --snapshot-every 5
  --save`` with two multi-endpoint ``--connect`` workers, then ``--resume``
  from the manifest, each a process with a timeout, ``OMP_NUM_THREADS=2``,
  ``--reconnect-retries 2`` and its stderr in a file.

Kill-and-promote cases run with short backoffs and idle timeouts; every
thread is joined and every process waited for with a timeout.
"""

import json
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from procs import first_line, reap, spawn

import pytorch_ps_mpi_tpu.multihost_async as jma
import pytorch_ps_mpi_tpu.shard as jshard
from pytorch_ps_mpi_tpu import train as jtrain
from pytorch_ps_mpi_tpu.models import mlp_loss_fn as jmlp_loss
from pytorch_ps_mpi_tpu.utils import checkpoint as jcheckpoint
from pytorch_ps_mpi_tpu_torch import train as ttrain
from pytorch_ps_mpi_tpu_torch.async_ps import AsyncPS, dataset_batch_fn
from pytorch_ps_mpi_tpu_torch.errors import (FleetDeadError,
                                             FleetManifestError,
                                             FleetResumeSkewError)
from pytorch_ps_mpi_tpu_torch.models import init_mlp, mlp_loss_fn
from pytorch_ps_mpi_tpu_torch.multihost_async import (AsyncPSServer,
                                                      control_connect)
from pytorch_ps_mpi_tpu_torch.native import serializer
from pytorch_ps_mpi_tpu_torch.ops.codecs import decode_wire_tree
from pytorch_ps_mpi_tpu_torch.shard import (FleetManifest, PSFleet,
                                            ShardRouter,
                                            fleet_manifest_path)
from pytorch_ps_mpi_tpu_torch.shard.fleet import shard_checkpoint_path
from pytorch_ps_mpi_tpu_torch.transport import (_U64, recv_frame,
                                                request_promotion,
                                                request_snapshot,
                                                send_frame)
from pytorch_ps_mpi_tpu_torch.utils import checkpoint
from pytorch_ps_mpi_tpu_torch.utils.faults import FaultPlan
from pytorch_ps_mpi_tpu_torch.utils.timing import format_fault_stats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (16, 32, 4)
TIMEOUT = 60  # every serve(), join and process in this file
CPU = ["--force-cpu-devices", "1"]
ENV = {**os.environ, "OMP_NUM_THREADS": "2"}


def _teacher():
    rng = np.random.RandomState(7)
    x = rng.randn(256, 16).astype(np.float32)
    w = rng.randn(16, 4).astype(np.float32)
    y = (x @ w).argmax(1).astype(np.int32)
    return x, y


def _params(seed=0):
    return init_mlp(np.random.RandomState(seed), sizes=SIZES)


def _fleet(num_shards=2, quota=1, seed=0, **kw):
    fleet = PSFleet(list(_params(seed).items()), num_shards=num_shards,
                    quota=quota, optim="sgd", lr=0.05, momentum=0.5,
                    device="cpu", **kw)
    fleet.compile_step(mlp_loss_fn)
    return fleet


def _router_thread(addresses, results, key, *, seed=3, pace=0.0, **kw):
    x, y = _teacher()
    kw.setdefault("device", "cpu")

    def go():
        try:
            r = ShardRouter(addresses, **kw)
            inner = dataset_batch_fn(x, y, 64, seed=seed)

            def batch_fn(rank, it):
                if pace:
                    time.sleep(pace)
                return inner(rank, it)

            pushed = r.run(mlp_loss_fn, batch_fn)
            results[key] = {"pushed": pushed, "rank": r.rank,
                            "reconnects": r.reconnects,
                            "fault_stats": dict(r.fault_stats)}
        except BaseException as exc:  # noqa: BLE001 - asserted below
            results[key] = {"error": exc}

    t = threading.Thread(target=go, daemon=True, name=f"failover-{key}")
    t.start()
    return t


def _serve(fleet, results, threads, **kw):
    """``fleet.serve`` with the routers joined (and the fleet closed)
    whatever happens."""
    try:
        return fleet.serve(idle_timeout=TIMEOUT, **kw)
    finally:
        for t in threads:
            t.join(TIMEOUT)
        fleet.close()
        assert not any(t.is_alive() for t in threads)
        for key, r in results.items():
            assert "error" not in r, (key, r)


def _wait(pred, timeout=20.0, what="condition"):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


# ---------------------------------------------------------------------------
# Frame heads against the JAX package
# ---------------------------------------------------------------------------

def _pair(**kw):
    """(port server, JAX server): shard 0 of the same 2-shard plan."""
    from pytorch_ps_mpi_tpu.shard.partition import ShardInfo as JInfo
    from pytorch_ps_mpi_tpu_torch.shard import build_shard_plan
    from pytorch_ps_mpi_tpu_torch.shard.partition import ShardInfo

    named = list(_params().items())
    t = AsyncPSServer(named, quota=1, optim="sgd", lr=0.05, device="cpu",
                      shard_info=ShardInfo(0, 2, build_shard_plan(named, 2)),
                      **kw)
    j = jma.AsyncPSServer(
        named, quota=1, optim="sgd", lr=0.05,
        shard_info=JInfo(0, 2, jshard.build_shard_plan(named, 2)), **kw)
    return t, j


def _accepting(*servers):
    for srv in servers:
        srv._start_accept_thread()


def test_snap_and_prom_replies_match_a_jax_server():
    """The JAX package's ``control_connect`` against a port shard and a JAX
    shard: SNAP before serving (0, refused), SNAP once armable (the cut),
    SNAP behind the boundary (0); against a port standby and a JAX standby:
    PROM with nothing replicated (all ones), a wrong digest (connection
    dropped).  Every reply byte for byte equal."""
    (tp, jp), (ts, js) = _pair(), _pair(standby=True)
    _accepting(tp, jp, ts, js)
    try:
        digest = jshard.build_shard_plan(list(_params().items()), 2).digest()
        replies = []
        for prim, sb in ((tp, ts), (jp, js)):
            out = []
            sock = jma.control_connect("127.0.0.1", prim.address[1])
            for cut, armed_path in ((5, None), (5, "x.psz"), (0, "x.psz")):
                with prim._stats_lock:
                    prim._snap_path = armed_path
                jma._send_frame(sock, b"SNAP" + _U64.pack(cut))
                out.append(jma._recv_frame(sock))
            sock.close()
            sock = jma.control_connect("127.0.0.1", sb.address[1])
            jma._send_frame(sock, b"PROM" + _U64.pack(digest))
            out.append(jma._recv_frame(sock))
            jma._send_frame(sock, b"PROM" + _U64.pack(0xDEAD))
            with pytest.raises(ConnectionError):
                jma._recv_frame(sock)
            sock.close()
            replies.append(out)
        assert replies[0] == replies[1]
        assert replies[0][:3] == [b"SNAP" + _U64.pack(0),
                                  b"SNAP" + _U64.pack(5),
                                  b"SNAP" + _U64.pack(0)]
        assert replies[0][3] == b"PROM" + b"\xff" * 8
        assert tp._snap_cuts == {5}
    finally:
        for srv in (tp, jp, ts, js):
            srv.close()


def test_jax_repl_at_a_port_standby_is_refused_and_never_hangs():
    """A REPL carrying the JAX package's checkpoint (its PST2 tree frame)
    costs its connection at a port standby, counted, nothing stashed; a
    real JAX primary replicating to a port standby serves all its updates
    (its REPL round trip fails, ``repl_lag`` grows)."""
    from pytorch_ps_mpi_tpu.multihost_async import AsyncPSWorker as JWorker

    standby = AsyncPSServer(list(_params().items()), quota=1, lr=0.05,
                            device="cpu", standby=True)
    standby._start_accept_thread()
    primary = jma.AsyncSGDServer(
        list(_params().items()), quota=1, lr=0.05,
        replica_addr=("127.0.0.1", standby.address[1]), op_deadline=5.0)
    primary.compile_step(jmlp_loss)
    try:
        blob = jcheckpoint.dump_optimizer_bytes(primary, step=1)
        sock = control_connect("127.0.0.1", standby.address[1])
        send_frame(sock, b"REPL" + _U64.pack(1) + b"\x00" + blob)
        with pytest.raises(ConnectionError):
            recv_frame(sock)
        sock.close()
        # The connection thread counts the frame, then records the drop.
        _wait(lambda: standby.fault_stats["quarantined_frames"] == 1
              and standby._last_drop is not None)
        assert isinstance(standby._last_drop,
                          serializer.ForeignTreeFrameError)
        assert standby.replica_step() is None
        box = {}
        x, y = _teacher()

        def work():
            from pytorch_ps_mpi_tpu.async_ps import dataset_batch_fn as jb
            w = JWorker("127.0.0.1", primary.address[1], reconnect_retries=1)
            box["pushed"] = w.run(jmlp_loss, jb(x, y, 32, seed=1))

        t = threading.Thread(target=work, daemon=True)
        t.start()
        t0 = time.monotonic()
        hist = primary.serve(steps=3, idle_timeout=TIMEOUT)
        t.join(TIMEOUT)
        assert time.monotonic() - t0 < TIMEOUT
        assert len(hist["losses"]) == 3
        fs = hist["fault_stats"]
        assert fs["repl_sent"] == 0 and fs["repl_lag"] == 3
        _wait(lambda: standby.fault_stats["quarantined_frames"] == 4,
              what="each REPL of the JAX primary refused")
        assert standby.replica_step() is None
    finally:
        primary.close()
        standby.close()


def test_repl_and_ackr_heads_interoperate_with_the_jax_package():
    """A port primary's REPL reaches a JAX standby (which stashes blobs
    unread): its head's step and codec byte are read there, the JAX ACKR
    is read here (``repl_sent`` 1, ``repl_lag`` 0), and the stashed blob
    is the port's checkpoint of the primary.  The same REPL frame at a JAX
    standby and at a port standby gets the same ACKR bytes."""
    tsb, jsb = _pair(standby=True)
    primary = AsyncPSServer(list(_params().items()), quota=1, lr=0.05,
                            device="cpu", replica_addr=jsb.address,
                            op_deadline=5.0)
    _accepting(jsb, tsb)
    try:
        primary._replicate(3)
        assert primary.fault_stats["repl_sent"] == 1
        assert primary.fault_stats["repl_lag"] == 0
        assert jsb.replica_step() == 3 and jsb._repl_codec == 0
        arrays, meta = checkpoint.loads_tree(jsb._repl_blob, with_meta=True)
        assert meta["step"] == 3
        for n, a in primary.state_dict()["params"].items():
            np.testing.assert_array_equal(arrays["params"][n], a)
        frame = b"REPL" + _U64.pack(4) + b"\x00" + jsb._repl_blob
        acks = []
        for sb in (jsb, tsb):
            sock = jma.control_connect("127.0.0.1", sb.address[1])
            jma._send_frame(sock, frame)
            acks.append(jma._recv_frame(sock))
            sock.close()
        assert acks[0] == acks[1]
        assert acks[0][:4] == b"ACKR" and _U64.unpack_from(acks[0], 4)[0] == 4
    finally:
        for srv in (primary, jsb, tsb):
            srv.close()


# ---------------------------------------------------------------------------
# The state carried across a promotion
# ---------------------------------------------------------------------------

def _state(srv):
    sd = srv.state_dict()
    return {"params": {n: np.array(a) for n, a in sd["params"].items()},
            "state": {n: {k: np.array(v) for k, v in st.items()}
                      for n, st in sd["state"].items()}}


def _assert_same(a, b):
    assert a["params"].keys() == b["params"].keys()
    for n in a["params"]:
        np.testing.assert_array_equal(a["params"][n], b["params"][n], n)
        for k in a["state"][n]:
            np.testing.assert_array_equal(a["state"][n][k],
                                          b["state"][n][k], f"{n}/{k}")


@pytest.mark.parametrize("wire_codec", ["identity", "bf16"])
def test_promoted_state_is_bitwise_the_primary_at_the_replicated_step(
        wire_codec):
    """A 1-shard-of-2 primary trains 4 updates with momentum, replicating
    every update; its standby is promoted: parameters and optimizer state
    are bitwise the primary's after update 4 (identity), and bitwise the
    replicated blob decoded (every wire codec); the serving version and the
    rank allocation carry over."""
    fleet = _fleet(replicas=1, wire_codec=wire_codec)
    results = {}
    t = _router_thread(fleet.addresses, results, "w0")
    try:
        fleet.serve(steps=4, idle_timeout=TIMEOUT)
    finally:
        t.join(TIMEOUT)
    primary, standby = fleet.servers[1], fleet.standbys[1]
    try:
        assert standby.replica_step() == 4
        with standby._repl_lock:
            blob, codec = standby._repl_blob, standby._repl_codec
        assert not isinstance(blob, memoryview) and codec == (
            0 if wire_codec == "identity" else 1)
        arrays, meta = checkpoint.loads_tree(blob, with_meta=True)
        arrays = decode_wire_tree(codec, arrays)
        want = _state(primary)
        assert standby.promote_from_replica() == 4
        got = _state(standby)
        for n in arrays["params"]:
            np.testing.assert_array_equal(got["params"][n],
                                          arrays["params"][n], n)
            for k, v in arrays["state"][n].items():
                np.testing.assert_array_equal(got["state"][n][k], v, n)
        if wire_codec == "identity":
            _assert_same(got, want)
        assert standby._served_version == primary._served_version == 4
        assert standby._next_rank == primary._next_rank == 1
        assert standby._standby is False
        assert meta["step"] == 4
    finally:
        fleet.close()


# ---------------------------------------------------------------------------
# Replication and promotion (tests/test_failover.py:109, 132, 176, 205,
# 256)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("every,bound", [(1, 0), (3, 2)])
def test_replication_keeps_standby_within_cadence_bound(every, bound):
    steps = 6
    fleet = _fleet(replicas=1, replica_every=every)
    results = {}
    t = _router_thread(fleet.addresses, results, "w0")
    hist = _serve(fleet, results, [t], steps=steps)
    for k, sb in enumerate(fleet.standbys):
        assert sb.replica_step() is not None
        assert steps - sb.replica_step() <= bound, (every, k)
    fs = hist["fault_stats"]
    assert fs["repl_sent"] == 2 * (steps // every)
    assert fs["repl_received"] == fs["repl_sent"]
    assert fs["repl_lag"] == 0


def test_promotion_on_kill_zero_rewind_without_checkpointing():
    steps, kill_at = 10, 4
    fleet = _fleet(fault_plan=FaultPlan(kill_shard_at={1: kill_at}),
                   replicas=1)
    results = {}
    t = _router_thread(fleet.addresses, results, "w0",
                       reconnect_retries=20, backoff_base=0.05,
                       backoff_max=0.5)
    hist = _serve(fleet, results, [t], steps=steps)
    fs = hist["fault_stats"]
    assert fs["promotions"] == 1
    assert fs["shard_restores"] == 0
    assert "promotions=1" in format_fault_stats(fs)
    assert fleet._slots[1]["restored_base"] == kill_at
    promoted = hist["per_shard"][1]
    assert len(promoted["losses"]) == steps - kill_at
    assert promoted["versions"][0] == kill_at + 1
    assert promoted["versions"][-1] == steps
    assert hist["updates_total"] == 2 * steps
    assert results["w0"]["reconnects"] >= 1
    # The router kept its rank across the promotion.
    assert results["w0"]["rank"] == 0
    assert fs["shards"]["1"]["live_ranks"] == [0]
    assert fleet.servers[1]._standby is False
    assert fleet.servers[1].replica_addr is not None
    for srv in fleet.servers:
        for n, p in srv.params.items():
            assert torch.isfinite(p).all(), n


def test_snapshot_barrier_completes_after_promotion(tmp_path):
    steps, kill_at = 16, 4
    ckpt = tmp_path / "fleet.psz"
    fleet = _fleet(fault_plan=FaultPlan(kill_shard_at={1: kill_at}),
                   replicas=1)
    results = {}
    t = _router_thread(fleet.addresses, results, "w0", pace=0.05,
                       reconnect_retries=20, backoff_base=0.05,
                       backoff_max=0.5)
    hist = _serve(fleet, results, [t], steps=steps,
                  checkpoint_path=str(ckpt), snapshot_every=4)
    assert hist["fault_stats"]["promotions"] == 1
    manifest = FleetManifest.from_json(
        Path(fleet_manifest_path(ckpt)).read_bytes())
    assert manifest.cut > kill_at
    assert manifest.skewed_entries() == []
    fresh = _fleet()
    try:
        assert fresh.resume_from(str(ckpt)) == [manifest.cut] * 2
    finally:
        fresh.close()


def test_repl_fenced_after_promotion_and_refused_on_non_standby():
    fleet = _fleet(replicas=1)
    try:
        standby = fleet.standbys[0]
        host, port = standby.address
        blob = checkpoint.dump_optimizer_bytes(standby, step=3)
        sock = control_connect(host, port)
        send_frame(sock, b"REPL" + _U64.pack(3) + b"\x00" + blob)
        reply = recv_frame(sock)
        assert reply[:4] == b"ACKR" and _U64.unpack_from(reply, 4)[0] == 3
        assert standby.replica_step() == 3
        assert standby.fault_stats["repl_received"] == 1
        fence = control_connect(host, port)
        assert request_promotion(fence, fleet.plan.digest()) == 3
        fence.close()
        send_frame(sock, b"REPL" + _U64.pack(4) + b"\x00" + blob)
        with pytest.raises(ConnectionError):
            recv_frame(sock)
        sock.close()
        assert standby.fault_stats["repl_refused"] == 1
        assert standby.replica_step() == 3
        bad = control_connect(host, port)
        send_frame(bad, b"PROM" + _U64.pack(0xDEAD))
        with pytest.raises(ConnectionError):
            recv_frame(bad)
        bad.close()
        fleet.servers[0]._start_accept_thread()
        psock = control_connect("127.0.0.1", fleet.servers[0].address[1])
        send_frame(psock, b"REPL" + _U64.pack(1) + b"\x00" + blob)
        with pytest.raises(ConnectionError):
            recv_frame(psock)
        psock.close()
        _wait(lambda: fleet.servers[0].fault_stats["quarantined_frames"]
              >= 1)
        # SUBS at a standby is refused too: it holds blobs, not a
        # served snapshot.
        s2 = control_connect(*fleet.standbys[1].address)
        send_frame(s2, b"SUBS" + _U64.pack((1 << 64) - 1))
        with pytest.raises(ConnectionError):
            recv_frame(s2)
        s2.close()
        _wait(lambda: fleet.standbys[1].fault_stats["quarantined_frames"]
              == 1)
    finally:
        fleet.close()


def test_control_connections_book_no_rank():
    fleet = _fleet()
    try:
        fleet.servers[0]._start_accept_thread()
        sock = control_connect("127.0.0.1", fleet.servers[0].address[1])
        assert request_snapshot(sock, 100) == 0
        sock.close()
        snap = fleet.servers[0]._fault_stats_snapshot()
        assert snap["workers_seen"] == 0
        assert snap["live_ranks"] == []
    finally:
        fleet.close()


# ---------------------------------------------------------------------------
# Coordinated snapshots (tests/test_failover.py:280, 310, 360)
# ---------------------------------------------------------------------------

def test_snapshot_barrier_cuts_one_consistent_version(tmp_path):
    steps = 16
    ckpt = tmp_path / "fleet.psz"
    fleet = _fleet()
    results = {}
    t = _router_thread(fleet.addresses, results, "w0", pace=0.05)
    hist = _serve(fleet, results, [t], steps=steps,
                  checkpoint_path=str(ckpt), snapshot_every=4)
    fs = hist["fault_stats"]
    assert fs["snapshot_barriers"] >= 2
    manifest = FleetManifest.from_json(
        Path(fleet_manifest_path(ckpt)).read_bytes())
    assert manifest.num_shards == 2
    assert manifest.plan_digest == fleet.plan.digest()
    assert manifest.skewed_entries() == []
    assert all(int(e["step"]) == manifest.cut for e in manifest.shards)
    fresh = _fleet()
    try:
        assert fresh.resume_from(str(ckpt)) == [manifest.cut] * 2
        # Each shard's served version is the cut's (continuous versions).
        assert [s._served_version for s in fresh.servers] \
            == [manifest.cut] * 2
    finally:
        fresh.close()


def test_manifest_refusal_matrix(tmp_path):
    ckpt = tmp_path / "fleet.psz"
    fleet = _fleet()
    fleet.save_checkpoint(str(ckpt), step=5)
    fleet.close()
    mpath = Path(fleet_manifest_path(ckpt))
    pristine = mpath.read_bytes()
    shard0 = tmp_path / "fleet.shard0.psz"
    blob = shard0.read_bytes()

    def attempt(exc, match, **kw):
        f = _fleet(**kw)
        try:
            with pytest.raises(exc, match=match):
                f.resume_from(str(ckpt))
        finally:
            f.close()

    f = _fleet()
    assert f.resume_from(str(ckpt)) == [5, 5]
    f.close()
    shard0.unlink()
    attempt(FleetManifestError, "missing")
    shard0.write_bytes(blob[:-1] + bytes([blob[-1] ^ 1]))
    attempt(FleetManifestError, "re-written")
    shard0.write_bytes(blob)
    doc = json.loads(pristine)
    doc["shards"][1]["step"] = 9
    mpath.write_text(json.dumps(doc))
    attempt(FleetResumeSkewError, "different update")
    mpath.write_bytes(pristine)
    attempt(FleetManifestError, "split disagrees", rules=[("bias", 0)])
    mpath.write_text("{oops")
    attempt(FleetManifestError, "unreadable fleet manifest")


def test_legacy_sibling_resume_detects_skew(tmp_path):
    ckpt = tmp_path / "fleet.psz"
    fleet = _fleet()
    fleet.servers[0]._auto_checkpoint(shard_checkpoint_path(ckpt, 0), 4)
    fleet.servers[1]._auto_checkpoint(shard_checkpoint_path(ckpt, 1), 6)
    fleet.close()
    f = _fleet()
    try:
        with pytest.raises(FleetResumeSkewError) as exc:
            f.resume_from(str(ckpt))
        assert "shard 0: step 4" in str(exc.value)
        assert "shard 1: step 6" in str(exc.value)
        Path(shard_checkpoint_path(ckpt, 1)).unlink()
        with pytest.raises(FleetResumeSkewError, match="missing"):
            f.resume_from(str(ckpt))
        f.servers[1]._auto_checkpoint(shard_checkpoint_path(ckpt, 1), 4)
        assert f.resume_from(str(ckpt)) == [4, 4]
    finally:
        f.close()
    for k in range(2):
        Path(shard_checkpoint_path(ckpt, k)).unlink()
    f2 = _fleet()
    try:
        assert f2.resume_from(str(ckpt)) == [0, 0]
    finally:
        f2.close()


# ---------------------------------------------------------------------------
# Partition tolerance (tests/test_failover.py:397, 431)
# ---------------------------------------------------------------------------

def test_partition_degrades_then_heals_without_rank_churn():
    steps = 12
    wplan = FaultPlan(partition_links=[[0, 1, 3, 9]])
    fleet = _fleet(quota=2, quorum=1, fill_deadline=0.05)
    results = {}
    ts = [_router_thread(fleet.addresses, results, f"w{i}", seed=3 + i,
                         fault_plan=wplan, degraded_max=20)
          for i in range(2)]
    hist = _serve(fleet, results, ts, steps=steps, eviction_timeout=1.0)
    partitioned = [r for r in results.values()
                   if r["fault_stats"]["degraded_pulls"] > 0]
    assert len(partitioned) == 1, results
    pfs = partitioned[0]["fault_stats"]
    assert pfs["degraded_pulls"] >= 6 - 1
    assert pfs["partition_drops"] >= 1
    assert partitioned[0]["reconnects"] == 0
    assert format_fault_stats(pfs) != "clean"
    fs = hist["fault_stats"]
    assert fs["reconnects"] == 0
    assert fs["workers_seen"] == 2
    for k in ("0", "1"):
        assert fs["shards"][k]["live_ranks"] == [0, 1]


def test_partition_that_never_heals_escalates_bounded():
    fleet = _fleet()
    serve = [threading.Thread(
        target=lambda k=k: fleet._serve_shard(k, 500,
                                              dict(idle_timeout=30.0)),
        daemon=True) for k in range(2)]
    for s in serve:
        s.start()
    x, y = _teacher()
    try:
        r = ShardRouter(fleet.addresses, device="cpu",
                        fault_plan=FaultPlan(
                            partition_links=[[0, 1, 2, 10 ** 9]]),
                        degraded_max=3)
        with pytest.raises(FleetDeadError, match="degraded-pull bound"):
            r.run(mlp_loss_fn, dataset_batch_fn(x, y, 64, seed=3))
        assert r.fault_stats["degraded_pulls"] == 4
    finally:
        fleet.close()
        for s in serve:
            s.join(30)


# ---------------------------------------------------------------------------
# Key parity; configuration and CLI refusals (tests/test_failover.py:459,
# 534, 559)
# ---------------------------------------------------------------------------

def test_standby_snapshot_key_parity_and_render_coverage():
    inproc = AsyncPS([("w", torch.zeros(2))], quota=1,
                     devices=[torch.device("cpu")])
    fleet = _fleet(replicas=1)
    try:
        base = set(inproc._base_fault_snapshot())
        agg = fleet.fleet_fault_stats()
        assert set(agg["shards"]) == {"0", "1", "0:standby", "1:standby"}
        for name, snap in agg["shards"].items():
            assert base <= set(snap), name
        for key in ("repl_sent", "repl_received", "repl_refused",
                    "snapshot_barriers", "promotions", "shard_restores"):
            assert key in agg
            assert format_fault_stats({key: 1}) != "clean", key
    finally:
        fleet.close()


AVAILABILITY_REFUSALS = [
    ["--serve", "0", "--replicas", "1"],
    ["--serve", "0", "--shards", "2", "--replicas", "2"],
    ["--serve", "0", "--snapshot-every", "5"],
    ["--serve", "0", "--shards", "2", "--snapshot-every", "5"],
    ["--connect", "127.0.0.1:1", "--replicas", "1"],
    ["--serve", "0", "--chaos",
     FaultPlan(partition_links=[[0, 1, 2, 5]]).to_json()],
    ["--connect", "127.0.0.1:1", "--chaos",
     FaultPlan(partition_links=[[0, 1, 2, 5]]).to_json()],
    ["--async-ps", "--chaos",
     FaultPlan(partition_links=[[0, 1, 2, 5]]).to_json()],
]


@pytest.mark.parametrize("argv", AVAILABILITY_REFUSALS,
                         ids=[" ".join(a[:4])[:40]
                              for a in AVAILABILITY_REFUSALS])
def test_cli_refuses_misplaced_availability_flags(argv):
    msgs = []
    for run in (lambda a: jtrain.main(a + ["--n-devices", "1"]),
                lambda a: ttrain.main(a + CPU)):
        with pytest.raises(SystemExit) as e:
            run(["--model", "mlp", "--steps", "1"] + argv)
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]
    assert "not ported" not in msgs[1]


def test_fleet_refuses_bad_replica_config():
    with pytest.raises(ValueError, match="replicas must be 0 or 1"):
        _fleet(replicas=3)
    fleet = _fleet()
    try:
        with pytest.raises(ValueError, match="snapshot_every needs"):
            fleet.serve(steps=1, snapshot_every=2)
    finally:
        fleet.close()
    with pytest.raises(ValueError, match="replica_every"):
        AsyncPSServer(list(_params().items()), quota=1, device="cpu",
                      replica_every=0)
    with pytest.raises(ValueError, match="chained replication"):
        AsyncPSServer(list(_params().items()), quota=1, device="cpu",
                      standby=True, replica_addr=("127.0.0.1", 1))


# ---------------------------------------------------------------------------
# The CLI: a fleet with standbys and snapshots, two router workers, resume
# ---------------------------------------------------------------------------

def _spawn(argv):
    return spawn([sys.executable, "-m", "pytorch_ps_mpi_tpu_torch.train",
                  *argv, *CPU], env=ENV, cwd=REPO)


def _finish(procs, whats):
    """Reap every one of ``procs``, then hold each to exit code 0: their
    stderr, in order."""
    outs = reap(procs, TIMEOUT)
    for (rc, _, text), what in zip(outs, whats):
        assert rc == 0, f"{what} exited {rc}:\n{text}"
    return [text for _, _, text in outs]


def _ports(proc):
    line = first_line(proc, "serving on ports ", TIMEOUT)
    assert line.startswith("serving on ports "), line
    return [int(p) for p in line.split()[3:]]


def test_cli_fleet_with_standbys_snapshots_and_resume(tmp_path):
    ckpt = tmp_path / "ck.psz"
    common = ["--model", "mlp", "--quota", "1", "--batch-size", "32",
              "--n-examples", "128"]
    srv = _spawn(["--serve", "0", "--shards", "2", "--replicas", "1",
                  "--snapshot-every", "5", "--save", str(ckpt),
                  "--steps", "12", *common])
    # The first worker to connect (rank 0) takes 0.3 s a step, so that
    # the second joins before the run ends.
    slow = json.dumps({"slow_rank": 0, "slow_delay_s": 0.3})
    try:
        ports = _ports(srv)
        connect = ",".join(f"127.0.0.1:{p}" for p in ports)
        workers = [_spawn(["--connect", connect, "--reconnect-retries", "2",
                           "--chaos", slow, *common]) for _ in range(2)]
        werrs = _finish(workers, ["worker 0", "worker 1"])
    finally:
        serr, = _finish([srv], ["fleet server"])
    assert "done: 24 shard-updates across 2 shards" in serr
    assert "repl_sent=24" in serr and "repl_received=24" in serr
    ranks = set()
    for err in werrs:
        assert "-shard fleet at 127.0.0.1" in err and "gradients pushed" \
            in err
        ranks.add(err.split("worker rank ")[1].split()[0])
    assert ranks == {"0", "1"}
    manifest = FleetManifest.from_json(
        Path(fleet_manifest_path(ckpt)).read_bytes())
    assert manifest.cut == 12 and manifest.skewed_entries() == []
    # --resume from the manifest: the versions continue.
    srv = _spawn(["--serve", "0", "--shards", "2", "--resume", str(ckpt),
                  "--save", str(ckpt), "--steps", "15", *common])
    try:
        ports = _ports(srv)
        w = _spawn(["--connect", ",".join(f"127.0.0.1:{p}" for p in ports),
                    "--reconnect-retries", "2", *common])
        _finish([w], ["resumed worker"])
    finally:
        serr, = _finish([srv], ["resumed fleet server"])
    assert "resumed fleet shards at steps [12, 12]" in serr
    assert "done: 6 shard-updates across 2 shards" in serr
    for k in range(2):
        with open(shard_checkpoint_path(ckpt, k), "rb") as f:
            _, meta = serializer.loads(f.read(), with_meta=True)
        assert meta["step"] == 15
        assert meta["extra"]["served_version"] == 15
