"""The hierarchy runs (`shard.hierarchy`): a root PS or `PSFleet`, group
aggregators and their workers as threads of the test process, on the
CPU.

* Lockstep parity: the MLP through a one-group hierarchy (root quota 1,
  group size 1, one worker whose pulls and the aggregator's upstream
  pulls each wait for the previous gradient's update: sequential SGD)
  matches the JAX package's hierarchy within the async PS's apply
  tolerance, identity for 4 updates and blockq for 2; under identity the
  hierarchy's root lands bitwise where a flat lockstep run lands.
* The cases of the JAX package's ``tests/test_hierarchy.py`` run against
  the port: the root sees G frames a update, the fleet-root composition,
  Byzantine containment with the root's scoreboard quiet, the
  kill-and-restart with no rank churn, the direct fallback (to a single
  root and, through a `ShardRouter`, to a fleet), and the aggregator's
  bucketed forward (``tests/test_bucket_stream.py``).

Every serve has an idle timeout and every thread is joined with a timeout.
"""

import threading
import time

import numpy as np
import pytest
import torch

import pytorch_ps_mpi_tpu.multihost_async as jma
import pytorch_ps_mpi_tpu.shard as jshard
from pytorch_ps_mpi_tpu.async_ps import dataset_batch_fn as jbatch_fn
from pytorch_ps_mpi_tpu.models import mlp_loss_fn as jmlp_loss
from pytorch_ps_mpi_tpu_torch.async_ps import dataset_batch_fn
from pytorch_ps_mpi_tpu_torch.models import init_mlp, mlp_loss_fn
from pytorch_ps_mpi_tpu_torch.multihost_async import (AsyncPSWorker,
                                                      AsyncSGDServer)
from pytorch_ps_mpi_tpu_torch.shard import (GroupWorker, Hierarchy,
                                            LocalAggregator, PSFleet)
from pytorch_ps_mpi_tpu_torch.utils.faults import FaultPlan
from pytorch_ps_mpi_tpu_torch.utils.timing import format_fault_stats

TIMEOUT = 60  # every serve() and join in this file
APPLY_TOL = dict(rtol=1e-6, atol=2e-6)


def _teacher():
    rng = np.random.RandomState(7)
    x = rng.randn(256, 16).astype(np.float32)
    w = rng.randn(16, 4).astype(np.float32)
    y = (x @ w).argmax(1).astype(np.int32)
    return x, y


def _params(seed=0):
    return init_mlp(np.random.RandomState(seed), sizes=(16, 32, 4))


def _root(quota, **kw):
    kw.setdefault("code", "identity")
    srv = AsyncSGDServer(list(_params().items()), lr=0.05, momentum=0.5,
                         quota=quota, device="cpu", **kw)
    srv.compile_step(mlp_loss_fn)
    return srv


def _serve_root(srv, steps, out, **kw):
    def go():
        try:
            out["hist"] = srv.serve(steps=steps, idle_timeout=TIMEOUT, **kw)
        except BaseException as exc:  # noqa: BLE001 - asserted by tests
            out["error"] = exc
    t = threading.Thread(target=go, daemon=True, name="root-serve")
    t.start()
    return t


def _hier(upstream, **kw):
    kw.setdefault("device", "cpu")
    hier = Hierarchy(list(_params().items()), upstream=upstream, **kw)
    hier.compile()
    return hier


def _worker_thread(agg_addr, roots, results, key, *, group=0, plan=None,
                   seed=3, retries=3, code="identity"):
    x, y = _teacher()

    def go():
        try:
            gw = GroupWorker(agg_addr[0], agg_addr[1], root_endpoints=roots,
                             group=group, fault_plan=plan, code=code,
                             device="cpu",
                             reconnect_retries=retries, backoff_base=0.05,
                             backoff_max=0.3)
            pushed = gw.run(mlp_loss_fn,
                            dataset_batch_fn(x, y, 64, seed=seed))
            results[key] = {"pushed": pushed, "rank": gw.rank,
                            "direct_rank": gw.direct_rank,
                            "computed": gw.grads_computed,
                            "stats": dict(gw.fault_stats)}
        except BaseException as exc:  # noqa: BLE001 - asserted below
            results[key] = {"error": exc}

    t = threading.Thread(target=go, daemon=True, name=f"gw-{key}")
    t.start()
    return t


def _join_all(threads, timeout=TIMEOUT):
    for t in threads:
        t.join(timeout=timeout)
        assert not t.is_alive(), f"{t.name} still alive"


def _no_errors(results):
    for key, r in results.items():
        assert "error" not in r, (key, r)


# ---------------------------------------------------------------------------
# Lockstep parity with the JAX package's hierarchy
# ---------------------------------------------------------------------------

def _lockstep(obj):
    """Each pull repeats until the version moved past the last one
    returned: with quota 1 at every level, sequential SGD."""
    orig, last = obj.pull, {"v": None}

    def pull(force=False):
        while True:
            got = orig(force)
            if got is None or last["v"] is None or got[0] > last["v"]:
                if got is not None:
                    last["v"] = got[0]
                return got
            time.sleep(0.001)

    obj.pull = pull


def _lockstep_run(pkg, code, updates, hier=True):
    x, y = _teacher()
    if pkg == "port":
        root = _root(1, code=code)
        mk_agg = lambda port: LocalAggregator(  # noqa: E731
            list(_params().items()), group=0, upstream=[("127.0.0.1", port)],
            group_size=1, code=code, device="cpu")
        mk_worker = lambda port: AsyncPSWorker(  # noqa: E731
            "127.0.0.1", port, code=code, device="cpu", reconnect_retries=1)
        loss, batch_fn = mlp_loss_fn, dataset_batch_fn
    else:
        root = jma.AsyncSGDServer(list(_params().items()), lr=0.05,
                                  momentum=0.5, quota=1, code=code)
        root.compile_step(jmlp_loss)
        mk_agg = lambda port: jshard.LocalAggregator(  # noqa: E731
            list(_params().items()), group=0, upstream=[("127.0.0.1", port)],
            group_size=1, code=code)
        mk_worker = lambda port: jma.AsyncPSWorker(  # noqa: E731
            "127.0.0.1", port, code=code, reconnect_retries=1)
        loss, batch_fn = jmlp_loss, jbatch_fn
    out, agg_out, box = {}, {}, {}
    rt = _serve_root(root, updates, out)
    agg = None
    try:
        port = root.address[1]
        if hier:
            agg = mk_agg(port)
            agg.compile_reduce()
            for link in agg._upstream.links:
                _lockstep(link)

            def serve_group():
                try:
                    agg_out["hist"] = agg.serve_group(idle_timeout=TIMEOUT)
                except BaseException as exc:  # noqa: BLE001
                    agg_out["error"] = exc

            at = threading.Thread(target=serve_group, daemon=True)
            at.start()
            port = agg.address[1]
        worker = mk_worker(port)
        _lockstep(worker)
        box["pushed"] = worker.run(loss, batch_fn(x, y, 32, seed=4))
        rt.join(TIMEOUT)
        if hier:
            at.join(TIMEOUT)
            assert not at.is_alive() and "error" not in agg_out, agg_out
    finally:
        if agg is not None:
            agg.close()
        root.close()
    assert not rt.is_alive() and "error" not in out, out
    params = {n: np.asarray(p.detach().numpy() if torch.is_tensor(p) else p)
              for n, p in root.params.items()}
    return out["hist"], params


@pytest.mark.parametrize("code,updates", [("identity", 4), ("blockq", 2)])
def test_lockstep_hierarchy_matches_the_jax_hierarchy(code, updates):
    th, tparams = _lockstep_run("port", code, updates)
    jh, jparams = _lockstep_run("jax", code, updates)
    assert th["versions"] == jh["versions"] == list(range(1, updates + 1))
    assert th["staleness"] == [0.0] * updates
    assert th["fault_stats"]["agg_frames"] >= updates
    assert th["fault_stats"]["groups"]["0"]["last_contributors"] == 1
    np.testing.assert_allclose(th["losses"], jh["losses"], **APPLY_TOL)
    for n in jparams:
        np.testing.assert_allclose(tparams[n], jparams[n], err_msg=n,
                                   **APPLY_TOL)
    if code == "identity":
        # A forward of one contribution moves the root as its GRAD would.
        fh, fparams = _lockstep_run("port", code, updates, hier=False)
        assert fh["losses"] == th["losses"]
        for n in fparams:
            np.testing.assert_array_equal(tparams[n], fparams[n], err_msg=n)


# ---------------------------------------------------------------------------
# The tier trains: G frames at the root (tests/test_hierarchy.py:118)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("code", ["identity", "blockq"])
def test_hierarchy_trains_and_root_sees_g_frames(code):
    steps = 8
    root = _root(quota=2, code=code)
    out: dict = {}
    rt = _serve_root(root, steps, out)
    hier = _hier([("127.0.0.1", root.address[1])], groups=2, group_size=2,
                 code=code)
    results: dict = {}
    try:
        ts = [_worker_thread(hier.addresses[g], [root.address], results,
                             f"w{g}{i}", group=g, seed=3 + 2 * g + i,
                             code=code)
              for g in range(2) for i in range(2)]
        view = hier.serve(idle_timeout=TIMEOUT)
        _join_all([rt] + ts)
    finally:
        hier.close()
        root.close()
    assert "error" not in out, out
    _no_errors(results)
    hist = out["hist"]
    fs = hist["fault_stats"]
    assert len(hist["losses"]) == steps
    assert all(np.isfinite(hist["losses"]))
    # The root's fills hold G frames, never the W raw gradients.
    agg_ranks = {g["aggregator_rank"] for g in fs["groups"].values()}
    for contributors in hist["contributors"]:
        assert len(contributors) == 2 and set(contributors) == agg_ranks
    assert fs["agg_frames"] >= steps * 2
    assert fs["direct_fallbacks"] == 0 and fs["duplicate_dropped"] == 0
    assert set(fs["groups"]) == {"0", "1"}
    for g in fs["groups"].values():
        assert g["group_target"] == 2
        assert g["agg_frames"] >= 1
        assert g["fallback_ranks"] == []
    assert view["fills_total"] == view["fault_stats"]["agg_forwards"] > 0
    rendered = format_fault_stats(fs)
    assert "agg_frames=" in rendered and "groups=" in rendered
    for r in results.values():
        assert r["stats"]["agg_failovers"] == 0
        assert r["computed"] >= r["pushed"] > 0


def test_hierarchy_composes_with_sharded_fleet_root():
    """The aggregator's forward splits along the fleet's `ShardPlan` (per
    shard AGGR slices with per-shard versions); its workers stay
    unsharded behind it.  The fleet's view sums the groups' AGGR traffic
    across shards."""
    steps = 6
    fleet = PSFleet(list(_params().items()), num_shards=2, quota=2,
                    optim="sgd", lr=0.05, momentum=0.5, device="cpu")
    fleet.compile_step(mlp_loss_fn)
    out: dict = {}

    def serve():
        try:
            out["hist"] = fleet.serve(steps=steps, idle_timeout=TIMEOUT)
        except BaseException as exc:  # noqa: BLE001 - asserted below
            out["error"] = exc

    rt = threading.Thread(target=serve, daemon=True)
    rt.start()
    hier = _hier(fleet.addresses, groups=2, group_size=2)
    results: dict = {}
    try:
        ts = [_worker_thread(hier.addresses[g], fleet.addresses, results,
                             f"w{g}{i}", group=g, seed=3 + 2 * g + i)
              for g in range(2) for i in range(2)]
        view = hier.serve(idle_timeout=TIMEOUT)
        _join_all([rt] + ts)
    finally:
        hier.close()
        fleet.close()
    assert "error" not in out, out
    _no_errors(results)
    hist = out["hist"]
    fs = hist["fault_stats"]
    for shard_hist in hist["per_shard"]:
        assert len(shard_hist["losses"]) == steps
        assert all(np.isfinite(shard_hist["losses"]))
    assert fs["agg_frames"] >= steps * 2 * 2  # a shard, a group
    assert set(fs["groups"]) == {"0", "1"}
    for g in ("0", "1"):
        assert fs["groups"][g]["agg_frames"] == sum(
            fs["shards"][k]["groups"][g]["agg_frames"] for k in ("0", "1"))
    assert view["fault_stats"]["agg_forwards"] >= steps


# ---------------------------------------------------------------------------
# Containment (tests/test_hierarchy.py:273)
# ---------------------------------------------------------------------------

def test_group_byzantine_contained_root_scoreboard_quiet():
    steps = 20
    # Root scoring on at the backstop threshold (above the group's): a
    # leaked 100x attack would score far past it.
    root = _root(quota=2, anomaly_z=6.0)
    out: dict = {}
    rt = _serve_root(root, steps, out)
    hier = _hier([("127.0.0.1", root.address[1])], groups=2, group_size=3,
                 aggregate="norm_clip", anomaly_z=4.0, quorum=2,
                 fill_deadline=0.1)
    # The same plan to every group-0 worker: whichever is local rank 1
    # attacks at 100x scale.
    byz = FaultPlan(seed=5, byzantine_rank=1, byzantine_mode="scale",
                    byzantine_scale=100.0)
    results: dict = {}
    try:
        ts = [_worker_thread(hier.addresses[g], [root.address], results,
                             f"w{g}{i}", group=g,
                             plan=byz if g == 0 else None,
                             seed=11 + 3 * g + i)
              for g in range(2) for i in range(3)]
        view = hier.serve(idle_timeout=TIMEOUT)
        _join_all([rt] + ts)
    finally:
        hier.close()
        root.close()
    assert "error" not in out, out
    hist = out["hist"]
    assert len(hist["losses"]) == steps
    g0 = view["fault_stats"]["groups"]["0"]
    assert g0["quarantine_events"] >= 1, g0
    assert g0["quarantined_ranks"], g0
    assert g0["quarantined_drops"] >= 1
    g1 = view["fault_stats"]["groups"]["1"]
    assert g1["quarantine_events"] == 0
    fs = hist["fault_stats"]
    assert fs["quarantine_events"] == 0, fs
    assert fs["quarantined_ranks"] == []
    assert "quarantined_ranks=" in format_fault_stats(g0)


# ---------------------------------------------------------------------------
# Aggregator death: restart in place, or direct fallback
# (tests/test_hierarchy.py:332, 381)
# ---------------------------------------------------------------------------

def test_kill_agg_restart_reclaims_group_without_rank_churn():
    steps = 10
    root = _root(quota=1)
    out: dict = {}
    rt = _serve_root(root, steps, out)
    hier = _hier([("127.0.0.1", root.address[1])], groups=1, group_size=2,
                 fault_plan=FaultPlan(kill_agg_at={0: 3}), max_restarts=2)
    port_before = hier.addresses[0][1]
    upstream_rank_before = hier.aggregators[0].upstream_rank
    results: dict = {}
    try:
        ts = [_worker_thread(hier.addresses[0], [root.address], results,
                             f"w{i}", group=0, seed=3 + i, retries=30)
              for i in range(2)]
        view = hier.serve(idle_timeout=TIMEOUT)
        _join_all([rt] + ts)
        assert hier.addresses[0][1] == port_before
        assert hier.aggregators[0].upstream_rank == upstream_rank_before
    finally:
        hier.close()
        root.close()
    assert "error" not in out, out
    assert view["fault_stats"]["agg_restarts"] == 1
    fs = out["hist"]["fault_stats"]
    # One worker ever at the root (the aggregator's identity) and its
    # sequence continued: no forward dropped as a duplicate.
    assert fs["workers_seen"] == 1
    assert fs["direct_fallbacks"] == 0
    assert fs["groups"]["0"]["aggregator_rank"] == upstream_rank_before
    assert fs["duplicate_dropped"] == 0, fs
    _no_errors(results)
    for r in results.values():
        assert r["stats"]["agg_failovers"] == 0
    assert any(r["stats"]["agg_redials"] >= 1 for r in results.values())
    assert sorted(r["rank"] for r in results.values()) == [0, 1]
    assert any(name.startswith("0:retired")
               for name in view["fault_stats"]["groups"])


def test_failover_direct_fallback_completes_run():
    steps = 12
    root = _root(quota=2, quorum=1, fill_deadline=0.1)
    out: dict = {}
    rt = _serve_root(root, steps, out)
    hier = _hier([("127.0.0.1", root.address[1])], groups=2, group_size=2,
                 fault_plan=FaultPlan(kill_agg_at={0: 2}), max_restarts=0)
    results: dict = {}
    try:
        ts = [_worker_thread(hier.addresses[g], [root.address], results,
                             f"w{g}{i}", group=g, seed=3 + 2 * g + i)
              for g in range(2) for i in range(2)]
        view = hier.serve(idle_timeout=TIMEOUT)
        _join_all([rt] + ts)
    finally:
        hier.close()
        root.close()
    assert "error" not in out, out
    _no_errors(results)
    hist = out["hist"]
    assert len(hist["losses"]) == steps
    fs = hist["fault_stats"]
    assert fs["direct_fallbacks"] == 2
    assert sorted(fs["groups"]["0"]["fallback_ranks"]) \
        == sorted(results[k]["direct_rank"] for k in ("w00", "w01"))
    for k in ("w00", "w01"):
        assert results[k]["stats"]["agg_failovers"] == 1
        assert results[k]["direct_rank"] is not None
    for k in ("w10", "w11"):
        assert results[k]["stats"]["agg_failovers"] == 0
        assert results[k]["direct_rank"] is None
    assert view["fault_stats"]["agg_restarts"] == 0
    assert "direct_fallbacks=2" in format_fault_stats(fs)


def test_failover_to_a_fleet_root_goes_through_a_router():
    """Group 0's worker fails over to a 2-shard fleet root as a
    `ShardRouter` carrying the fallback flag (group 1 forwards on): every
    shard books it once, and the fleet view sums the bookings."""
    steps = 30
    fleet = PSFleet(list(_params().items()), num_shards=2, quota=2,
                    quorum=1, fill_deadline=0.1, optim="sgd", lr=0.05,
                    momentum=0.5, device="cpu")
    fleet.compile_step(mlp_loss_fn)
    out: dict = {}

    def serve():
        try:
            out["hist"] = fleet.serve(steps=steps, idle_timeout=TIMEOUT)
        except BaseException as exc:  # noqa: BLE001 - asserted below
            out["error"] = exc

    rt = threading.Thread(target=serve, daemon=True)
    rt.start()
    hier = _hier(fleet.addresses, groups=2, group_size=1,
                 fault_plan=FaultPlan(kill_agg_at={0: 2}), max_restarts=0)
    results: dict = {}
    try:
        ts = [_worker_thread(hier.addresses[g], fleet.addresses, results,
                             f"w{g}", group=g, seed=3 + g)
              for g in range(2)]
        hier.serve(idle_timeout=TIMEOUT)
        _join_all([rt] + ts)
    finally:
        hier.close()
        fleet.close()
    assert "error" not in out, out
    _no_errors(results)
    fs = out["hist"]["fault_stats"]
    assert results["w0"]["stats"]["agg_failovers"] == 1
    assert fs["direct_fallbacks"] == 2  # one booking a shard
    assert fs["groups"]["0"]["fallback_ranks"] \
        == [results["w0"]["direct_rank"]]
    assert results["w1"]["stats"]["agg_failovers"] == 0


# ---------------------------------------------------------------------------
# The aggregator's bucketed forward (tests/test_bucket_stream.py:447)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("aggregate", ["mean", "trimmed_mean"])
def test_aggregator_bucketed_forward_counts_gradients(aggregate):
    steps = 4
    quorum = (dict(quorum=3, fill_deadline=0.2)
              if aggregate == "trimmed_mean" else {})
    root = _root(quota=1)
    out: dict = {}
    rt = _serve_root(root, steps, out)
    agg = LocalAggregator(list(_params().items()), group=0,
                          upstream=[("127.0.0.1", root.address[1])],
                          group_size=3, bucket_bytes=512,
                          aggregate=aggregate, device="cpu", **quorum)
    ah: dict = {}
    results: dict = {}
    try:
        agg.compile_reduce()
        assert agg._bucket_streamed and agg._bucket_plan.n_buckets >= 2

        def serve_group():
            try:
                ah["hist"] = agg.serve_group(idle_timeout=TIMEOUT)
            except BaseException as exc:  # noqa: BLE001
                ah["error"] = exc

        at = threading.Thread(target=serve_group, daemon=True)
        at.start()
        x, y = _teacher()
        ts = []
        for i in range(3):
            def go(i=i):
                w = AsyncPSWorker("127.0.0.1", agg.address[1], device="cpu")
                results[i] = w.run(mlp_loss_fn,
                                   dataset_batch_fn(x, y, 64, seed=i))
            th = threading.Thread(target=go, daemon=True)
            th.start()
            ts.append(th)
        _join_all([rt, at] + ts)
    finally:
        agg.close()
        root.close()
    assert "error" not in out, out
    assert "error" not in ah, ah
    hist = out["hist"]
    fs = hist["fault_stats"]
    assert len(hist["losses"]) == steps
    assert all(np.isfinite(hist["losses"]))
    # One assembled forward a fill: agg_frames counts gradients, never
    # the bucket frames they streamed as.
    assert fs["agg_frames"] == hist["grads_consumed"]
    assert fs["buckets_filled"] >= fs["agg_frames"] * 2
    assert fs["bucket_partial_timeouts"] == 0
