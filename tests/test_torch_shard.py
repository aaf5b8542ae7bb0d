"""The sharded PS fleet (`shard`: partition plans, `ShardRouter`,
`PSFleet`) against the JAX package's, on the CPU.

* Plans: for the same ordered ``(name, shape, dtype)`` list,
  `build_shard_plan`'s JSON and digest and `FleetManifest`'s JSON are byte
  for byte the JAX package's, with rules, without them and with a partial
  rule set; the port's ResNet-18 and CLI LM, handed over in the JAX tree's
  order (`utils.interop.jax_tree_order`) under their flax names, plan
  bitwise as the JAX models do; a manifest the JAX package wrote parses to
  the same fields.
* Frame heads: the PSA shard triple and SPLN of a port fleet are byte for
  byte a JAX fleet's for the same plan.
* Training: a lockstep MLP through a 2-shard fleet (quota 1 a shard, one
  router) matches the JAX `PSFleet` + `ShardRouter` within rtol 1e-6 /
  atol 2e-6, identity for 6 updates and blockq for 2.
* The cases of the JAX package's ``tests/test_shard.py`` (HELO-time
  refusals, the pinned fleet-wide identity, quorum per shard, kill and
  restore, no partial model, key parity, the CLI's refusals), run
  against the port.

Every fleet serves with an idle timeout, every thread is joined with a
timeout, and the fleets are the small MLP, a few updates each.
"""

import re
import threading
import time
from collections import OrderedDict

import ml_dtypes
import numpy as np
import pytest
import torch

import pytorch_ps_mpi_tpu.shard as jshard
import pytorch_ps_mpi_tpu_torch.shard as tshard
from pytorch_ps_mpi_tpu import train as jtrain
from pytorch_ps_mpi_tpu.async_ps import dataset_batch_fn as jbatch_fn
from pytorch_ps_mpi_tpu.models import mlp_loss_fn as jmlp_loss
from pytorch_ps_mpi_tpu_torch import train as ttrain
from pytorch_ps_mpi_tpu_torch.async_ps import AsyncPS, dataset_batch_fn
from pytorch_ps_mpi_tpu_torch.errors import FleetDeadError, ShardDeadError
from pytorch_ps_mpi_tpu_torch.models import init_mlp, mlp_loss_fn
from pytorch_ps_mpi_tpu_torch.multihost_async import AsyncPSWorker
from pytorch_ps_mpi_tpu_torch.shard import (PSFleet, ShardPlan, ShardRouter,
                                            build_shard_plan,
                                            match_partition_rules)
from pytorch_ps_mpi_tpu_torch.shard.fleet import shard_checkpoint_path
from pytorch_ps_mpi_tpu_torch.transport import frame_header, recv_exact
from pytorch_ps_mpi_tpu_torch.utils.faults import FaultPlan
from pytorch_ps_mpi_tpu_torch.utils.interop import flax_name, jax_tree_order
from pytorch_ps_mpi_tpu_torch.utils.timing import format_fault_stats

SIZES = (16, 32, 4)
TIMEOUT = 60  # every serve() and join in this file
CPU = ["--force-cpu-devices", "1"]
# The async PS's tolerance against the JAX package's jitted apply (XLA
# contracts multiply-adds).
APPLY_TOL = dict(rtol=1e-6, atol=2e-6)


def _teacher():
    rng = np.random.RandomState(7)
    x = rng.randn(256, 16).astype(np.float32)
    w = rng.randn(16, 4).astype(np.float32)
    y = (x @ w).argmax(1).astype(np.int32)
    return x, y


def _params(seed=0):
    return init_mlp(np.random.RandomState(seed), sizes=SIZES)


def _fleet(num_shards=2, quota=1, seed=0, **kw):
    kw.setdefault("momentum", 0.5)
    fleet = PSFleet(list(_params(seed).items()), num_shards=num_shards,
                    quota=quota, optim="sgd", lr=0.05, device="cpu", **kw)
    fleet.compile_step(mlp_loss_fn)
    return fleet


def _jax_fleet(num_shards=2, quota=1, seed=0, **kw):
    kw.setdefault("momentum", 0.5)
    fleet = jshard.PSFleet(list(_params(seed).items()),
                           num_shards=num_shards, quota=quota, optim="sgd",
                           lr=0.05, **kw)
    fleet.compile_step(jmlp_loss)
    return fleet


def _start_accept_loops(fleet):
    """The shards' accept loops without serve(): HELO, PSA and SPLN are
    connection-thread work."""
    for srv in fleet.servers:
        threading.Thread(target=srv._accept_loop, daemon=True).start()


def _lockstep_links(router):
    """Each link's pull repeats until its shard has applied the previous
    gradient (quota 1: sequential SGD through the fleet)."""
    for link in router.links:
        orig, last = link.pull, {"v": None}

        def pull(force=False, orig=orig, last=last):
            while True:
                got = orig(force)
                if (got is None or last["v"] is None
                        or got[0] > last["v"]):
                    if got is not None:
                        last["v"] = got[0]
                    return got
                time.sleep(0.001)

        link.pull = pull


def _router_thread(addresses, results, key, *, seed=3, lockstep=False,
                   **kw):
    x, y = _teacher()
    kw.setdefault("device", "cpu")

    def go():
        try:
            r = ShardRouter(addresses, **kw)
            if lockstep:
                _lockstep_links(r)
            pushed = r.run(mlp_loss_fn,
                           dataset_batch_fn(x, y, 64, seed=seed))
            results[key] = {"pushed": pushed, "rank": r.rank,
                            "reconnects": r.reconnects}
        except BaseException as exc:  # noqa: BLE001 - asserted below
            results[key] = {"error": exc}

    t = threading.Thread(target=go, daemon=True, name=f"router-{key}")
    t.start()
    return t


def _np(t):
    return (t.detach().to(torch.float32).numpy()
            if isinstance(t, torch.Tensor) else np.asarray(t))


# ---------------------------------------------------------------------------
# Plans and manifests: byte for byte the JAX package's
# ---------------------------------------------------------------------------

def _leaves(kind):
    """(port leaves, JAX leaves) of one ordered (name, shape, dtype) list:
    the MLP's, or a mixed list with bf16 and int8 leaves (a torch tensor
    in the port, an ml_dtypes array in the JAX package)."""
    if kind == "mlp":
        items = [(n, a.shape, np.float32) for n, a in _params().items()]
    else:
        items = [("enc/emb", (64, 16), "bf16"),
                 ("enc/w", (16, 16), np.float32), ("enc/b", (16,), np.float32),
                 ("dec/w", (16, 64), "bf16"), ("dec/q", (300,), np.int8),
                 ("head/bias", (64,), np.float32),
                 ("z/big", (1000,), np.float32), ("a/tiny", (1,), np.float32)]
    port, jax_ = [], []
    for n, shape, dt in items:
        if dt == "bf16":
            port.append((n, torch.zeros(shape, dtype=torch.bfloat16)))
            jax_.append((n, np.zeros(shape, ml_dtypes.bfloat16)))
        else:
            port.append((n, torch.zeros(shape, dtype=torch.from_numpy(
                np.zeros((), dt)).dtype)))
            jax_.append((n, np.zeros(shape, dt)))
    return port, jax_


RULE_SETS = {"none": None, "partial": [("bias", 0)],
             "full": [("w$|kernel$|emb$", 1), (".", 0)],
             "mixed": [("^dec/", 2), ("^enc/", 1)]}


@pytest.mark.parametrize("kind", ["mlp", "mixed"])
@pytest.mark.parametrize("rules", list(RULE_SETS))
@pytest.mark.parametrize("k", [2, 3])
def test_plan_json_and_digest_are_the_jax_packages(kind, rules, k):
    port, jax_ = _leaves(kind)
    k = min(k, len(port))
    rule_set = RULE_SETS[rules]
    if rule_set is not None and any(s >= k for _, s in rule_set):
        rule_set = [(p, s % k) for p, s in rule_set]
    try:
        want = jshard.build_shard_plan(jax_, k, rules=rule_set)
    except ValueError as exc:
        with pytest.raises(ValueError, match=re.escape(str(exc))):
            build_shard_plan(port, k, rules=rule_set)
        return
    got = build_shard_plan(port, k, rules=rule_set)
    assert got.to_json() == want.to_json()
    assert got.digest() == want.digest()
    assert got.describe() == want.describe()
    # The port plans numpy leaves (the fleet's MLP params) alike.
    assert build_shard_plan(jax_, k, rules=rule_set).to_json() \
        == want.to_json()
    # JSON round trip across the packages.
    assert ShardPlan.from_json(want.to_json()).digest() == want.digest()
    assert jshard.ShardPlan.from_json(got.to_json()).digest() \
        == got.digest()


def _resnet_pair():
    from pytorch_ps_mpi_tpu.models import build_model as jbuild
    from pytorch_ps_mpi_tpu.models import resnet18 as jresnet18
    from pytorch_ps_mpi_tpu_torch.models import build_model, resnet18

    named, _ = build_model(resnet18(num_classes=10, small_inputs=True),
                           seed=0)
    jnamed, _ = jbuild(jresnet18(num_classes=10, small_inputs=True),
                       (1, 32, 32, 3), seed=0)
    return named, jnamed


def _lm_pair():
    args = ttrain.make_parser().parse_args(["--model", "transformer"])
    return (ttrain._build_lm_async(args)[0],
            jtrain._build_lm_async(args)[0])


@pytest.mark.parametrize("model", ["resnet18", "lm"])
def test_port_models_plan_as_the_jax_models(model):
    """The port's ResNet-18 (62 leaves) and CLI LM (54), in the JAX tree's
    order under their flax names, plan bitwise as the JAX models'; rules
    written against either naming (``bias`` matches both) compose the
    same."""
    named, jnamed = _resnet_pair() if model == "resnet18" else _lm_pair()
    ordered = jax_tree_order(named)
    flax = [(flax_name(n, tuple(p.shape)), p) for n, p in ordered.items()]
    assert [n for n, _ in flax] == list(jnamed)
    for rules in (None, [("bias", 0)]):
        for k in (2, 4):
            got = build_shard_plan(flax, k, rules=rules)
            want = jshard.build_shard_plan(list(jnamed.items()), k,
                                           rules=rules)
            assert got.to_json() == want.to_json()
            assert got.digest() == want.digest()
            # Under its own names the port's plan splits the same leaves.
            own = build_shard_plan(list(ordered.items()), k, rules=rules)
            assert list(own.assignment.values()) \
                == list(want.assignment.values())
            assert own.sizes == want.sizes


def test_manifest_json_is_the_jax_packages(tmp_path):
    entries = [{"shard": k, "path": f"ck.shard{k}.psz", "step": 5,
                "sha256": f"{k:064x}"} for k in range(2)]
    kw = dict(plan_digest=0xDEADBEEF12345678, num_shards=2, cut=5,
              shards=entries)
    assert tshard.FleetManifest(**kw).to_json() \
        == jshard.FleetManifest(**kw).to_json()
    # A manifest the JAX fleet wrote parses to the same fields here.
    jfleet = _jax_fleet()
    try:
        jfleet.save_checkpoint(str(tmp_path / "ck.psz"), step=3)
    finally:
        jfleet.close()
    blob = (tmp_path / "ck.fleet.json").read_bytes()
    want = jshard.FleetManifest.from_json(blob)
    got = tshard.FleetManifest.from_json(blob)
    assert (got.plan_digest, got.num_shards, got.cut, got.shards) == (
        want.plan_digest, want.num_shards, want.cut, want.shards)
    assert got.skewed_entries() == want.skewed_entries() == []
    assert got.plan_digest == build_shard_plan(
        list(_params().items()), 2).digest()
    with pytest.raises(ValueError, match="format version"):
        tshard.FleetManifest.from_json(b'{"format_version": 2}')


# ---------------------------------------------------------------------------
# Partition plans (the JAX package's unit cases)
# ---------------------------------------------------------------------------

def test_match_partition_rules_first_match_wins_and_validates_range():
    names = ["enc/w", "enc/b", "dec/w"]
    out = match_partition_rules([("w$", 1), ("enc", 0)], names, 2)
    assert out == {"enc/w": 1, "enc/b": 0, "dec/w": 1}
    assert match_partition_rules([("nope", 0)], names, 2) \
        == {n: None for n in names}
    with pytest.raises(ValueError, match="out of range"):
        match_partition_rules([("w$", 5)], names, 2)


def test_build_shard_plan_greedy_balances_and_validates():
    params = [(f"p{i}", torch.zeros(s))
              for i, s in enumerate([512, 256, 256, 64, 32, 16])]
    plan = build_shard_plan(params, 2)
    assert max(plan.sizes) <= 2 * min(plan.sizes)
    assert list(plan.assignment) == [n for n, _ in params]
    assert build_shard_plan(params, 2).digest() == plan.digest()
    ruled = build_shard_plan(
        [("a/w", torch.zeros(100)), ("a/b", torch.zeros(100)),
         ("z/big", torch.zeros(1000))], 2, rules=[("^a/", 1)])
    assert [ruled.shard_of(n) for n in ("a/w", "a/b", "z/big")] == [1, 1, 0]
    mlp = list(_params().items())
    with pytest.raises(ValueError, match="exceeds the"):
        build_shard_plan(mlp, len(mlp) + 1)
    with pytest.raises(ValueError, match="own no parameters"):
        ShardPlan(num_shards=2,
                  assignment=OrderedDict((n, 0) for n, _ in mlp))
    with pytest.raises(ValueError, match="out of range"):
        ShardPlan(num_shards=2, assignment=OrderedDict([("w", 7)]))
    other = build_shard_plan(mlp, 2, rules=[("bias", 0)])
    assert other.digest() != build_shard_plan(mlp, 2).digest()


def test_shard_checkpoint_path_and_fault_plan_shard_view():
    from pytorch_ps_mpi_tpu.shard.fleet import \
        shard_checkpoint_path as jpath

    for base, k in (("ckpt.psz", 3), ("/tmp/a/ckpt.psz", 0)):
        assert shard_checkpoint_path(base, k) == jpath(base, k)
    assert tshard.fleet_manifest_path("/x/ck.psz") \
        == jshard.fleet_manifest_path("/x/ck.psz") == "/x/ck.fleet.json"
    plan = FaultPlan(seed=3, kill_shard_at={1: 4}, slow_rank=0,
                     slow_delay_s=0.1)
    assert FaultPlan.from_json(plan.to_json()) == plan
    v1 = plan.shard_view(1)
    assert v1.kill_ps_at == 4 and v1.kill_shard_at == {}
    assert v1.slow_rank == 0
    assert plan.shard_view(0).kill_ps_at is None


# ---------------------------------------------------------------------------
# Frame heads: a port fleet answers as a JAX fleet does
# ---------------------------------------------------------------------------

class _Raw:
    def __init__(self, port):
        self.sock = socket_connect(port)

    def send(self, payload):
        self.sock.sendall(frame_header(payload) + payload)

    def recv(self):
        head = recv_exact(self.sock, 8)
        return head + recv_exact(self.sock, int.from_bytes(head[:4],
                                                           "little"))

    def close(self):
        self.sock.close()


def socket_connect(port):
    import socket

    return socket.create_connection(("127.0.0.1", port), timeout=10)


def test_psa_shard_triple_and_spln_match_a_jax_fleet():
    """HELO to each shard, a second HELO with flag 2 (the fleet-wide rank
    from shard 0), then SPLN: every reply byte for byte a JAX fleet's for
    the same plan (the same MLP)."""
    fleets = [_fleet(), _jax_fleet()]
    try:
        assert fleets[0].plan.to_json() == fleets[1].plan.to_json()
        replies = []
        for fleet in fleets:
            _start_accept_loops(fleet)
            out = []
            for k, (_, port) in enumerate(fleet.addresses):
                c = _Raw(port)
                c.send(b"HELO\x00" if k == 0
                       else b"HELO\x02" + (0).to_bytes(4, "little"))
                out.append(c.recv())
                c.send(b"SPLN")
                out.append(c.recv())
                c.close()
            replies.append(out)
        assert replies[0] == replies[1]
        # shard k of 2, the plan's digest, the plan's JSON.
        digest = fleets[0].plan.digest()
        for k in range(2):
            psa = replies[0][2 * k][8:]
            assert psa[:3] == b"PSA"
            assert int.from_bytes(psa[9:11], "little") == k
            assert int.from_bytes(psa[11:13], "little") == 2
            assert int.from_bytes(psa[13:21], "little") == digest
            assert replies[0][2 * k + 1][8:] \
                == b"SPLN" + fleets[0].plan.to_json().encode()
    finally:
        for fleet in fleets:
            fleet.close()


# ---------------------------------------------------------------------------
# Training: the lockstep 2-shard fleet against the JAX fleet
# ---------------------------------------------------------------------------

def _lockstep_run(pkg, code, updates):
    x, y = _teacher()
    if pkg == "port":
        fleet = _fleet(code=code, momentum=0.9)
        router_cls, batch_fn, loss = ShardRouter, dataset_batch_fn, \
            mlp_loss_fn
        kw = dict(device="cpu")
    else:
        fleet = _jax_fleet(code=code, momentum=0.9)
        router_cls, batch_fn, loss = jshard.ShardRouter, jbatch_fn, \
            jmlp_loss
        kw = {}
    box = {}

    def go():
        try:
            r = router_cls(fleet.addresses, code=code, reconnect_retries=1,
                           **kw)
            _lockstep_links(r)
            box["pushed"] = r.run(loss, batch_fn(x, y, 32, seed=4))
        except BaseException as exc:  # noqa: BLE001 - asserted below
            box["error"] = exc

    t = threading.Thread(target=go, daemon=True)
    t.start()
    try:
        hist = fleet.serve(steps=updates, idle_timeout=TIMEOUT)
        t.join(TIMEOUT)
    finally:
        fleet.close()
    assert not t.is_alive() and "error" not in box, box.get("error")
    params = {n: _np(p) for srv in fleet.servers
              for n, p in srv.params.items()}
    return hist, params


@pytest.mark.parametrize("code,updates", [("identity", 6), ("blockq", 2)])
def test_lockstep_two_shard_fleet_matches_the_jax_fleet(code, updates):
    th, tparams = _lockstep_run("port", code, updates)
    jh, jparams = _lockstep_run("jax", code, updates)
    for k in range(2):
        ts, js = th["per_shard"][k], jh["per_shard"][k]
        assert ts["versions"] == js["versions"] == list(
            range(1, updates + 1))
        assert ts["staleness"] == [0.0] * updates
        np.testing.assert_allclose(ts["losses"], js["losses"], **APPLY_TOL)
    assert set(tparams) == set(jparams)
    for n in jparams:
        np.testing.assert_allclose(tparams[n], jparams[n], err_msg=n,
                                   **APPLY_TOL)


# ---------------------------------------------------------------------------
# HELO-time agreement (tests/test_shard.py:174-215)
# ---------------------------------------------------------------------------

def test_plain_worker_refuses_fleet_shard():
    fleet = _fleet(num_shards=2)
    _start_accept_loops(fleet)
    try:
        with pytest.raises(ValueError, match="2-shard PS fleet"):
            AsyncPSWorker("127.0.0.1", fleet.addresses[0][1], device="cpu")
    finally:
        fleet.close()


def test_router_refuses_swapped_endpoints_and_wrong_count():
    fleet = _fleet(num_shards=2)
    _start_accept_loops(fleet)
    try:
        with pytest.raises(ValueError, match="endpoint order mismatch"):
            ShardRouter(list(reversed(fleet.addresses)), device="cpu")
        with pytest.raises(ValueError, match="every shard exactly once"):
            ShardRouter(fleet.addresses[:1], device="cpu")
    finally:
        fleet.close()


def test_router_refuses_plan_digest_mismatch_across_fleets():
    fleet_a = _fleet(num_shards=2)
    fleet_b = _fleet(num_shards=2, rules=[("bias", 0)])
    _start_accept_loops(fleet_a)
    _start_accept_loops(fleet_b)
    try:
        mixed = [fleet_a.addresses[0], fleet_b.addresses[1]]
        with pytest.raises(ValueError, match="digest mismatch"):
            ShardRouter(mixed, device="cpu")
    finally:
        fleet_a.close()
        fleet_b.close()


# ---------------------------------------------------------------------------
# The fleet trains; one identity fleet-wide (tests/test_shard.py:217, 250)
# ---------------------------------------------------------------------------

def test_fleet_trains_with_router_workers_and_pinned_identity():
    """Two lockstep routers (each pulls until its last gradient was
    applied), quota 2: every update takes one gradient of each, so each
    pushes at least ``steps`` whatever the threads' scheduling."""
    steps = 8
    fleet = _fleet(num_shards=2, quota=2)
    results = {}
    ts = [_router_thread(fleet.addresses, results, f"w{i}", seed=3 + i,
                         lockstep=True)
          for i in range(2)]
    try:
        hist = fleet.serve(steps=steps, idle_timeout=TIMEOUT)
    finally:
        for t in ts:
            t.join(TIMEOUT)
        fleet.close()
    for key in ("w0", "w1"):
        assert "error" not in results[key], results[key]
        assert results[key]["pushed"] >= steps
        assert results[key]["reconnects"] == 0
    assert sorted(results[k]["rank"] for k in results) == [0, 1]
    fs = hist["fault_stats"]
    for k in ("0", "1"):
        assert fs["shards"][k]["live_ranks"] == [0, 1]
        assert fs["shards"][k]["workers_seen"] == 2
        assert fs["shards"][k]["reconnects"] == 0  # assigned != reconnect
    for shard_hist in hist["per_shard"]:
        assert len(shard_hist["losses"]) == steps
        assert shard_hist["versions"][-1] == steps
        assert all(np.isfinite(shard_hist["losses"]))
    assert hist["updates_total"] == 2 * steps
    assert isinstance(format_fault_stats(fs), str)


def test_fleet_composes_quorum_per_shard_with_straggler():
    steps = 6
    plan = FaultPlan(slow_rank=1, slow_delay_s=0.3)
    fleet = _fleet(num_shards=2, quota=2, quorum=1, fill_deadline=0.005)
    results = {}
    ts = [_router_thread(fleet.addresses, results, f"w{i}", seed=3 + i,
                         fault_plan=plan)
          for i in range(2)]
    try:
        hist = fleet.serve(steps=steps, idle_timeout=TIMEOUT)
    finally:
        for t in ts:
            t.join(TIMEOUT)
        fleet.close()
    for key in results:
        assert "error" not in results[key], results[key]
    assert hist["fault_stats"]["quorum_fills"] >= 1
    assert hist["updates_total"] == 2 * steps


# ---------------------------------------------------------------------------
# kill_shard_at (tests/test_shard.py:278, 311, 332)
# ---------------------------------------------------------------------------

def test_kill_shard_crash_resume_workers_reconnect(tmp_path):
    steps = 10
    ckpt = tmp_path / "fleet.psz"
    fleet = _fleet(num_shards=2, quota=1,
                   fault_plan=FaultPlan(kill_shard_at={1: 4}))
    results = {}
    t = _router_thread(fleet.addresses, results, "w0",
                       reconnect_retries=20, backoff_base=0.05,
                       backoff_max=0.5)
    try:
        hist = fleet.serve(steps=steps, idle_timeout=TIMEOUT,
                           checkpoint_path=str(ckpt), checkpoint_every=2)
    finally:
        t.join(TIMEOUT)
        fleet.close()
    assert not t.is_alive()
    assert "error" not in results["w0"], results["w0"]
    fs = hist["fault_stats"]
    assert fs["shard_restores"] == 1
    assert "shard_restores=1" in format_fault_stats(fs)
    assert results["w0"]["reconnects"] >= 1
    assert fs["reconnects"] >= 1
    assert len(hist["per_shard"][0]["losses"]) == steps
    assert len(hist["per_shard"][1]["losses"]) == steps - 4
    names = {p.name for p in tmp_path.iterdir()}
    assert {"fleet.shard0.psz", "fleet.shard1.psz"} <= names
    for srv in fleet.servers:
        for n, p in srv.params.items():
            assert torch.isfinite(p).all(), n


@pytest.mark.parametrize("ckpt_mode", ["none", "path_but_every_0"])
def test_kill_shard_without_live_checkpointing_fails_loudly(tmp_path,
                                                            ckpt_mode):
    fleet = _fleet(num_shards=2, quota=1,
                   fault_plan=FaultPlan(kill_shard_at={0: 1}))
    results = {}
    t = _router_thread(fleet.addresses, results, "w0",
                       reconnect_retries=2, backoff_base=0.05,
                       backoff_max=0.2)
    serve_kw = {} if ckpt_mode == "none" else {
        "checkpoint_path": str(tmp_path / "f.psz")}
    try:
        with pytest.raises(ShardDeadError, match="cannot be restored"):
            fleet.serve(steps=6, idle_timeout=5.0, **serve_kw)
    finally:
        fleet.close()
        t.join(TIMEOUT)
    assert not t.is_alive()


def test_router_refuses_to_train_partial_model():
    fleet = _fleet(num_shards=2, quota=1)
    results = {}
    x, y = _teacher()

    def go():
        try:
            r = ShardRouter(fleet.addresses, device="cpu",
                            reconnect_retries=2, backoff_base=0.02,
                            backoff_max=0.1)
            inner = dataset_batch_fn(x, y, 64, seed=3)

            def batch_fn(rank, it):
                time.sleep(0.05)  # keep the run alive past the close
                return inner(rank, it)

            results["out"] = r.run(mlp_loss_fn, batch_fn)
        except BaseException as exc:  # noqa: BLE001 - asserted below
            results["error"] = exc

    t = threading.Thread(target=go, daemon=True)
    serve = [threading.Thread(
        target=lambda k=k: fleet._serve_shard(k, 200,
                                              dict(idle_timeout=30.0)),
        daemon=True) for k in range(2)]
    for s in serve:
        s.start()
    t.start()
    time.sleep(1.0)
    # Die like a crash: pending PULLs vanish with no DONE.
    fleet.servers[1]._dying = True
    fleet.servers[1].close()
    t.join(TIMEOUT)
    assert not t.is_alive()
    fleet.close()
    for s in serve:
        s.join(30)
    assert isinstance(results.get("error"), FleetDeadError), results
    assert "partial model" in str(results["error"])


# ---------------------------------------------------------------------------
# Key parity and render coverage; the CLI (tests/test_shard.py:388, 473,
# 510)
# ---------------------------------------------------------------------------

def test_fleet_snapshot_key_parity_and_render_coverage():
    inproc = AsyncPS([("w", torch.zeros(2))], quota=1,
                     devices=[torch.device("cpu")])
    fleet = _fleet(num_shards=2)
    jfleet = _jax_fleet(num_shards=2)
    try:
        base_keys = set(inproc._base_fault_snapshot())
        for srv in fleet.servers:
            assert base_keys <= set(srv._fault_stats_snapshot())
        agg = fleet.fleet_fault_stats()
        jagg = jfleet.fleet_fault_stats()
        assert set(agg["shards"]) == {"0", "1"}
        # The fleet view's keys are the JAX fleet's, the hierarchy's
        # counters included.
        assert set(agg) == set(jagg)
        counter_keys = set(fleet.fault_stats)
        for srv in fleet.servers:
            counter_keys |= set(srv.fault_stats)
        for key, value in agg.items():
            if key in counter_keys and isinstance(value, int):
                assert format_fault_stats({key: 1}) != "clean", key
    finally:
        fleet.close()
        jfleet.close()


SHARD_CLI_REFUSALS = [
    ["--model", "mlp", "--serve", "0", "--shards", "0"],
    ["--model", "mlp", "--shards", "2"],
    ["--model", "mlp", "--async-ps", "--shards", "2"],
    ["--model", "mlp", "--connect", "127.0.0.1:1", "--partition-rules",
     "[]"],
    ["--model", "mlp", "--serve", "0", "--partition-rules", "[]"],
    ["--model", "mlp", "--serve", "0", "--chaos",
     FaultPlan(kill_shard_at={0: 3}).to_json()],
    ["--model", "mlp", "--connect", "127.0.0.1:1", "--chaos",
     FaultPlan(kill_shard_at={0: 3}).to_json()],
    ["--model", "mlp", "--serve", "0", "--shards", "2", "--chaos",
     FaultPlan(kill_ps_at=3).to_json()],
    ["--model", "mlp", "--connect", "127.0.0.1:1,127.0.0.1:2",
     "--async-bucket-bytes", "0"],
    ["--model", "mlp", "--connect", "127.0.0.1:1", "--shards", "2",
     "--async-bucket-bytes", "0"],
]


@pytest.mark.parametrize("argv", SHARD_CLI_REFUSALS,
                         ids=[" ".join(a[2:5]) for a in SHARD_CLI_REFUSALS])
def test_cli_refuses_misplaced_shard_flags(argv):
    msgs = []
    for run in (lambda a: jtrain.main(a + ["--n-devices", "1"]),
                lambda a: ttrain.main(a + CPU)):
        with pytest.raises(SystemExit) as e:
            run(argv + ["--steps", "1"])
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]
    assert "not ported" not in msgs[1]


def test_cli_refuses_partition_rules_that_are_not_json():
    with pytest.raises(SystemExit, match="not valid JSON"):
        ttrain.main(["--model", "mlp", "--serve", "0", "--shards", "2",
                     "--partition-rules", "{oops", "--steps", "1"] + CPU)


def test_fleet_entry_points_default_to_the_card():
    """No ``device``: the fleet's shards and its router take the card, and
    raise where there is none (no fall back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible here")
    from pytorch_ps_mpi_tpu_torch import PSRuntimeError

    with pytest.raises(PSRuntimeError, match="no CUDA device"):
        PSFleet(list(_params().items()), num_shards=2, quota=1, lr=0.05)
    fleet = _fleet()
    _start_accept_loops(fleet)
    try:
        with pytest.raises(PSRuntimeError, match="no CUDA device"):
            ShardRouter(fleet.addresses)
    finally:
        fleet.close()


def test_fleet_refuses_ambiguous_kill_ps_at():
    with pytest.raises(ValueError, match="kill_ps_at is ambiguous"):
        _fleet(num_shards=2, fault_plan=FaultPlan(kill_ps_at=3))
