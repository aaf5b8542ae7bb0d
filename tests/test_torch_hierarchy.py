"""The hierarchy's pieces (`shard.hierarchy`, the AGGR frame, HELO flags
8/16, contributor weighting) against the JAX package's, on the CPU.

* Frame heads: a port link's HELO with the aggregator flag (8, with an
  assigned rank) or the direct-fallback flag (16), and the heads of its
  AGGR frames, whole-tree and bucketed, are byte for byte a JAX link's
  for the same values (the tree payloads differ: ``PSTP`` against
  ``PST2``).
* The root's contribution weights (staleness, scoreboard, latency, then
  the contributor multiplicity) are bitwise the JAX package's.
* The group reduce: the same stacked codes through the port's
  `LocalAggregator._reduce` and the JAX aggregator's ``_reduce_fn`` run
  under ``jax.disable_jit()`` (XLA's CPU compiler takes blockq's scale one
  ulp off the eager value, so the jitted program is not the reference).
  The re-encoded codes are bitwise equal for the mean under identity and
  blockq; trimmed_mean, median and norm_clip agree within the robust
  reducers' tolerances (`tests/test_torch_robust.py`), decoded.  The
  per-bucket reduce composes bitwise to the whole-tree one.
* The scale contract: one mean frame weighted by 4 moves the root as four
  raw gradients do, in both packages.
* The relay's version, the counters' keys and rendering, the reducer/codec
  gate, the adaptive group deadline and the aggregator fault plan.

Every server is closed in a ``finally``; nothing here serves a fill.
"""

import socket
import struct
import threading
import time
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_ps_mpi_tpu.multihost_async as jma
import pytorch_ps_mpi_tpu.shard as jshard
import pytorch_ps_mpi_tpu_torch.multihost_async as tma
from pytorch_ps_mpi_tpu.async_ps import AsyncPS as JAsyncPS
from pytorch_ps_mpi_tpu.ops import codecs as jcodecs
from pytorch_ps_mpi_tpu.ops import robust as jrobust
from pytorch_ps_mpi_tpu.parallel.overlap import merge_buckets as jmerge
from pytorch_ps_mpi_tpu.parallel.overlap import split_tree as jsplit
from pytorch_ps_mpi_tpu.utils.faults import FaultPlan as JFaultPlan
from pytorch_ps_mpi_tpu.utils.timing import \
    format_fault_stats as jformat_fault_stats
from pytorch_ps_mpi_tpu_torch import shard as tshard
from pytorch_ps_mpi_tpu_torch.async_ps import AsyncPS
from pytorch_ps_mpi_tpu_torch.ops import codecs as tcodecs
from pytorch_ps_mpi_tpu_torch.ops import robust as trobust
from pytorch_ps_mpi_tpu_torch.parallel.overlap import merge_buckets, split_tree
from pytorch_ps_mpi_tpu_torch.transport import frame_header, recv_exact
from pytorch_ps_mpi_tpu_torch.utils.faults import FaultPlan
from pytorch_ps_mpi_tpu_torch.utils.timing import format_fault_stats

# A tree no `utils.interop.jax_order` rule permutes: the codes are laid
# out alike in both packages.  Leaves of several blockq tile heights.
SHAPES = OrderedDict([("enc/w", (64, 40)), ("enc/b", (40,)),
                      ("head/w", (1000,)), ("head/b", (3,))])
APPLY_TOL = dict(rtol=1e-6, atol=2e-6)
SUM_TOL = {"trimmed_mean": dict(rtol=1e-6, atol=1e-6),
           "median": dict(rtol=1e-6, atol=1e-6),
           "norm_clip": dict(rtol=1e-5, atol=1e-6)}
# The AGGR head: kind, (group, n_contrib, target), (bucket, n_buckets),
# seq, version, loss.
AGGR_HEAD = 4 + 6 + 4 + 8 + 8 + 8


def _named(seed=0):
    rng = np.random.RandomState(seed)
    return [(n, (0.1 * rng.randn(*s)).astype(np.float32))
            for n, s in SHAPES.items()]


def _grads(n, seed):
    rng = np.random.RandomState(seed)
    return [OrderedDict((k, rng.randn(*s).astype(np.float32))
                        for k, s in SHAPES.items()) for _ in range(n)]


# ---------------------------------------------------------------------------
# Frame heads: byte for byte the JAX package's
# ---------------------------------------------------------------------------

def _recording_server():
    """A listener that answers the first HELO with a PSA both packages'
    workers accept (segmented wire, 8 credits, identity) and records every
    frame payload it receives until the peer closes."""
    lst = socket.create_server(("127.0.0.1", 0))
    frames: list = []

    def serve():
        conn, _ = lst.accept()
        conn.settimeout(20)
        with conn:
            try:
                while True:
                    n = struct.unpack("<II", recv_exact(conn, 8))[0]
                    payload = recv_exact(conn, n)
                    frames.append(payload)
                    if payload[:4] == b"HELO":
                        psa = (b"PSA" + bytes([12]) + struct.pack("<I", 7)
                               + b"\x00" + struct.pack("<HHQ", 0, 1, 0)
                               + struct.pack("<I", 8) + b"\x01identity")
                        conn.sendall(frame_header(psa) + psa)
            except (ConnectionError, OSError):
                pass
        lst.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return lst.getsockname()[1], frames, t


def _talk(pkg, kind):
    port, frames, t = _recording_server()
    if pkg == "port":
        mk = lambda **kw: tma.AsyncPSWorker(  # noqa: E731
            "127.0.0.1", port, device="cpu", **kw)
    else:
        mk = lambda **kw: jma.AsyncPSWorker(  # noqa: E731
            "127.0.0.1", port, **kw)
    tree = OrderedDict((n, np.full(s, 0.5, np.float32))
                       for n, s in SHAPES.items())
    if kind == "fallback":
        w = mk(fallback_group=5)
    else:
        w = mk(agg_group=2, agg_target=3, assigned_rank=9)
        w._push_seq = 41
        if kind == "whole":
            w.push_agg(tree, 17, 1.25, group=2, n_contrib=3, target=3)
        else:
            subs = [OrderedDict([(n, tree[n])]) for n in SHAPES]
            w.push_agg_buckets(iter([subs[:2], subs[2:]]), len(subs), 18,
                               0.5, group=2, n_contrib=2, target=3)
    w.close()
    t.join(20)
    assert not t.is_alive()
    return frames


@pytest.mark.parametrize("kind", ["whole", "bucketed", "fallback"])
def test_aggr_and_helo_frame_heads_equal_jax(kind):
    tf, jf = _talk("port", kind), _talk("jax", kind)
    assert tf[0] == jf[0]  # the HELO, flags and fields
    if kind == "fallback":
        assert tf[0] == b"HELO" + bytes([16]) + struct.pack("<H", 5)
        return
    assert tf[0] == (b"HELO" + bytes([2 | 8]) + struct.pack("<I", 9)
                     + struct.pack("<HH", 2, 3))
    data = [f for f in tf[1:] if f[:4] == b"AGGR"]
    jdata = [f for f in jf[1:] if f[:4] == b"AGGR"]
    n = 1 if kind == "whole" else len(SHAPES)
    assert len(data) == len(jdata) == n
    for a, b in zip(data, jdata):
        assert a[:AGGR_HEAD] == b[:AGGR_HEAD]
    head = data[-1][:AGGR_HEAD]
    assert struct.unpack("<HHH", head[4:10]) == (
        (2, 3, 3) if kind == "whole" else (2, 2, 3))
    assert struct.unpack("<HH", head[10:14]) == (
        (0, 1) if kind == "whole" else (n - 1, n))
    assert struct.unpack("<Q", head[14:22])[0] == 41


# ---------------------------------------------------------------------------
# The root's contribution weights: bitwise the JAX package's
# ---------------------------------------------------------------------------

def _pair_ps(**kw):
    t = AsyncPS([("w", torch.zeros(2))], quota=1,
                devices=[torch.device("cpu")], **kw)
    j = JAsyncPS([("w", jnp.zeros((2,), jnp.float32))], quota=1, **kw)
    return t, j


@pytest.mark.parametrize("opts", [
    dict(), dict(staleness_weighting=True),
    dict(staleness_weighting=True, latency_weighting=True),
    dict(staleness_weighting=True, anomaly_z=3.0, latency_weighting=True),
], ids=["plain", "staleness", "latency", "scoreboard"])
def test_root_contribution_weights_are_bitwise_jax(opts):
    topt, jopt = _pair_ps(**opts)
    rng = np.random.RandomState(2)
    # The same latency history (rank 3 settles slow) and scoreboard
    # observations (rank 2 breaches) on both sides.
    t = 100.0
    for i in range(12):
        for r in range(4):
            if r != 3 or i < 6 or i % 3 == 0:
                topt._latency.observe(r, t)
                jopt._latency.observe(r, t)
        t += 0.01
    if topt._scoreboard is not None:
        for i in range(40):
            for r in range(4):
                norm = float(rng.uniform(0.9, 1.1)) * (50.0 if r == 2
                                                        and i > 30 else 1.0)
                topt._scoreboard.observe(r, norm)
                jopt._scoreboard.observe(r, norm)
    cases = [([0, 1, 3, 2], [0, 1, 2, 3], [4.0, 1.0, 2.0, 3.0]),
             ([2, 0, 0, 5], [3, 1, 0, 2], [1.0, 1.0, 1.0, 1.0]),
             ([1, 1, 0, 0], [0, 1, 2, 3], None)]
    for stale, ranks, contribs in cases:
        got = topt._contrib_weights(stale, ranks, contribs)
        want = jopt._contrib_weights(stale, ranks, contribs)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want), (got, want)
    assert topt.fault_stats["latency_weighted"] \
        == jopt.fault_stats["latency_weighted"]


def test_contrib_multiplicity_scales_weights():
    topt, _ = _pair_ps()
    w = topt._contrib_weights([0, 0], [0, 1], contribs=[4.0, 1.0])
    assert list(w) == [4.0, 1.0]
    # All-ones multiplicities are the no-op path.
    assert np.all(topt._contrib_weights([0], [0], contribs=[1.0]) == 1.0)


# ---------------------------------------------------------------------------
# The group reduce against the JAX aggregator's, under jax.disable_jit()
# ---------------------------------------------------------------------------

class _Pair:
    """A port and a JAX `LocalAggregator` over the same tree, each dialed
    into an accepting root of its own package."""

    def __init__(self, code="identity", group_size=4, **kw):
        self.troot = tma.AsyncSGDServer(_named(), quota=1, code=code,
                                        device="cpu")
        self.jroot = jma.AsyncSGDServer(_named(), quota=1, code=code)
        for srv in (self.troot, self.jroot):
            threading.Thread(target=srv._accept_loop, daemon=True).start()
        self.tagg = self.jagg = None
        self.tagg = tshard.LocalAggregator(
            _named(), group=0, upstream=[("127.0.0.1",
                                          self.troot.address[1])],
            group_size=group_size, code=code, device="cpu", **kw)
        self.jagg = jshard.LocalAggregator(
            _named(), group=0, upstream=[("127.0.0.1",
                                          self.jroot.address[1])],
            group_size=group_size, code=code, **kw)
        self.tagg.compile_reduce()
        self.jagg.compile_reduce()
        assert self.tagg._orders == {}

    def close(self):
        for s in (self.tagg, self.jagg, self.troot, self.jroot):
            if s is not None:
                s.close()


def _stacks(code, grads):
    """The stacked codes of ``grads`` for both packages: every
    contribution encoded by the JAX codec (the port's codes are bitwise
    equal), a leading contributor dim on each leaf."""
    jcode = jcodecs.get_codec(code)
    codes = [OrderedDict((n, jax.tree.map(np.asarray,
                                          jcode.encode(jnp.asarray(g[n]))))
                         for n in SHAPES) for g in grads]
    jstacked = jax.tree.map(lambda *xs: jnp.stack(
        [jnp.asarray(x) for x in xs]), *codes)
    tstacked = OrderedDict(
        (n, jax.tree.map(lambda *xs: torch.from_numpy(np.stack(xs)),
                         *[c[n] for c in codes]))
        for n in SHAPES)
    return tstacked, jstacked


def _host(tree):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in (tree.items() if isinstance(tree, dict)
                         else [("x", tree)])}


@pytest.mark.parametrize("code", ["identity", "blockq"])
@pytest.mark.parametrize("weighted", [False, True])
def test_mean_reduce_codes_are_bitwise_jax(code, weighted):
    pair = _Pair(code)
    try:
        grads = _grads(4, seed=11)
        tstacked, jstacked = _stacks(code, grads)
        w = (np.asarray([1.0, 0.5, 0.25, 2.0], np.float32) if weighted
             else np.ones(4, np.float32))
        got, _ = pair.tagg._reduce(tstacked, w)
        with jax.disable_jit():
            want, _ = pair.jagg._reduce_fn(jstacked, jnp.asarray(w),
                                           jnp.float32(float("nan")))
        assert not pair.tagg._itemwise and not pair.jagg._itemwise
        for n in SHAPES:
            g, j = _host(got[n]), _host(want[n])
            assert set(g) == set(j)
            for k in j:
                assert g[k].dtype == j[k].dtype, (n, k)
                assert np.array_equal(g[k], j[k]), (n, k)
    finally:
        pair.close()


@pytest.mark.parametrize("code", ["identity", "blockq"])
@pytest.mark.parametrize("aggregate", ["trimmed_mean", "median",
                                       "norm_clip"])
def test_robust_reduce_codes_match_jax(code, aggregate):
    """The itemwise path (every contribution decoded, `robust_reduce` at
    ``n_target=1``): identity within the reducers' tolerance; blockq
    decoded, within the tolerance plus one quantum of the tile's scale
    (a value on a rounding edge may land one code apart)."""
    pair = _Pair(code, aggregate=aggregate)
    try:
        grads = _grads(5, seed=13)
        grads[3] = OrderedDict((n, 40.0 * g) for n, g in grads[3].items())
        tstacked, jstacked = _stacks(code, grads)
        w = np.asarray([1.0, 0.5, 1.0, 0.8, 1.0], np.float32)
        for clip in (float("nan"), 3.0):
            got, tinfo = pair.tagg._reduce(tstacked, w, clip)
            with jax.disable_jit():
                want, jinfo = pair.jagg._reduce_fn(
                    jstacked, jnp.asarray(w), jnp.float32(clip))
            assert int(tinfo["clipped"]) == int(jinfo["clipped"])
            np.testing.assert_allclose(tinfo["contrib_norms"].numpy(),
                                       np.asarray(jinfo["contrib_norms"]),
                                       rtol=1e-6)
            tcode, jcode = tcodecs.get_codec(code), jcodecs.get_codec(code)
            for n, shape in SHAPES.items():
                g = tcode.decode(got[n], shape=shape,
                                 dtype=torch.float32).numpy()
                j = np.asarray(jcode.decode(want[n], shape=shape,
                                            dtype=jnp.float32))
                tol = dict(SUM_TOL[aggregate])
                if code == "blockq":
                    tol["atol"] += float(np.max(np.asarray(
                        want[n]["scales"])))
                np.testing.assert_allclose(g, j, err_msg=n, **tol)
    finally:
        pair.close()


@pytest.mark.parametrize("aggregate", ["mean", "trimmed_mean", "median"])
def test_per_bucket_reduce_equals_whole_tree(aggregate):
    """The coordinate-wise reducers compose per bucket: split -> reduce
    each -> merge is the whole-tree reduce, bitwise, in the port as in the
    JAX package (and the two agree)."""
    pair = _Pair("blockq", group_size=3, aggregate=aggregate,
                 bucket_bytes=4096)
    try:
        assert pair.tagg._bucket_streamed
        assert pair.jagg._reduce_bucket_fn is not None
        assert pair.tagg._bucket_plan.buckets \
            == pair.jagg._bucket_plan.buckets
        tstacked, jstacked = _stacks("blockq", _grads(3, seed=17))
        w = np.asarray([1.0, 0.5, 0.75], np.float32)
        whole, _ = pair.tagg._reduce(tstacked, w)
        merged = merge_buckets(
            [pair.tagg._reduce(sub, w, whole=False)[0]
             for sub in split_tree(tstacked, pair.tagg._bucket_plan)],
            list(SHAPES))
        with jax.disable_jit():
            jmerged = jmerge(
                [pair.jagg._reduce_bucket_fn(sub, jnp.asarray(w))
                 for sub in jsplit(jstacked, pair.jagg._bucket_plan)],
                list(SHAPES))
        for n in SHAPES:
            for k in ("q", "scales"):
                a = whole[n][k].numpy()
                assert np.array_equal(a, merged[n][k].numpy()), (n, k)
                if aggregate == "mean":
                    assert np.array_equal(a, np.asarray(jmerged[n][k]))
    finally:
        pair.close()
    # norm_clip and anomaly scoring are not coordinate-wise.
    for agg, z in (("norm_clip", None), ("mean", 3.0)):
        assert trobust.bucket_streamable(agg, anomaly_scoring=z is not None) \
            is jrobust.bucket_streamable(agg, anomaly_scoring=z is not None) \
            is False


def test_agg_reduce_and_contrib_weight_recover_flat_sum():
    """The scale contract: the aggregator's reduce is the per-contributor
    mean of its fill (identity: codes are gradients), and a root applying
    that one frame with multiplicity 4 lands where a flat quota-4 root
    lands from the four raw gradients, in the port as in the JAX
    package."""
    pair = _Pair("identity")
    try:
        grads = _grads(4, seed=3)
        tstacked, _ = _stacks("identity", grads)
        out = pair.tagg._reduce_weighted(tstacked, [0] * 4, [0, 1, 2, 3],
                                         [1.0] * 4)
        for n in SHAPES:
            np.testing.assert_allclose(
                out[n].numpy(), np.mean([g[n] for g in grads], axis=0),
                rtol=1e-5, atol=1e-6, err_msg=n)
    finally:
        pair.close()
    results = {}
    mean = OrderedDict((n, np.mean([g[n] for g in _grads(4, 5)], axis=0))
                       for n in SHAPES)
    for pkg in ("port", "jax"):
        grads = _grads(4, seed=5)
        if pkg == "port":
            mk = lambda q: AsyncPS(_named(), optim="sgd", quota=q,  # noqa
                                   lr=0.05, momentum=0.5,
                                   devices=[torch.device("cpu")])
            stack = lambda gs: OrderedDict(  # noqa: E731
                (n, torch.from_numpy(np.stack([g[n] for g in gs])))
                for n in SHAPES)
        else:
            mk = lambda q: JAsyncPS(_named(), optim="sgd", quota=q,  # noqa
                                    lr=0.05, momentum=0.5)
            stack = lambda gs: OrderedDict(  # noqa: E731
                (n, jnp.asarray(np.stack([g[n] for g in gs])))
                for n in SHAPES)
        flat, hier = mk(4), mk(1)
        for o in (flat, hier):
            o.compile_step(lambda p, b: sum(v.sum() for v in p.values()))
        flat.params, flat.state = flat._apply_weighted(
            stack(grads), [0] * 4, [0, 1, 2, 3], {}, n_target=4)
        hier.params, hier.state = hier._apply_weighted(
            stack([mean]), [0], [0], {}, n_target=1, contribs=[4.0])
        results[pkg] = [{n: np.asarray(p) for n, p in o.params.items()}
                        for o in (flat, hier)]
    for pkg, (flat, hier) in results.items():
        for n in SHAPES:
            np.testing.assert_allclose(hier[n], flat[n], rtol=1e-5,
                                       atol=1e-6, err_msg=(pkg, n))
    for n in SHAPES:
        np.testing.assert_allclose(results["port"][1][n],
                                   results["jax"][1][n], err_msg=n,
                                   **APPLY_TOL)


# ---------------------------------------------------------------------------
# The relay's version, counters and gates
# ---------------------------------------------------------------------------

def test_pull_and_publish_version_stable_while_root_stalls():
    """The local version advances only when the root's did: per-re-pull
    bumps would inflate worker staleness against a frozen root."""
    pair = _Pair("identity", group_size=2)
    try:
        for agg, root in ((pair.tagg, pair.troot), (pair.jagg, pair.jroot)):
            for _ in range(5):
                assert agg._pull_and_publish() is not None
            assert agg._served_version == 0
            root._served_version = 7  # the root advances...
            assert agg._pull_and_publish() == [7]
            assert agg._served_version == 1
            assert agg._version_map[1] == [7]
            assert agg._pull_and_publish() == [7]
            assert agg._served_version == 1  # ...and holds again
        # The relayed leaves are the root's served values.
        for n, p in _named():
            np.testing.assert_array_equal(np.asarray(pair.tagg._served[n]), p)
    finally:
        pair.close()


def test_pace_valve_opens_only_on_a_stalled_root():
    """Parked forwards open the pace gate after ``pace_timeout`` without a
    root advance, never while the root keeps advancing (the JAX
    aggregator's valve, re-armed only once nothing waits, opens on a
    healthy root whose group out-produces it, and each opening adds to
    the root's staleness for good)."""
    pair = _Pair("identity", group_size=2, pace_timeout=0.05)
    try:
        agg = pair.tagg
        opened, pending = [], [2]
        agg._upstream.pending_frames = lambda: pending[0]
        agg._upstream.open_pace = lambda: opened.append(1)
        valve = None
        for _ in range(5):  # the root advances every loop
            valve = agg._tend_pace_valve(valve, advanced=True)
            time.sleep(0.03)
        assert opened == [] and valve is not None
        for _ in range(5):  # the root stalls
            valve = agg._tend_pace_valve(valve, advanced=False)
            time.sleep(0.03)
        assert len(opened) >= 1
        pending[0] = 0
        assert agg._tend_pace_valve(valve, advanced=False) is None
    finally:
        pair.close()


def test_aggregator_snapshot_key_parity_and_render_coverage():
    """The aggregator's snapshot carries the JAX aggregator's keys, every
    counter of each hierarchy layer renders, and alike in both
    packages."""
    pair = _Pair("identity", group_size=2)
    inproc = AsyncPS([("w", torch.zeros(2))], quota=1,
                     devices=[torch.device("cpu")])
    try:
        tkeys = set(pair.tagg._fault_stats_snapshot())
        jkeys = set(pair.jagg._fault_stats_snapshot())
        assert set(inproc._base_fault_snapshot()) <= tkeys
        assert tkeys == jkeys, sorted(tkeys ^ jkeys)
        gw_stats = {"agg_failovers": 0, "agg_redials": 0}
        hier_stats = {"agg_restarts": 0}
        for stats in (pair.tagg.fault_stats, gw_stats, hier_stats):
            for key, value in stats.items():
                if isinstance(value, int):
                    assert format_fault_stats({key: 1}) != "clean", key
                    assert format_fault_stats({key: 1}) \
                        == jformat_fault_stats({key: 1})
        view = {"agg_frames": 4, "direct_fallbacks": 1,
                "groups": {"0": {"aggregator_rank": 0}, "1": {}}}
        assert format_fault_stats(view) == jformat_fault_stats(view)
    finally:
        pair.close()


def test_reducer_codec_gate_matches_jax():
    class SketchT(tcodecs.IdentityCodec):
        name = "sketch"
        itemwise_decode = False

    class SketchJ(jcodecs.IdentityCodec):
        name = "sketch"
        itemwise_decode = False

    assert tcodecs.Codec.itemwise_decode is jcodecs.Codec.itemwise_decode \
        is True
    assert trobust.COORDINATEWISE_REDUCERS == jrobust.COORDINATEWISE_REDUCERS
    for aggregate in trobust.ROBUST_REDUCERS:
        for scoring in (False, True):
            for ct, cj in ((tcodecs.get_codec("blockq"),
                            jcodecs.get_codec("blockq")),
                           (SketchT(), SketchJ())):
                try:
                    want = jrobust.check_reducer_codec(
                        aggregate, cj, anomaly_scoring=scoring)
                except jrobust.ReducerCodecError as exc:
                    with pytest.raises(trobust.ReducerCodecError) as e:
                        trobust.check_reducer_codec(
                            aggregate, ct, anomaly_scoring=scoring)
                    assert str(e.value) == str(exc)
                    continue
                assert trobust.check_reducer_codec(
                    aggregate, ct, anomaly_scoring=scoring) is want
            assert trobust.bucket_streamable(
                aggregate, anomaly_scoring=scoring) \
                is jrobust.bucket_streamable(aggregate,
                                             anomaly_scoring=scoring)
    # The async PS takes its itemwise flag from the gate.
    opt = AsyncPS([("w", torch.zeros(2))], quota=3, code=SketchT(),
                  aggregate="median", devices=[torch.device("cpu")])
    with pytest.raises(trobust.ReducerCodecError, match="sketch"):
        opt.compile_step(lambda p, b: p["w"].sum())
    with pytest.raises(ValueError, match="unknown aggregate"):
        trobust.bucket_streamable("krum")


# ---------------------------------------------------------------------------
# The adaptive group deadline (tests/test_hierarchy.py:487-520)
# ---------------------------------------------------------------------------

def test_adaptive_deadline_requires_quorum():
    for mk in (lambda **kw: AsyncPS([("w", torch.zeros(2))], quota=1,
                                    devices=[torch.device("cpu")], **kw),
               lambda **kw: JAsyncPS([("w", jnp.zeros((2,)))], quota=1,
                                     **kw)):
        with pytest.raises(ValueError, match="adaptive_deadline"):
            mk(adaptive_deadline=True)
        assert mk().adaptive_deadline is False


@pytest.mark.parametrize("ceiling,interval", [(0.5, 0.01), (0.2, 1.0)],
                         ids=["fast", "slow"])
def test_adaptive_deadline_tightens_to_live_p95_with_ceiling(ceiling,
                                                             interval):
    topt, jopt = _pair_ps(quorum=1, fill_deadline=ceiling,
                          adaptive_deadline=True)
    assert topt._effective_deadline() == jopt._effective_deadline() \
        == ceiling
    t = 100.0
    for _ in range(10):
        for r in (0, 1):
            topt._latency.observe(r, t)
            jopt._latency.observe(r, t)
        t += interval
    d = topt._effective_deadline()
    assert d == jopt._effective_deadline()
    if interval < ceiling:
        assert 0.005 <= d < ceiling
        assert topt.fault_stats["deadline_adapted"] == 1
    else:
        assert d == ceiling
        assert topt.fault_stats["deadline_adapted"] == 0
    assert topt.fault_stats["deadline_adapted"] \
        == jopt.fault_stats["deadline_adapted"]


# ---------------------------------------------------------------------------
# The fault plan's aggregator injectors (tests/test_hierarchy.py:99)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["sign_flip", "scale", "constant"])
def test_fault_plan_agg_fields_roundtrip(mode):
    kw = dict(seed=3, kill_agg_at={1: 4}, slow_agg=0, slow_agg_delay_s=0.2,
              byzantine_agg=2, byzantine_mode=mode, byzantine_scale=50.0)
    plan, jplan = FaultPlan(**kw), JFaultPlan(**kw)
    assert plan.to_json() == jplan.to_json()
    assert FaultPlan.from_json(jplan.to_json()) == plan
    assert plan.any_async_faults() and plan.any_agg_faults()
    assert plan.should_kill_agg(1, 4) and not plan.should_kill_agg(1, 3)
    assert plan.should_slow_agg(0) and not plan.should_slow_agg(1)
    assert plan.agg_byzantine_transform(0) is None
    assert jplan.agg_byzantine_transform(0) is None
    tree = OrderedDict((n, g) for n, g in _grads(1, 21)[0].items())
    got = plan.agg_byzantine_transform(2)(
        OrderedDict((n, torch.from_numpy(g)) for n, g in tree.items()))
    want = jplan.agg_byzantine_transform(2)(
        OrderedDict((n, jnp.asarray(g)) for n, g in tree.items()))
    for n in tree:
        assert np.array_equal(got[n].numpy(), np.asarray(want[n])), n
    # Worker-side faults are untouched by the aggregator injectors.
    assert not FaultPlan(kill_agg_at={0: 1}).should_kill_worker(0, 1)


def test_byzantine_aggregator_maps_the_reduced_gradient():
    """``byzantine_agg`` rides the group's forward: the re-encoded mean of
    an attacked group is the attack applied to the honest mean, as in the
    JAX package."""
    plan = dict(byzantine_agg=0, byzantine_mode="scale",
                byzantine_scale=10.0)
    troot = tma.AsyncSGDServer(_named(), quota=1, device="cpu")
    jroot = jma.AsyncSGDServer(_named(), quota=1)
    aggs = []
    try:
        for srv in (troot, jroot):
            threading.Thread(target=srv._accept_loop, daemon=True).start()
        tagg = tshard.LocalAggregator(
            _named(), group=0, upstream=[("127.0.0.1", troot.address[1])],
            group_size=2, device="cpu", fault_plan=FaultPlan(**plan))
        aggs.append(tagg)
        jagg = jshard.LocalAggregator(
            _named(), group=0, upstream=[("127.0.0.1", jroot.address[1])],
            group_size=2, fault_plan=JFaultPlan(**plan))
        aggs.append(jagg)
        tagg.compile_reduce()
        jagg.compile_reduce()
        tstacked, jstacked = _stacks("identity", _grads(2, seed=9))
        w = np.ones(2, np.float32)
        got, _ = tagg._reduce(tstacked, w)
        with jax.disable_jit():
            want, _ = jagg._reduce_fn(jstacked, jnp.asarray(w),
                                      jnp.float32(float("nan")))
        for n in SHAPES:
            assert np.array_equal(got[n].numpy(), np.asarray(want[n])), n
    finally:
        for s in aggs + [troot, jroot]:
            s.close()


def test_aggregator_refuses_bad_configuration():
    for mk, kw in ((tshard.LocalAggregator, dict(device="cpu")),
                   (jshard.LocalAggregator, {})):
        with pytest.raises(ValueError, match="group_size"):
            mk(_named(), group=0, upstream=[("127.0.0.1", 1)],
               group_size=0, **kw)
        with pytest.raises(ValueError, match="SINGLE root"):
            mk(_named(), group=0, upstream=[("h", 1), ("h", 2)],
               group_size=2, bucket_bytes=4096, **kw)
    with pytest.raises(ValueError, match="groups must be >= 1"):
        tshard.Hierarchy(_named(), groups=0, group_size=1,
                         upstream=[("127.0.0.1", 1)], device="cpu")
    # An unreachable root costs the listener it bound: a retry on the
    # same port binds again.
    with socket.socket() as closed:
        closed.bind(("127.0.0.1", 0))
        dead = closed.getsockname()[1]
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    for _ in range(2):
        with pytest.raises(ConnectionRefusedError):
            tshard.LocalAggregator(
                _named(), group=0, upstream=[("127.0.0.1", dead)],
                group_size=1, port=port, device="cpu")
