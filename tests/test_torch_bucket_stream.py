"""The bucket-streamed async gradient (the v11 GRAD stream) of the port
against the JAX package's, on the CPU.

* The step: a bucketed gradient's codes, fused (encoded inside backward)
  or not, are bitwise the whole-tree step's and the JAX package's
  `make_async_bucket_step`'s (run op by op), for the identity, bf16,
  blockq (in flax's element order) and topk codecs.  The JAX side gets a
  loss whose
  gradient is exact in both packages (``sum(p * w)`` has gradient ``w``),
  so the comparison is of the plumbing and the codecs, not of two
  backward passes; the port's own backward is held against its
  whole-tree step.
* The server: bucket frames deduplicate per ``(seq, bucket)`` before
  decode, a partial assembly retires counted and is never applied,
  interleaved streams assemble per rank, a plan that does not cover the
  tree costs its connection; the transport charges one credit per
  gradient and parks and sheds a gradient as a unit.
* End to end: a lockstep port worker streaming buckets trains bitwise
  like the whole-tree worker; the worker's and the CLI's refusals.

The aggregator's cases of `tests/test_bucket_stream.py` wait for the
hierarchy.  Every ``serve()`` and join has a timeout of at most 60 s.
"""

import socket
import threading
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu import train as jtrain
from pytorch_ps_mpi_tpu.ops.codecs import get_codec as jget_codec
from pytorch_ps_mpi_tpu.parallel import overlap as jov
from pytorch_ps_mpi_tpu_torch import train as ttrain
from pytorch_ps_mpi_tpu_torch.async_ps import (dataset_batch_fn,
                                               make_worker_step)
from pytorch_ps_mpi_tpu_torch.models import init_mlp, mlp_loss_fn
from pytorch_ps_mpi_tpu_torch.multihost_async import (AsyncPSWorker,
                                                      AsyncSGDServer,
                                                      _wire_leaf,
                                                      tree_to_host)
from pytorch_ps_mpi_tpu_torch.ops.codecs import get_codec
from pytorch_ps_mpi_tpu_torch.parallel import overlap as tov
from pytorch_ps_mpi_tpu_torch.transport import Session, recv_frame
from pytorch_ps_mpi_tpu_torch.utils.flatten import tree_leaves, tree_map
from pytorch_ps_mpi_tpu_torch.utils.interop import jax_order, params_from_jax

SIZES = (32, 64, 8)
TIMEOUT = 60
CODECS = ["identity", "bf16", "blockq", "topk"]


def _params(seed=0):
    return init_mlp(np.random.RandomState(seed), SIZES)


def _teacher(seed=7, n=256):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, SIZES[0]).astype(np.float32)
    w = rng.randn(SIZES[0], SIZES[-1]).astype(np.float32)
    return x, (x @ w).argmax(1).astype(np.int64)


def _batch(seed=0):
    x, y = _teacher()
    rng = np.random.RandomState(seed)
    take = rng.randint(0, len(x), 64)
    return {"x": torch.from_numpy(x[take]), "y": torch.from_numpy(y[take])}


def _server(quota=1, **kw):
    kw.setdefault("momentum", 0.5)
    srv = AsyncSGDServer(list(_params().items()), lr=0.05, quota=quota,
                         device="cpu", **kw)
    srv.compile_step(mlp_loss_fn)
    return srv


def _serve(srv, steps, box):
    def go():
        try:
            box["hist"] = srv.serve(steps=steps, idle_timeout=TIMEOUT)
        except BaseException as exc:  # noqa: BLE001 - asserted by tests
            box["error"] = exc

    t = threading.Thread(target=go, daemon=True, name="bucket-serve")
    t.start()
    return t


def _host(sub):
    return tree_map(_wire_leaf, tree_to_host(sub))


def _worker(srv, **kw):
    return AsyncPSWorker("127.0.0.1", srv.address[1], device="cpu",
                         reconnect_retries=1, **kw)


def _torch_tree(params):
    return OrderedDict((n, torch.as_tensor(np.asarray(v)))
                       for n, v in params.items())


def _stream(w, bucket_bytes=4096, seed=0):
    """One pull, the plan, and the gradient's host buckets."""
    version, params = w.pull()
    plan = tov.plan_overlap(_torch_tree(params), bucket_bytes,
                            record=False)
    fn = tov.make_async_bucket_step(mlp_loss_fn, w.code, plan)
    loss, buckets = fn(_torch_tree(params), _batch(seed))
    return version, plan, float(loss), [_host(sub) for sub in buckets]


def _bits(x):
    """A leaf as numpy, bf16 as its int16 bits (numpy has no bf16)."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return ("bfloat16", x.view(torch.int16).numpy()) \
            if x.dtype == torch.bfloat16 else (str(x.numpy().dtype),
                                               x.numpy())
    x = np.asarray(x)
    if str(x.dtype) == "bfloat16":
        return "bfloat16", x.view(np.int16)
    return str(x.dtype), x


def _equal_trees(a, b, what):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), what
    for x, y in zip(la, lb):
        (dx, x), (dy, y) = _bits(x), _bits(y)
        assert dx == dy and x.shape == y.shape, what
        np.testing.assert_array_equal(x, y, err_msg=what)


# ---------------------------------------------------------------------------
# split / merge, the plan
# ---------------------------------------------------------------------------

def test_split_merge_roundtrip_matches_jax():
    params = _torch_tree(_params())
    plan = tov.plan_overlap(params, 4096, record=False)
    jplan = jov.plan_overlap(_params(), 4096, record=False)
    assert plan.buckets == jplan.buckets and plan.n_buckets > 1
    subs = tov.split_tree(params, plan)
    jsubs = jov.split_tree(_params(), jplan)
    assert [list(s) for s in subs] == [list(s) for s in jsubs]
    merged = tov.merge_buckets(reversed(subs), list(params))
    assert list(merged) == list(params)
    assert all(merged[n] is params[n] for n in params)


def test_iter_ready_groups_flushes_before_a_pending_bucket():
    class Pending:
        def __init__(self, done):
            self.done = done

        def query(self):
            return self.done

    subs = []
    for done in (True, True, False, True):
        sub = tov.BucketCodes(a=len(subs))
        sub.event = Pending(done)
        subs.append(sub)
    groups = list(tov.iter_ready_groups(subs, lambda s: s["a"]))
    assert groups == [[0, 1], [2, 3]]
    # Without events (the CPU) every bucket is ready: one group.
    plain = [OrderedDict(a=i) for i in range(3)]
    assert list(tov.iter_ready_groups(plain, lambda s: s["a"])) == \
        [[0, 1, 2]]


# ---------------------------------------------------------------------------
# The step: fused == unfused == whole tree == the JAX package's
# ---------------------------------------------------------------------------

# Leaves named as the LM's, so the Dense kernels take `jax_order`'s (1, 0):
# blockq's tiles and topk's indices then follow flax's layout.
LM_LEAVES = [("block_0/qkv/kernel", (32, 96)), ("block_0/qkv/bias", (96,)),
             ("block_0/out/kernel", (32, 32)), ("block_0/fc1/kernel",
                                                (32, 128)),
             ("block_0/fc2/kernel", (128, 32)), ("lm_head/kernel", (32, 61))]


def _lm_like(seed):
    """flax-named params and weights ``w`` (values rounded to bf16
    precision, so topk meets ties), the same in the port's names and
    layouts."""
    rng = np.random.RandomState(seed)
    jp = OrderedDict((n, rng.randn(*s).astype(np.float32))
                     for n, s in LM_LEAVES)
    jw = OrderedDict(
        (n, torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.01)
         .to(torch.bfloat16).to(torch.float32).numpy())
        for n, s in LM_LEAVES)
    tp, _ = params_from_jax(jp)
    tw, _ = params_from_jax(jw)
    return jp, jw, tp, tw


def _jloss(p, w):
    return sum(jnp.sum(p[n] * w[n]) for n in p)


def _tloss(p, w):
    return sum(torch.sum(p[n] * w[n]) for n in p)


@pytest.mark.parametrize("codec", CODECS)
def test_bucket_codes_equal_whole_tree_and_jax(codec):
    jp, jw, tp, tw = _lm_like(3)
    code = get_codec(codec)
    orders = ({n: o for n, p in tp.items()
               if (o := jax_order(n, tuple(p.shape))) is not None}
              if code.ordered else {})
    if code.ordered:
        assert len(orders) == 5
    plan = tov.plan_overlap(tp, 8192, record=False)
    assert plan.n_buckets >= 3
    lw, whole = make_worker_step(_tloss, code, orders=orders)(tp, tw)
    runs = {}
    for fused in (True, False):
        step = tov.make_async_bucket_step(_tloss, code, plan, fused=fused,
                                          orders=orders)
        loss, buckets = step(tp, tw)
        assert torch.equal(loss, lw)
        assert [list(b) for b in buckets] == [list(n) for n in plan.buckets]
        assert all(b.event is None for b in buckets)  # the CPU
        runs[fused] = tov.merge_buckets(buckets, list(tp))
    jplan = jov.plan_overlap(jp, 8192, record=False)
    jstep = jov.make_async_bucket_step(_jloss, jget_codec(codec), jplan)
    # Op by op: under ``jit`` XLA's CPU compiler takes blockq's scale one
    # ulp off the codec's own eager value (a reference caveat, ROADMAP
    # §3), which the port's codecs are held to.
    with jax.disable_jit():
        _, jbuckets = jstep(jp, jw)
    jcodes = jov.merge_buckets(jbuckets, list(jp))
    for jn, tn in zip(jp, tp):
        for fused, codes in runs.items():
            _equal_trees(codes[tn], whole[tn], f"{codec} {tn} fused={fused}")
        # An unordered codec's code keeps the leaf's own layout: seen in
        # flax's for the comparison.
        order = None if code.ordered else jax_order(tn, tp[tn].shape)
        ours = tree_map(lambda x: x if order is None else x.permute(order),
                        runs[True][tn])
        _equal_trees(ours, jax.tree.map(np.asarray, jcodes[jn]),
                     f"{codec} {jn}")


@pytest.mark.parametrize("codec", CODECS)
def test_fused_backward_codes_equal_the_whole_tree_step(codec):
    """The port's own backward through the MLP: the hooks encode each
    bucket the moment its last gradient lands, bitwise the whole-tree
    step."""
    params, batch = _torch_tree(_params()), _batch()
    code = get_codec(codec)
    plan = tov.plan_overlap(params, 4096, record=False)
    lw, whole = make_worker_step(mlp_loss_fn, code)(params, batch)
    for fused in (True, False):
        loss, buckets = tov.make_async_bucket_step(
            mlp_loss_fn, code, plan, fused=fused)(params, batch)
        assert torch.equal(loss, lw)
        merged = tov.merge_buckets(buckets, list(params))
        for n in params:
            _equal_trees(merged[n], whole[n], f"{codec} {n} fused={fused}")


def test_unused_leaf_is_encoded_as_zeros():
    params = _torch_tree(_params())
    params["spare"] = torch.ones(5)
    plan = tov.plan_overlap(params, 4096, record=False)
    _, whole = make_worker_step(mlp_loss_fn, get_codec("blockq"))(
        params, _batch())
    _, buckets = tov.make_async_bucket_step(
        mlp_loss_fn, get_codec("blockq"), plan)(params, _batch())
    merged = tov.merge_buckets(buckets, list(params))
    for n in params:
        _equal_trees(merged[n], whole[n], n)


def test_byzantine_transform_per_bucket_equals_whole_tree():
    from pytorch_ps_mpi_tpu_torch.utils.faults import FaultPlan

    params, batch = _torch_tree(_params()), _batch()
    plan = tov.plan_overlap(params, 4096, record=False)
    code = get_codec("identity")
    for mode in ("sign_flip", "scale", "constant"):
        tf = FaultPlan(byzantine_rank=0, byzantine_mode=mode,
                       byzantine_scale=3.0).byzantine_transform(0)
        _, whole = make_worker_step(mlp_loss_fn, code, tf)(params, batch)
        _, buckets = tov.make_async_bucket_step(
            mlp_loss_fn, code, plan, tf)(params, batch)
        merged = tov.merge_buckets(buckets, list(params))
        for n in params:
            _equal_trees(merged[n], whole[n], f"{mode} {n}")


def test_one_bucket_plan_is_the_whole_tree_step():
    params, batch = _torch_tree(_params()), _batch()
    plan = tov.plan_overlap(params, 1 << 30, record=False)
    assert plan.n_buckets == 1
    lb, (sub,) = tov.make_async_bucket_step(
        mlp_loss_fn, get_codec(None), plan)(params, batch)
    lw, codes = make_worker_step(mlp_loss_fn, get_codec(None))(params, batch)
    assert torch.equal(lb, lw) and list(sub) == list(codes)
    for n in codes:
        assert torch.equal(sub[n], codes[n])


# ---------------------------------------------------------------------------
# End to end: lockstep drives, bitwise against the whole-tree stream
# ---------------------------------------------------------------------------

def _lockstep(bucket_bytes, code="identity", fused=False, updates=4):
    srv = _server(code=code, momentum=0.9)
    box: dict = {}
    t = _serve(srv, updates, box)
    try:
        w = _worker(srv, code=code, bucket_bytes=bucket_bytes,
                    fused_encode=fused)
        w._lockstep = True
        x, y = _teacher()
        pushed = w.run(mlp_loss_fn, dataset_batch_fn(x, y, 32, seed=4))
        t.join(TIMEOUT)
    finally:
        srv.close()
    assert "error" not in box, box.get("error")
    assert pushed == updates
    return box["hist"], srv.params, w


@pytest.mark.parametrize("code,fused", [("identity", False),
                                        ("identity", True),
                                        ("blockq", True)])
def test_multi_bucket_stream_trains_bitwise_like_whole_tree(code, fused):
    hist_w, params_w, _ = _lockstep(None, code)
    hist_b, params_b, w = _lockstep(4096, code, fused)
    assert hist_b["losses"] == hist_w["losses"]
    for n in params_w:
        assert torch.equal(params_w[n], params_b[n]), n
    n_buckets = w._bucket_plan.n_buckets
    assert n_buckets == 2
    fs = hist_b["fault_stats"]
    assert fs["buckets_filled"] == 4 * n_buckets
    assert fs["bucket_partial_timeouts"] == 0
    assert w.fault_stats["buckets_sent"] == 4 * n_buckets
    assert w.fault_stats["fused_encodes"] == (4 if fused else 0)


def test_one_bucket_stream_is_the_whole_tree_path_bitwise():
    hist_w, params_w, _ = _lockstep(None)
    hist_1, params_1, w = _lockstep(1 << 30)
    assert w._bucket_plan.n_buckets == 1
    assert hist_1["losses"] == hist_w["losses"]
    for n in params_w:
        assert torch.equal(params_w[n], params_1[n]), n
    # A one-bucket plan sends the (0, 1) header, the whole-tree frame:
    # the assembly never engages.
    assert hist_1["fault_stats"]["buckets_filled"] == 0


def test_overload_burst_restreams_the_buckets_under_fresh_seqs():
    """``burst_at`` re-streams a gradient's buckets as extra gradients:
    the PS assembles each, and the run takes them as contributions."""
    from pytorch_ps_mpi_tpu_torch.utils.faults import FaultPlan

    srv = _server(quota=1)
    box: dict = {}
    t = _serve(srv, 3, box)
    try:
        w = _worker(srv, bucket_bytes=4096, fused_encode=True,
                    fault_plan=FaultPlan(burst_at={0: 2}))
        x, y = _teacher()
        w.run(mlp_loss_fn, dataset_batch_fn(x, y, 32, seed=4))
        t.join(TIMEOUT)
    finally:
        srv.close()
    assert "error" not in box, box.get("error")
    n = w._bucket_plan.n_buckets
    assert w.fault_stats["burst_injected"] == 2
    assert w.fault_stats["buckets_sent"] == n * (w.grads_computed + 2)
    assert box["hist"]["fault_stats"]["buckets_filled"] >= 3 * n


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------

def test_partial_bucket_times_out_without_double_apply():
    """A gradient whose last bucket never comes retires counted when the
    rank's next stream completes, and contributes nothing."""
    srv = _server()
    box: dict = {}
    t = _serve(srv, 1, box)
    w = _worker(srv, bucket_bytes=4096)
    try:
        version, plan, loss, host = _stream(w)
        w.push_buckets(iter(host[:-1]), plan.n_buckets, version, loss)
        w.push_buckets(iter(host), plan.n_buckets, version, loss)
        t.join(TIMEOUT)
    finally:
        w.close()
        srv.close()
    assert "error" not in box, box.get("error")
    fs = box["hist"]["fault_stats"]
    assert box["hist"]["grads_consumed"] == 1
    assert fs["bucket_partial_timeouts"] >= 1
    assert fs["buckets_filled"] == plan.n_buckets


def test_interleaved_rank_streams_fill_rank_distinct():
    """Frames of two ranks alternate on the wire (w0.b0, w1.b0, w0.b1,
    ...): the assembly is per (rank, seq), so one fill takes one gradient
    from each rank."""
    srv = _server(quota=2)
    box: dict = {}
    t = _serve(srv, 1, box)
    ws = [_worker(srv, bucket_bytes=4096) for _ in range(2)]
    try:
        streams = [_stream(w, seed=i) for i, w in enumerate(ws)]
        turn, other = threading.Semaphore(1), threading.Semaphore(0)

        def frames(host, mine, theirs):
            for sub in host:
                mine.acquire()
                yield sub
                theirs.release()

        threads = []
        for i, w in enumerate(ws):
            version, plan, loss, host = streams[i]
            mine, theirs = (turn, other) if i == 0 else (other, turn)
            th = threading.Thread(
                target=w.push_buckets, daemon=True,
                args=(frames(host, mine, theirs), plan.n_buckets, version,
                      loss))
            th.start()
            threads.append(th)
        for th in threads:
            th.join(TIMEOUT)
        t.join(TIMEOUT)
    finally:
        for w in ws:
            w.close()
        srv.close()
    assert "error" not in box, box.get("error")
    hist = box["hist"]
    assert sorted(hist["contributors"][0]) == [0, 1]
    assert hist["fault_stats"]["buckets_filled"] == 2 * plan.n_buckets


def test_duplicate_bucket_frame_drops_without_decode():
    srv = _server()
    box: dict = {}
    t = _serve(srv, 2, box)
    w = _worker(srv, bucket_bytes=4096)
    try:
        version, plan, loss, host = _stream(w)
        w.push_buckets(iter(host), plan.n_buckets, version, loss)
        # The same stream under the same seq: every frame a duplicate.
        w._push_seq -= 1
        w.push_buckets(iter(host), plan.n_buckets, version, loss)
        w.push_buckets(iter(host), plan.n_buckets, version, loss)
        t.join(TIMEOUT)
    finally:
        w.close()
        srv.close()
    assert "error" not in box, box.get("error")
    fs = box["hist"]["fault_stats"]
    assert fs["duplicate_dropped"] == plan.n_buckets
    assert fs["buckets_filled"] == 2 * plan.n_buckets
    assert box["hist"]["grads_consumed"] == 2


def test_burn_seq_is_bucket_aware():
    srv = _server()
    try:
        assert srv._burn_seq(0, 5, 0, 3) and srv._burn_seq(0, 5, 2, 3)
        assert not srv._burn_seq(0, 5, 0, 3)   # (seq, bucket) seen
        assert srv._burn_seq(0, 5, 1, 3)       # the seq completes
        assert srv._last_seq[0] == 5 and not srv._bucket_seen[0]
        assert not srv._burn_seq(0, 5, 1, 3)   # below the mark now
        for s in range(6, 6 + 6):              # the window keeps 4 seqs
            assert srv._burn_seq(0, s, 0, 2)
        assert sorted(srv._bucket_seen[0]) == [8, 9, 10, 11]
        assert srv._burn_seq(0, 20)            # a whole-tree frame
        assert not srv._bucket_seen[0]
    finally:
        srv.close()


def test_mismatched_bucket_plan_is_quarantined():
    """Buckets that are each valid but whose union is not the served tree
    cost their connection and are never applied."""
    srv = _server()
    box: dict = {}
    t = _serve(srv, 1, box)
    w = _worker(srv, bucket_bytes=4096)
    w2 = None
    try:
        version, plan, loss, host = _stream(w)
        assert plan.n_buckets == 2
        w.push_buckets(iter([host[0], host[0]]), plan.n_buckets, version,
                       loss)
        w2 = _worker(srv, bucket_bytes=4096)
        v2, plan2, loss2, host2 = _stream(w2)
        w2.push_buckets(iter(host2), plan2.n_buckets, v2, loss2)
        t.join(TIMEOUT)
    finally:
        w.close()
        if w2 is not None:
            w2.close()
        srv.close()
    assert "error" not in box, box.get("error")
    fs = box["hist"]["fault_stats"]
    assert fs["quarantined_frames"] >= 1
    assert fs["buckets_filled"] == plan.n_buckets
    assert "does not match the served tree" in str(srv._last_drop)


def test_bucket_naming_an_unknown_parameter_is_quarantined():
    srv = _server()
    box: dict = {}
    t = _serve(srv, 1, box)
    w = _worker(srv, bucket_bytes=4096)
    w2 = None
    try:
        version, plan, loss, host = _stream(w)
        bad = OrderedDict(host[0])
        bad["nope"] = np.zeros(3, np.float32)
        w.push_buckets(iter([bad, host[1]]), plan.n_buckets, version, loss)
        w2 = _worker(srv, bucket_bytes=4096)
        v2, plan2, loss2, host2 = _stream(w2)
        w2.push_buckets(iter(host2), plan2.n_buckets, v2, loss2)
        t.join(TIMEOUT)
    finally:
        w.close()
        if w2 is not None:
            w2.close()
        srv.close()
    assert "error" not in box, box.get("error")
    assert box["hist"]["fault_stats"]["quarantined_frames"] >= 1
    assert "unknown parameter 'nope'" in str(srv._last_drop)


# ---------------------------------------------------------------------------
# The credit gate: one credit a gradient, parked and shed as a unit
# ---------------------------------------------------------------------------

def test_bucket_stream_charges_one_credit_per_gradient():
    srv = _server()
    srv_box: dict = {}
    t = _serve(srv, 1, srv_box)
    w = _worker(srv, bucket_bytes=4096)
    try:
        version, plan, loss, host = _stream(w)
        w._session.replenish(1)
        w.push_buckets(iter(host), plan.n_buckets, version, loss)
        assert w._session.credits() == 0      # one credit, two frames
        assert w.fault_stats["buckets_sent"] == plan.n_buckets
        assert w._session.pending_count() == 0
        t.join(TIMEOUT)
    finally:
        w.close()
        srv.close()
    assert "error" not in srv_box, srv_box.get("error")
    assert srv_box["hist"]["fault_stats"]["buckets_filled"] == plan.n_buckets


def test_parked_bucket_gradient_sheds_as_a_unit():
    a, b = socket.socketpair()
    a.settimeout(10.0)
    b.settimeout(10.0)
    s = Session(a, max_pending=1, sentinel=True)
    try:
        s.replenish(0)
        assert not s.begin_data_parts()
        s.park_data_parts([[b"GRAD", b"old0"], [b"GRAD", b"old1"]])
        assert not s.begin_data_parts()
        s.park_data_parts([[b"GRAD", b"new0"], [b"GRAD", b"new1"]])
        assert s.stats["shed_data_frames"] == 1   # the older gradient
        assert s.pending_count() == 1
        s.replenish(2)
        assert recv_frame(b) == b"GRAD" + b"new0"
        assert recv_frame(b) == b"GRAD" + b"new1"
        assert s.stats["sentinel_checks"] == 1
        assert s.stats["sentinel_trips"] == 0
    finally:
        a.close()
        b.close()


def test_worker_parks_a_closed_gate_gradient_as_one_entry():
    srv = _server()
    try:
        threading.Thread(target=srv._accept_loop, daemon=True).start()
        w = _worker(srv, bucket_bytes=4096)
        version, plan, loss, host = _stream(w)
        w._session.replenish(0)
        w.push_buckets(iter(host), plan.n_buckets, version, loss)
        assert w._session.pending_count() == 1
        assert w._session.stats["credits_stalled"] == 1
        w.close()
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

def test_worker_ctor_refusals():
    with pytest.raises(ValueError, match="bucket_bytes"):
        AsyncPSWorker("h", 1, bucket_bytes=-1, device="cpu")
    with pytest.raises(ValueError, match="fused_encode"):
        AsyncPSWorker("h", 1, fused_encode=True, device="cpu")


# The refusals the JAX CLI makes with the same message.
CLI_REFUSALS = [
    ["--async-bucket-bytes", "0"],
    ["--serve", "0", "--async-bucket-bytes", "0"],
    ["--async-ps", "--async-bucket-bytes", "0"],
    ["--connect", "h:1", "--fused-encode"],
    ["--connect", "h:1", "--async-bucket-bytes", "-3"],
]


@pytest.mark.parametrize("argv", CLI_REFUSALS,
                         ids=[" ".join(a) for a in CLI_REFUSALS])
def test_cli_refusal_matrix(argv):
    msgs = []
    for run in (lambda a: jtrain.main(a + ["--n-devices", "1"]),
                lambda a: ttrain.main(a + ["--force-cpu-devices", "1"])):
        with pytest.raises(SystemExit) as e:
            run(["--model", "mlp", "--steps", "1"] + argv)
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]
    assert "not ported" not in msgs[1]


def test_cli_bucket_flags_reach_the_dial_on_connect():
    """A worker takes ``--async-bucket-bytes`` and ``--fused-encode``: it
    gets past every refusal to the dial, here at a port that does not
    listen; with the hierarchy's failover worker (``--fallback``) and with
    a shard router it is refused with the JAX CLI's messages."""
    with socket.socket() as closed:
        closed.bind(("127.0.0.1", 0))
        with pytest.raises(ConnectionRefusedError):
            ttrain.main(["--connect", f"127.0.0.1:{closed.getsockname()[1]}",
                         "--async-bucket-bytes", "0", "--fused-encode",
                         "--steps", "1", "--force-cpu-devices", "1"])
    msgs = []
    for run, tail in ((jtrain.main, ["--n-devices", "1"]),
                      (ttrain.main, ["--force-cpu-devices", "1"])):
        with pytest.raises(SystemExit) as e:
            run(["--connect", "h:1", "--async-bucket-bytes", "0",
                 "--fallback", "h:2", "--steps", "1", *tail])
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]
    assert msgs[1].startswith("--async-bucket-bytes does not compose "
                              "with the hierarchy failover worker")
    msgs = []
    for run, tail in ((jtrain.main, ["--n-devices", "1"]),
                      (ttrain.main, ["--force-cpu-devices", "1"])):
        with pytest.raises(SystemExit) as e:
            run(["--connect", "h:1,h:2", "--async-bucket-bytes", "0",
                 "--steps", "1", *tail])
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]
    assert msgs[1].startswith("--async-bucket-bytes does not compose "
                              "with the shard router")
