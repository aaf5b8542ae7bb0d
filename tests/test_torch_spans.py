"""The port's sync step under ``torch.profiler`` on the CPU: its named
spans (``ps.step`` around ``ps.grad``, ``ps.encode``, ``ps.sync`` and
``ps.update``, `utils.timing.annotate`), the flat collectives its sync
phase issues (``sync_calls``), and its byte counts, made once."""

import threading
from collections import OrderedDict

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pytorch_ps_mpi_tpu_torch import SGD
from pytorch_ps_mpi_tpu_torch.parallel import collectives
from pytorch_ps_mpi_tpu_torch.utils import timing
from pytorch_ps_mpi_tpu_torch.utils.flatten import tree_leaves

PHASES = ("ps.grad", "ps.encode", "ps.sync", "ps.update")
SHAPES = (("w1", (256, 128)), ("b1", (128,)), ("w2", (128, 64)),
          ("b2", (64,)), ("w3", (64, 300)))


def _named():
    rng = np.random.RandomState(0)
    return [(n, (0.1 * rng.randn(*s)).astype(np.float32))
            for n, s in SHAPES]


def _loss(p, batch):
    h = torch.relu(batch["x"] @ p["w1"] + p["b1"])
    h = torch.relu(h @ p["w2"] + p["b2"])
    return ((h @ p["w3"] - batch["y"]) ** 2).mean()


def _batch(seed=1):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(8, 256).astype(np.float32),
            "y": rng.randn(8, 300).astype(np.float32)}


def _opt(**kw):
    kw.setdefault("code", "blockq")
    opt = SGD(_named(), lr=0.05, momentum=0.9, device="cpu", **kw)
    opt.compile_step(_loss)
    return opt


@pytest.fixture
def opened(monkeypatch):
    """Every ``(name, args)`` that `annotate` hands to
    ``torch.profiler.record_function``."""
    seen = []
    real = torch.profiler.record_function

    def spy(name, args=None):
        seen.append((name, args))
        return real(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    return seen


@pytest.mark.parametrize("mode", ["blocking", "queued", "profiled"])
def test_each_step_nests_its_four_phases_in_order(mode, opened):
    opt = _opt(profile=mode == "profiled")
    opt.step(_batch(0))                       # outside the profiler
    assert opened == []
    steps = 3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(steps):
            opt.step(_batch(i + 1), block=mode != "queued")
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.name.startswith("ps."))
    outer = [(a, b) for a, b, n in spans if n == "ps.step"]
    assert len(outer) == steps
    # Each step's index (the steps completed before it) is its args.
    assert [args for name, args in opened if name == "ps.step"] == [
        "1", "2", "3"]
    for a, b in outer:
        inner = [(s, e, n) for s, e, n in spans
                 if n != "ps.step" and a <= s < b]
        assert tuple(n for _, _, n in inner) == PHASES
        assert all(a <= s <= e <= b for s, e, _ in inner)
        assert all(prev[1] <= nxt[0] for prev, nxt in zip(inner, inner[1:]))
    assert len(spans) == 5 * steps


def test_annotate_without_a_profiler_is_the_shared_no_op(opened):
    span = timing.annotate("ps.step", 7)
    assert span is timing.annotate("ps.grad")
    with span as entered:
        assert entered is None
    opt = _opt()
    for i in range(2):
        opt.step(_batch(i), block=i == 0)
    assert opened == []


@pytest.mark.parametrize("code,decompose", [("blockq", False),
                                            ("bf16", False),
                                            ("identity", False),
                                            ("identity", True)])
@pytest.mark.parametrize("profiled", [False, True])
def test_sync_calls_count_the_sync_phase_buckets(code, decompose, profiled):
    # 64 KiB buckets: the codes pack into several, larger leaves go solo.
    opt = _opt(code=code, decompose_allreduce=decompose, bucket_mb=1 / 16,
               profile=profiled)
    grads = OrderedDict((n, torch.zeros_like(p))
                        for n, p in opt.params.items())
    leaves = tree_leaves(opt._phase_encode(grads))
    plan = collectives._plan_buckets(
        leaves, opt.bucket_bytes,
        collectives._solo_default(opt.bucket_bytes, None))
    assert len(plan) > 1 and any(len(b) > 1 for b in plan)
    per_bucket = 2 if decompose else 1
    for i in range(3):
        before = collectives.flat_calls()
        _, m = opt.step(_batch(i))
        assert m["sync_calls"] == per_bucket * len(plan)
        # The loss mean's all-reduce lies outside the sync phase.
        assert collectives.flat_calls() - before > m["sync_calls"]


def test_another_threads_collectives_are_not_counted_here():
    opt = _opt(code="identity")
    tree = {"a": torch.ones(3), "b": torch.ones(2, dtype=torch.float64)}
    before = collectives.flat_calls()
    box = []
    worker = threading.Thread(target=lambda: box.append((
        collectives.flat_calls(),
        collectives.psum_tree_bucketed(tree, opt.group),
        collectives.flat_calls())))
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive()
    start, summed, end = box[0]
    assert end - start == 2 and torch.equal(summed["a"], torch.ones(3))
    assert collectives.flat_calls() == before


def test_byte_counts_are_made_once_per_compile(monkeypatch):
    opt = _opt()
    _, first = opt.step(_batch(0))
    assert first["msg_bytes"] == sum(4 * int(np.prod(s)) for _, s in SHAPES)

    def no_more(*a):
        raise AssertionError("counted again")

    monkeypatch.setattr(opt.code, "wire_bytes", no_more)
    for i in range(2):
        _, m = opt.step(_batch(i + 1), block=i == 0)
        assert (m["msg_bytes"], m["packaged_bytes"]) == (
            first["msg_bytes"], first["packaged_bytes"])
    opt.compile_step(_loss)
    with pytest.raises(AssertionError, match="counted again"):
        opt.step(_batch(3))
