"""The program spans' host and device ms (`spans.py`) on synthetic event
lists, and the traced stretch's summary (`trace.from_profiler`) unmoved by
program spans among the host events."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from port_bench import spans, trace

# One step on the host (us): ps.step [10, 100] around ps.grad [12, 50],
# ps.encode [50, 60], ps.sync [60, 80] and ps.update [80, 98].
STEP = [("ps.step", 10, 100), ("ps.grad", 12, 50), ("ps.encode", 50, 60),
        ("ps.sync", 60, 80), ("ps.update", 80, 98)]
# Runtime calls (name, start, end, correlation) and what each launched
# (name, start, end, correlation): 101 from the step's thread inside
# ps.grad, 102 from the autograd engine's thread while ps.grad is open,
# 103 in ps.encode, 104 in ps.update, 105 between ps.update's end and
# ps.step's, 106 outside every span; 107's launch is not in the trace.
LAUNCHES = [("cudaLaunchKernel", 20, 21, 101),
            ("cuLaunchKernelEx", 40, 41, 102),
            ("cudaLaunchKernel", 55, 56, 103),
            ("cudaMemcpyAsync", 85, 86, 104),
            ("cudaLaunchKernel", 98.5, 99, 105),
            ("cudaLaunchKernel", 101, 102, 106)]
KERNELS = [("gemm_fwd", 22, 32, 101), ("gemm_bwd", 42, 62, 102),
           ("block_quantize_kernel", 62, 66, 103),
           ("Memcpy DtoD (Device -> Device)", 90, 92, 104),
           ("elementwise", 99, 100, 105), ("elementwise", 102, 104, 106),
           ("ncclKernel", 70, 78, 107)]
HOST_OPS = [("aten::mm", 19, 22, 1), ("aten::copy_", 84, 87, 2)]


def _summary(steps=1):
    host = [(n, a, b, 0) for n, a, b in STEP] + LAUNCHES + HOST_OPS
    return spans.summarize(KERNELS, host, 0, 110, steps)


def test_each_span_claims_what_it_launched_from_any_thread():
    s = _summary()
    assert s["host_ms"] == pytest.approx(
        {n: (b - a) / 1e3 for n, a, b in STEP})
    assert s["device_ms"] == pytest.approx({
        "ps.step": 1e-3,                  # 105: after ps.update closed
        "ps.grad": (10 + 20) / 1e3,       # 101, and 102 from the engine
        "ps.encode": 4e-3, "ps.sync": 0.0, "ps.update": 2e-3})
    total = 10 + 20 + 4 + 2 + 1 + 2 + 8
    assert s["device_ms_all"] == pytest.approx(total / 1e3)
    assert s["unmatched"] == pytest.approx(8 / total)          # 107
    assert s["unclaimed"] == pytest.approx((8 + 2) / total)    # 107, 106


def test_a_model_span_takes_what_it_launched_from_its_phase():
    """A model's own span ``model.x`` [30, 45] inside ``ps.grad`` claims
    102 (launched at 40, from any thread); ``ps.grad`` keeps 101."""
    host = ([(n, a, b, 0) for n, a, b in STEP] + [("model.x", 30, 45, 0)]
            + LAUNCHES + HOST_OPS)
    s = spans.summarize(KERNELS, host, 0, 110, 1)
    assert s["host_ms"]["model.x"] == pytest.approx(15 / 1e3)
    assert s["device_ms"]["model.x"] == pytest.approx(20 / 1e3)
    assert s["device_ms"]["ps.grad"] == pytest.approx(10 / 1e3)
    rest = {n: v for n, v in _summary()["device_ms"].items()
            if n != "ps.grad"}
    assert {n: v for n, v in s["device_ms"].items()
            if n not in ("ps.grad", "model.x")} == pytest.approx(rest)
    assert s["unclaimed"] == _summary()["unclaimed"]


def test_program_spans_are_named_by_prefix():
    assert all(spans.is_span(n) for n, _, _ in STEP)
    assert spans.is_span("model.attention")
    assert not any(spans.is_span(n) for n in (
        "aten::mm", "cudaLaunchKernel", "port_bench.traced", "psx"))


def test_per_step_means_and_the_gaps_by_span():
    s = _summary(steps=2)
    assert s["host_ms"]["ps.step"] == pytest.approx(90 / 2 / 1e3)
    assert s["device_ms"]["ps.grad"] == pytest.approx(30 / 2 / 1e3)
    # Idle: [0, 22], [32, 42], [66, 70], [78, 90], [92, 99], [100, 102],
    # [104, 110].
    assert s["idle_gaps"] == [
        ["outside", pytest.approx(22e-6)], ["ps.sync", pytest.approx(12e-6)],
        ["ps.grad", pytest.approx(10e-6)], ["ps.update", pytest.approx(7e-6)],
        ["outside", pytest.approx(6e-6)]]


def test_spans_outside_the_stretch_and_no_spans_read_nothing():
    host = [(n, a, b, 0) for n, a, b in STEP] + LAUNCHES
    assert spans.summarize(KERNELS, host, 0, 90, 1)["host_ms"] == \
        pytest.approx({n: (b - a) / 1e3 for n, a, b in STEP
                       if b <= 90})
    assert spans.summarize(KERNELS, LAUNCHES, 0, 110, 1) is None


def _event(name, a, b, device, corr=0, annotation=False):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=a, end=b), id=corr,
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        is_user_annotation=annotation)


def _prof(with_spans: bool, model_span: bool = False):
    ev = [_event("port_bench.traced", 0, 110, False, annotation=True),
          _event("port_bench.traced", 22, 104, True, annotation=True)]
    ev += [_event(n, a, b, False, c) for n, a, b, c in LAUNCHES + HOST_OPS]
    ev += [_event(n, a, b, True, c) for n, a, b, c in KERNELS]
    step = STEP + [("model.x", 30, 45)] if model_span else STEP
    if with_spans:
        ev += [_event(n, a, b, False, annotation=True) for n, a, b in step]
        # Each span's shadow on the device's timeline, the model's not
        # marked as an annotation: neither is device work.
        ev += [_event(n, a + 12, b + 4, True, annotation=n != "model.x")
               for n, a, b in step]
    return SimpleNamespace(events=lambda: ev)


def test_from_profiler_keys_hold_with_program_spans():
    before = trace.from_profiler(_prof(False), "port_bench.traced", 1)
    after = trace.from_profiler(_prof(True), "port_bench.traced", 1)
    gaps = after.pop("idle_gaps")
    assert [g[1] for g in gaps] == [g[1] for g in before.pop("idle_gaps")]
    # The spans ride in the profile (None where the program opened none).
    assert before.pop("spans") is None
    assert after.pop("spans") == _summary()
    assert after == before
    # A gap where only a span is open is named by it, not "host idle".
    assert ["ps.sync", pytest.approx(12e-6)] in gaps


def test_spans_from_profiler():
    s = spans.from_profiler(_prof(True), "port_bench.traced", 1)
    assert s == _summary()
    m = spans.from_profiler(_prof(True, model_span=True),
                            "port_bench.traced", 1)
    assert m["device_ms"]["model.x"] == pytest.approx(20 / 1e3)
    assert m["device_ms_all"] == pytest.approx(s["device_ms_all"])
    assert spans.from_profiler(_prof(False), "port_bench.traced", 1) is None
    assert spans.from_profiler(_prof(True), "elsewhere", 1) is None


def test_phases_coverage():
    from port_bench import phases

    cov = phases.coverage(_summary())
    assert cov["phase_device_share"] == pytest.approx(36 / 37)
    assert cov["phase_host_over_step"] == pytest.approx((38 + 10 + 20 + 18)
                                                        / 90)


def test_span_and_counter_readers():
    from port_bench import spec

    rec = {"profile": {"spans": _summary()},
           "step_metrics": {"sync_calls": 101.0}}
    assert spec.reader("ps.grad.device_ms.lm")(rec) == pytest.approx(30e-3)
    assert spec.reader("ps.update.host_ms.r18")(rec) == pytest.approx(18e-3)
    assert spec.reader("ps.sync.calls.lm")(rec) == 101.0
    for empty in ({"profile": None}, {"profile": {"spans": None}}):
        assert spec.reader("ps.grad.host_ms.lm")(empty) is None
        assert spec.reader("ps.sync.calls.r18")(empty) is None


def test_spans_merge_over_ranks_as_categories_do():
    from port_bench import run

    one = {"busy_s": 1.0, "wall_s": 2.0, "category_ms": {"nccl": 1.0},
           "spans": _summary()}
    three = {"busy_s": 3.0, "wall_s": 2.0, "category_ms": {"gemm": 3.0},
             "spans": {**_summary(), "host_ms": {"ps.grad": 0.114}}}
    m = run._merge_profiles([one, three, None])
    assert m["category_ms"] == {"nccl": 0.5, "gemm": 1.5}
    assert m["spans"]["host_ms"]["ps.grad"] == pytest.approx(
        (0.038 + 0.114) / 2)
    assert m["spans"]["host_ms"]["ps.sync"] == pytest.approx(0.020 / 2)
    assert m["spans"]["device_ms"] == pytest.approx(_summary()["device_ms"])
    assert one["spans"] == _summary()   # the ranks' own are left as they were
