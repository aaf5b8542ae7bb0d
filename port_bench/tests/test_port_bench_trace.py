"""The idle share's interval union over overlapping streams, the gaps and
the categories."""

import pytest

from port_bench import readers, trace


def test_union_of_overlapping_streams():
    # stream A: [0, 10], [20, 30]; stream B: [5, 25] overlaps both
    spans = [(0, 10), (20, 30), (5, 25)]
    assert trace.union_seconds(spans) == 30
    # a plain sum would count 40
    assert sum(b - a for a, b in spans) == 40


def test_union_nested_and_disjoint():
    assert trace.union_seconds([(0, 100), (10, 20), (30, 40)]) == 100
    assert trace.union_seconds([(0, 1), (2, 3), (3, 5)]) == 4
    assert trace.union_seconds([]) == 0


def test_gaps_inside_the_stretch():
    assert trace.gaps([(2, 4), (3, 6), (8, 9)], 0, 10) == [
        (0, 2), (6, 8), (9, 10)]


def test_categories_follow_the_table():
    assert trace.category("void block_quantize_kernel<8>") == \
        "block_quantize"
    assert trace.category("flash_fwd_bf16_kernel") == "flash_fwd"
    assert trace.category("ncclDevKernel_AllGather_RING_LL") == "nccl"
    assert trace.category("sm90_xmma_gemm_bf16bf16_bf16f32") == \
        "conv/matmul"
    assert trace.category("ampere_sgemm_128x64_tn") == "f32 GEMM (heads)"
    assert trace.category("Memcpy DtoD (Device -> Device)") == \
        "memcpy/memset"
    assert trace.category("vectorized_elementwise_kernel") == \
        trace.OTHER


def test_summary_and_idle_share():
    dev = [("flash_fwd_x", 0, 10), ("nccl_y", 5, 20), ("gemm_z", 30, 40)]
    cpu = [("aten::mm", 18, 32), ("cudaLaunchKernel", 25, 26)]
    s = trace.summarize(dev, cpu, 0, 50, steps=2)
    assert s["busy_s"] == pytest.approx(30e-6)
    assert s["wall_s"] == pytest.approx(50e-6)
    assert s["category_ms"]["nccl"] == pytest.approx(15 / 2 / 1e3)
    assert s["idle_gaps"][0] == ["aten::mm", pytest.approx(10e-6)]
    rec = {"profile": s}
    assert readers.device_idle(rec) == pytest.approx(40.0)
    assert readers.codec_roofline({"profile": s}) is None


def test_readers_read_nothing_without_a_trace():
    rec = {"profile": None}
    for fn in (readers.model_device_ms, readers.attention_roofline,
               readers.device_idle):
        assert fn(rec) is None
