"""The yardstick's arithmetic against hand counts at small shapes."""

import math

import pytest

from port_bench import check, flops, peaks
from port_bench.families import lm, resnet18
from port_bench.reference import blockq


def test_lm_flops_by_hand():
    c = {"d_model": 2, "d_ff": 4, "vocab_size": 3, "n_layers": 1}
    # matmul weights: qkv 12 + out 4 + fc1 8 + fc2 8 + head 6 = 38
    # tokens 2 x 3 = 6: 6 * 38 * 6 = 1368
    # causal pairs of 3 positions = 6; attention 12 * d * pairs * rows
    # = 12 * 2 * 6 * 2 = 288
    assert lm.lm_flops(c, rows=2, seq=3) == 1368 + 288


def test_bench_lm_flops_a_token():
    c = {"d_model": 1024, "d_ff": 4096, "vocab_size": 32768, "n_layers": 12}
    per_token = lm.lm_flops(c, 16, 1024) / (16 * 1024)
    assert 1.17e9 < per_token < 1.20e9


def test_resnet_macs_by_hand():
    c = {"image": [4, 4, 3], "stage_sizes": [1, 1], "num_classes": 5}
    stem = 4 * 4 * 3 * 64 * 9
    block1 = 2 * (4 * 4 * 64 * 64 * 9)
    # stage 2 strides to 2x2: two 3x3 convs and the 1x1 projection
    block2 = 2 * 2 * 64 * 128 * 9 + 2 * 2 * 128 * 128 * 9 + 2 * 2 * 64 * 128
    head = 128 * 5
    assert resnet18.resnet_macs_per_image(c) == stem + block1 + block2 + head


def test_resnet18_cifar_macs():
    c = {"image": [32, 32, 3], "stage_sizes": [2, 2, 2, 2],
         "num_classes": 10}
    assert 0.55e9 < resnet18.resnet_macs_per_image(c) < 0.56e9


def test_flash_bound_by_hand():
    b, s, h, d = 1, 4, 1, 2
    sec, fl, by = flash_fwd = flops.flash_kernel_bound(
        "flash_fwd", b, s, h, d, True, 2)
    pairs = 10
    assert fl == 4 * d * pairs
    assert by == 4 * (b * s * h * d) * 2 + 4 * (b * h * s)
    assert sec == max(fl / peaks.BF16_FLOPS, by / peaks.HBM_BYTES_PER_S)
    del flash_fwd


def test_attention_bound_sums_three_kernels_a_layer():
    config = {"n_heads": 16, "d_model": 1024, "n_layers": 12}
    traffic = {"batch_per_rank": 16, "seq_len": 1024}
    one = sum(flops.flash_kernel_bound(k, 16, 1024, 16, 64, True, 2)[0]
              for k in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"))
    assert flops.attention_bound_s(config, traffic) == pytest.approx(12 * one)
    # PR 7's table: 0.0404 + 0.0696 + 0.0522 ms a layer
    assert one * 1e3 == pytest.approx(0.1622, abs=2e-3)


def test_codec_bytes_by_hand():
    # 1000 elements: 8 rows of 128 (1024 codes) and one scale
    assert blockq.wire_bytes(1000) == 1024 + 4
    assert flops.codec_bytes([1000], 8, 2) == 4000 + 1028 + 2 * 1028 + 4000
    # a full tile of 512 x 128 and a second one for the rest
    assert blockq.wire_bytes(65537) == 2 * 65536 + 8


def test_worst_gap_uses_the_median_floor():
    ref = {"a": 1.0, "b": 2.0, "c": 3.0, "z": 0.0}
    prog = {"a": 1.1, "b": 2.0, "c": 3.0, "z": 0.0}
    gap, leaf = check.worst_gap(prog, ref, list(ref))
    assert leaf == "a" and gap == pytest.approx(0.1 / 2.0)
    prog["z"] = 0.5
    gap, leaf = check.worst_gap(prog, ref, list(ref))
    assert leaf == "z" and gap == pytest.approx(0.25)


def test_quiet_leaves_are_left_out_of_the_change():
    steps = [{"a": 1.0, "b": 1.0, "q": 1e-5}, {"a": 1.0, "b": 1.0,
                                               "q": 1e-4}]
    assert check.moving_leaves(steps) == ["a", "b"]


def test_judge_fails_a_non_finite_number():
    read = {"loss_gap": math.nan, "grad_gap": 0.0, "change_gap": 0.0}
    ok, out = check.judge(read, {"loss_gap": 1, "grad_gap": 1,
                                 "change_gap": 1})
    assert not ok and out["grad_gap"] == [0.0, 1.0]
