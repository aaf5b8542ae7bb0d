"""Operations and bytes of a step, counted from the configuration's shapes.

* `step_flops`: the model's FLOPs a step for one rank's shard, forward and
  backward: every convolution and dense layer's multiply-adds times two
  times three, and for the LM the causal attention's two products (only
  the unmasked query-key pairs) times three.
* `attention_bound_s`: the least time a step's attention could take on
  the chip, kernel by kernel (forward, dK/dV, dQ), whatever runs it: the
  larger of operations over the bf16 peak and bytes (each input read once,
  each output written once) over the bandwidth; the arithmetic of the
  port's ``chip_smoke.py::_flash_bound``, copied.
* `codec_bound_s`: the least time to encode a step's gradient and decode
  and sum the world's codes: each f32 gradient byte read once and each
  code byte written once, then ``world`` codes read and one f32 sum
  written, over the bandwidth.
"""

from __future__ import annotations

import math

from . import peaks
from .reference import blockq


def _lm_matmul_params(c: dict) -> int:
    d, ff, v = c["d_model"], c["d_ff"], c["vocab_size"]
    per_layer = 3 * d * d + d * d + d * ff + ff * d
    return c["n_layers"] * per_layer + d * v


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def lm_flops(c: dict, rows: int, seq: int) -> float:
    tokens = rows * seq
    matmul = 6.0 * _lm_matmul_params(c) * tokens
    attention = 3.0 * 4.0 * c["d_model"] * causal_pairs(seq) * rows \
        * c["n_layers"]
    return matmul + attention


def resnet_macs_per_image(c: dict) -> int:
    """Multiply-adds of one image through the CIFAR-form ResNet with basic
    blocks: the 3x3 stem, each block's two 3x3 convolutions and its 1x1
    projection where the shape changes, and the dense head."""
    h, w, ch = c["image"]
    macs = h * w * ch * 64 * 9
    in_ch = 64
    for stage, blocks in enumerate(c["stage_sizes"]):
        filters = 64 * 2 ** stage
        for j in range(blocks):
            stride = 2 if stage > 0 and j == 0 else 1
            h, w = -(-h // stride), -(-w // stride)
            macs += h * w * in_ch * filters * 9
            macs += h * w * filters * filters * 9
            if stride != 1 or in_ch != filters:
                macs += h * w * in_ch * filters
            in_ch = filters
    return macs + in_ch * c["num_classes"]


def step_flops(config: dict, traffic: dict) -> float:
    """FLOPs of one rank's step, forward and backward."""
    rows = int(traffic["batch_per_rank"])
    if config["model"] == "lm":
        return lm_flops(config, rows, int(traffic["seq_len"]))
    return 3.0 * 2.0 * resnet_macs_per_image(config) * rows


def flash_kernel_bound(kernel: str, b: int, s: int, h: int, d: int,
                       causal: bool, elt: int):
    """``(bound seconds, flops, bytes)`` of one attention kernel call."""
    pairs = causal_pairs(s) if causal else s * s
    n, rows = b * s * h * d, b * h * s
    flops, nbytes = {
        "flash_fwd": (4 * d * pairs * b * h, 4 * n * elt + 4 * rows),
        "flash_bwd_dkdv": (8 * d * pairs * b * h, 6 * n * elt + 8 * rows),
        "flash_bwd_dq": (6 * d * pairs * b * h, 5 * n * elt + 8 * rows),
    }[kernel]
    return (max(flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES_PER_S),
            flops, nbytes)


def attention_bound_s(config: dict, traffic: dict) -> float:
    b, s = int(traffic["batch_per_rank"]), int(traffic["seq_len"])
    h = config["n_heads"]
    d = config["d_model"] // h
    one = sum(flash_kernel_bound(k, b, s, h, d, True, 2)[0]
              for k in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"))
    return one * config["n_layers"]


def codec_bytes(leaf_sizes, bits: int, world: int) -> int:
    total = 0
    for n in leaf_sizes:
        wire = blockq.wire_bytes(n, bits)
        total += 4 * n + wire          # encode: read f32, write codes
        total += world * wire + 4 * n  # decode-sum: read codes, write f32
    return total


def codec_bound_s(leaf_sizes, bits: int, world: int) -> float:
    return codec_bytes(leaf_sizes, bits, world) / peaks.HBM_BYTES_PER_S


def leaf_sizes(shapes) -> "list[int]":
    return [math.prod(s) for s in shapes.values()]
