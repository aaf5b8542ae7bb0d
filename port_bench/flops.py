"""Operations and bytes of a step, counted from the configuration's shapes.

The model's FLOPs a step are its family's (``families/<model>.py::
step_flops``); what follows serves every family and the readers.

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


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


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
    """The three kernels' bound over ``n_layers`` layers of causal
    attention with ``n_heads`` heads of ``d_model / n_heads`` in bf16."""
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
