"""A frozen copy of the blockq codec's arithmetic (the wire format).

Each gradient is laid out in the flax element order the port encodes in
(conv kernels ``OIHW -> HWIO``, dense kernels ``(out, in) -> (in, out)``),
flattened, zero-padded to tiles of ``rows x 128`` elements (``rows`` the
smallest multiple of 8 that holds the leaf, at most 512) and quantized per
tile: ``scale = amax / qmax`` (1 where ``amax`` is 0), codes
``clip(round_half_even(x / scale), +-qmax)``.  A rank's decoded gradient
is ``codes * scale``; the sum over ranks adds them in rank order from rank
0's, in float32.
"""

from __future__ import annotations

import re
from collections import OrderedDict

import torch

LANE = 128
BLOCK_ROWS = 512

_CONV = re.compile(r"(^|\.)Conv_\d+\.weight$")
_DENSE = re.compile(
    r"((^|\.)Dense_\d+|^block_\d+\.(qkv|out|fc1|fc2)|^lm_head)\.weight$")


def wire_order(name: str, shape) -> "tuple[int, ...] | None":
    """The permutation from the port's layout to the wire's, or None."""
    if len(shape) == 4 and _CONV.search(name):
        return (2, 3, 1, 0)
    if len(shape) == 2 and _DENSE.search(name):
        return (1, 0)
    return None


def rows_for(n: int) -> int:
    need = -(-n // LANE)
    return min(BLOCK_ROWS, max(8, -(-need // 8) * 8))


def quantize(flat: torch.Tensor, bits: int):
    """``(codes as f32, scales)`` of a flat f32 tensor, tile by tile."""
    qmax = float(2 ** (bits - 1) - 1)
    n = flat.numel()
    tile = rows_for(n) * LANE
    blocks = -(-n // tile)
    padded = flat.new_zeros(blocks * tile)
    padded[:n] = flat
    x = padded.view(blocks, tile)
    amax = x.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax / amax.new_full((), qmax),
                        amax.new_ones(()))
    q = torch.clamp(torch.round(x / scale), -qmax, qmax)
    return q, scale


def roundtrip(grads: "OrderedDict[str, torch.Tensor]", *, bits: int = 8):
    """Each leaf decoded from its own codes (one rank's contribution), in
    the port's layout."""
    out = OrderedDict()
    for name, g in grads.items():
        order = wire_order(name, g.shape)
        wire = g.to(torch.float32)
        if order is not None:
            wire = wire.permute(order)
        flat = wire.contiguous().reshape(-1)
        q, scale = quantize(flat, bits)
        dec = (q * scale).reshape(-1)[:flat.numel()].view(wire.shape)
        if order is not None:
            inv = [0] * len(order)
            for i, o in enumerate(order):
                inv[o] = i
            dec = dec.permute(inv)
        out[name] = dec.contiguous()
    return out


def sum_ranks(decoded: "list[OrderedDict]") -> "OrderedDict":
    """The sum over ranks, in rank order."""
    total = OrderedDict((n, t.clone()) for n, t in decoded[0].items())
    for d in decoded[1:]:
        for n in total:
            total[n] = total[n] + d[n]
    return total


def wire_bytes(n: int, bits: int = 8) -> int:
    """Bytes one leaf of ``n`` elements puts on the wire: its padded codes
    and one f32 scale a tile."""
    tile = rows_for(n) * LANE
    blocks = max(1, -(-n // tile))
    return blocks * tile * (bits // 8) + blocks * 4
