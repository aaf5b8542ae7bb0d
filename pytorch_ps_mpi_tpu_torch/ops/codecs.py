"""Gradient codecs — the pluggable compression hook.

Counterpart of `pytorch_ps_mpi_tpu/ops/codecs.py` (its gradient codecs;
the host-side parameter wire codecs are not ported yet).  A codec encodes
one rank's gradient into a code of static shape, and ``decode_sum`` turns
the codes gathered from every rank (each leaf with a leading world dim)
into the **sum** of the decoded gradients — the reference's
decode-then-``sum(grads)``.  ``wire_bytes`` gives the on-wire payload for
the ``packaged_bytes`` metric.

``decode_sum_leaves`` decodes all the leaves of a step at once: the PS
step calls it once after the gathers, and the codecs with a grouped
kernel run every leaf in one launch.

Ported: ``identity``, ``bf16`` (`CastCodec`, decode-sum on the
``cast_sum`` kernel) and ``blockq`` (`BlockQuantizeCodec`, on the
``block_quantize`` and ``block_dequant_sum`` kernels).  ``topk``,
``quantize`` and ``sign`` are not ported yet, and `get_codec` refuses them.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Any

import torch

from . import codec_kernels as ck

Code = Any


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _as_grad(flat: torch.Tensor, shape, dtype) -> torch.Tensor:
    """A decoded f32 leaf in its gradient's shape and dtype (f32 when
    ``dtype`` is None)."""
    out = flat.view(shape)
    return out if dtype in (None, torch.float32) else out.to(dtype)


def _as_grads(metas, views) -> "OrderedDict":
    """A group's decoded leaves as the named gradients of ``metas``."""
    return OrderedDict((name, _as_grad(v, shape, dtype))
                       for (name, (shape, dtype)), v in zip(metas.items(),
                                                            views))


class Codec:
    """Interface: ``encode(grad) -> code`` / ``decode(code, shape=,
    dtype=) -> grad``; ``decode_sum(codes, shape=, dtype=)`` is the
    hot-path hook over codes with a leading world dim, and
    ``wire_bytes(shape, dtype)`` the on-wire payload size."""

    name = "codec"

    def encode(self, grad: torch.Tensor) -> Code:
        raise NotImplementedError

    def decode(self, code: Code, *, shape=None, dtype=None) -> torch.Tensor:
        raise NotImplementedError

    def decode_sum(self, codes: Code, *, shape, dtype) -> torch.Tensor:
        """Generic form for a single-tensor code: decode each rank's code
        and add them in rank order (codecs with a fused kernel override)."""
        out = self.decode(codes[0], shape=shape, dtype=dtype)
        for r in range(1, codes.shape[0]):
            out = out + self.decode(codes[r], shape=shape, dtype=dtype)
        return out

    def decode_sum_leaves(self, gathered, metas) -> "OrderedDict":
        """`decode_sum` over all the leaves of a step: ``gathered`` maps
        each name to its codes with a leading world dim, ``metas`` is an
        ordered dict ``name -> (shape, dtype)``.  Returns the summed
        gradients in ``metas``' order.  This generic form decodes leaf by
        leaf; codecs with a grouped kernel override it."""
        return OrderedDict(
            (name, self.decode_sum(gathered[name], shape=shape, dtype=dtype))
            for name, (shape, dtype) in metas.items())

    def wire_bytes(self, shape, dtype) -> int:
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover
        return f"{type(self).__name__}()"


class IdentityCodec(Codec):
    """No compression — the default path.  With this codec the PS step's
    gather+decode+sum is a single all-reduce."""

    name = "identity"

    def encode(self, grad):
        return grad

    def decode(self, code, *, shape=None, dtype=None):
        return code

    def wire_bytes(self, shape, dtype):
        return math.prod(shape) * _itemsize(dtype)


class CastCodec(Codec):
    """Dtype-cast compression — ship gradients as bfloat16 (or float16).

    Halves the all-gather payload of f32 gradients; the decode-sum
    accumulates in f32 (`ops.codec_kernels.cast_sum`), so only the per-rank
    *representation* is lossy, not the reduction."""

    def __init__(self, dtype=torch.bfloat16):
        if dtype not in (torch.bfloat16, torch.float16):
            raise ValueError(f"CastCodec ships bfloat16 or float16, got "
                             f"{dtype}")
        self.wire_dtype = dtype
        # Name tracks the wire dtype, as the JAX codec's does.
        self.name = "bf16" if dtype == torch.bfloat16 else "f16"

    def encode(self, grad):
        return grad.to(self.wire_dtype)

    def decode(self, code, *, shape=None, dtype=None):
        return code.to(torch.float32 if dtype is None else dtype)

    def decode_sum(self, codes, *, shape, dtype):
        """Wire dtype -> f32-accumulate cross-rank sum in one pass over
        the wire bytes (the JAX codec pads to ``rows_for_flat`` tiles for
        the TPU; that padding is layout, not wire format, and the kernel
        here reads the flat ``(world, n)`` codes)."""
        world = codes.shape[0]
        out = ck.cast_sum(codes.reshape(world, math.prod(shape)))
        return _as_grad(out, shape, dtype)

    def decode_sum_leaves(self, gathered, metas):
        """Every leaf in one grouped ``cast_sum`` launch."""
        _, views = ck.cast_sum_group(
            gathered[name].reshape(gathered[name].shape[0], math.prod(shape))
            for name, (shape, _) in metas.items())
        return _as_grads(metas, views)

    def wire_bytes(self, shape, dtype):
        return math.prod(shape) * _itemsize(self.wire_dtype)


class BlockQuantizeCodec(Codec):
    """Per-block int8/int16 quantization on the ``block_quantize`` kernel.

    Gradients are tiled into ``block_rows*128``-element blocks, each with
    its own scale; ``decode_sum`` fuses dequantize with the cross-rank sum
    (``block_dequant_sum``)."""

    name = "blockq"

    def __init__(self, bits: int = 8, block_rows: int | None = None):
        if bits not in (8, 16):
            raise ValueError("bits must be 8 or 16")
        self.bits = bits
        self.block_rows = (block_rows if block_rows is not None
                           else ck.BLOCK_ROWS)

    def _rows_for(self, n: int) -> int:
        """Per-tensor block height: small tensors get the smallest
        multiple of 8 rows that holds them, so a (128,) bias pads to 8*128
        elements, not a full 512*128 block (which would inflate its wire
        size ~64x).  The tile sets the scale granularity and `wire_bytes`:
        it is wire format."""
        return ck.rows_for_flat(n, self.block_rows)

    def encode(self, grad):
        flat = grad.reshape(-1).to(torch.float32)
        q, scales = ck.block_quantize(flat, bits=self.bits,
                                      block_rows=self._rows_for(flat.numel()))
        return {"q": q, "scales": scales}

    def decode(self, code, *, shape=None, dtype=None):
        if shape is None:
            raise ValueError("BlockQuantizeCodec.decode needs the dense shape")
        stacked = {"q": code["q"][None], "scales": code["scales"][None]}
        return self.decode_sum(stacked, shape=shape, dtype=dtype)

    def _leaf(self, codes, shape):
        """One gradient's gathered codes as a leaf of a decode group."""
        n = math.prod(shape)
        return codes["q"], codes["scales"], n, self._rows_for(n)

    def decode_sum(self, codes, *, shape, dtype):
        _, (out,) = ck.block_dequant_sum_group([self._leaf(codes, shape)])
        return _as_grad(out, shape, dtype)

    def decode_sum_leaves(self, gathered, metas):
        """Every leaf in one grouped ``block_dequant_sum`` launch."""
        _, views = ck.block_dequant_sum_group(
            self._leaf(gathered[name], shape)
            for name, (shape, _) in metas.items())
        return _as_grads(metas, views)

    def wire_bytes(self, shape, dtype):
        n = math.prod(shape)
        rows = self._rows_for(n)
        per_block = rows * ck.LANE
        n_blocks = max(1, -(-n // per_block))
        return n_blocks * per_block * (self.bits // 8) + n_blocks * 4


_PORTED = {"identity": IdentityCodec, "bf16": CastCodec,
           "blockq": BlockQuantizeCodec}
_NOT_PORTED = ("topk", "topk_approx", "quantize", "sign")


def get_codec(spec) -> Codec:
    """Resolve a codec from an instance, ``None`` (identity) or a name."""
    if spec is None:
        return IdentityCodec()
    if isinstance(spec, Codec):
        return spec
    if spec in _NOT_PORTED:
        raise NotImplementedError(
            f"codec {spec!r} is not ported to the PyTorch package yet; "
            f"ported: {sorted(_PORTED)}")
    if spec not in _PORTED:
        raise ValueError(f"unknown codec {spec!r}; have {sorted(_PORTED)}")
    return _PORTED[spec]()
