"""Gradient codecs — the pluggable compression hook.

Counterpart of `pytorch_ps_mpi_tpu/ops/codecs.py`: its gradient codecs
and its host-side parameter wire codecs (identity, bf16 bits, int8
blocks; `encode_wire_tree`), but for the delta framing of the serve
tier's DELT frames, which comes with that tier.  A codec encodes
one rank's gradient into a code of static shape, and ``decode_sum`` turns
the codes gathered from every rank (each leaf with a leading world dim)
into the **sum** of the decoded gradients — the reference's
decode-then-``sum(grads)``.  ``wire_bytes`` gives the on-wire payload for
the ``packaged_bytes`` metric.

``decode_sum_leaves`` decodes all the leaves of a step at once: the PS
step calls it once after the gathers, and the codecs with a grouped
kernel run every leaf in one launch.

Every gradient codec of the JAX package is ported: ``identity``, ``bf16``
(`CastCodec`, decode-sum on the ``cast_sum`` kernel), ``blockq``
(`BlockQuantizeCodec`, on the ``block_quantize`` and ``block_dequant_sum``
kernels), ``topk``/``topk_approx`` (`TopKCodec`), ``quantize``
(`QuantizeCodec`) and ``sign`` (`SignCodec`, signs packed 8 to a byte);
the last three decode through the generic per-leaf loop (their JAX
counterparts are jnp, not Pallas kernels).

A codec whose wire depends on the element order (``ordered``: blockq's
tiles, topk's indices, sign's packed bytes, quantize's code array) is
handed each gradient in the JAX package's layout by the PS step
(`utils.interop.jax_order`), so its codes equal the JAX package's.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Any

import numpy as np
import torch

from ..utils.flatten import tree_leaves, tree_map
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
    # Whether the wire depends on the elements' order (the PS step then
    # encodes each gradient in the JAX package's layout); False for the
    # codecs that are elementwise end to end.
    ordered = True
    # Whether ``decode`` recovers a single contribution's gradient.  True
    # for every codec here; a sketch-style codec whose only decodable
    # quantity is the cross-contributor sum sets it False, and
    # `ops.robust.check_reducer_codec` then refuses any reducer that needs
    # per-contribution decodes.
    itemwise_decode = True

    def encode(self, grad: torch.Tensor) -> Code:
        raise NotImplementedError

    def decode(self, code: Code, *, shape=None, dtype=None) -> torch.Tensor:
        raise NotImplementedError

    def decode_sum(self, codes: Code, *, shape, dtype) -> torch.Tensor:
        """Generic form: decode each rank's code (each leaf of the code
        indexed by rank) and add them in rank order (codecs with a fused
        kernel override)."""
        world = tree_leaves(codes)[0].shape[0]
        out = None
        for r in range(world):
            d = self.decode(tree_map(lambda c, r=r: c[r], codes),
                            shape=shape, dtype=dtype)
            out = d if out is None else out + d
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

    def scale_code(self, code: Code, w) -> Code:
        """Scale the *decoded value* of a code by the scalar ``w`` without
        decoding it: every floating leaf times ``w`` cast to the leaf's
        dtype (bf16 wire in bf16, as the JAX package's ``x *
        w.astype(x.dtype)``); integer leaves (indices, quantized planes,
        packed signs) stay as they are.  The async PS's contribution
        weights ride this hook, so its fused decode-sum survives.

        The contract is linearity, ``decode(scale_code(c, w)) == w *
        decode(c)``: a code may carry at most one floating "magnitude"
        factor per decoded element (blockq's ``scales``, topk's
        ``values``, quantize's and sign's ``scale``).  A codec whose
        decode multiplies two floating leaves must override this.  The
        row case of `scale_codes`."""
        one = self.scale_codes(tree_map(lambda x: x[None], code),
                               torch.as_tensor(w).reshape(1))
        return tree_map(lambda x: x[0], one)

    def scale_codes(self, codes: Code, weights: torch.Tensor) -> Code:
        """`scale_code` over codes with a leading contributor dim: row
        ``i`` of every floating leaf times ``weights[i]`` — one broadcast
        multiply a leaf (the JAX package's ``vmap(scale_code)``); the
        async PS's weighted fills call it."""
        def scale(x):
            if not x.is_floating_point():
                return x
            w = weights.to(device=x.device, dtype=x.dtype)
            return x * w.reshape((-1,) + (1,) * (x.dim() - 1))
        return tree_map(scale, codes)

    def __repr__(self) -> str:  # pragma: no cover
        return f"{type(self).__name__}()"


class IdentityCodec(Codec):
    """No compression — the default path.  With this codec the PS step's
    gather+decode+sum is a single all-reduce."""

    name = "identity"
    ordered = False

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

    ordered = False

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
        # A permuted (non-contiguous) leaf costs one copy: the cast to f32
        # writes it in order, or the reshape copies it.
        flat = grad.to(torch.float32,
                       memory_format=torch.contiguous_format).reshape(-1)
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


def _top_k_indices(mag: torch.Tensor, k: int) -> torch.Tensor:
    """The indices ``lax.top_k`` selects, in its order: magnitudes
    descending, and among equal magnitudes the lower index first (a NaN
    above every number).  ``torch.topk`` breaks ties in another order, so
    it only finds the k-th magnitude ``t``: every element above ``t``
    (or NaN) is kept, and the candidates at or above it, taken in index
    order, are sorted stably by magnitude, which keeps the lowest indices
    among the ties at ``t``."""
    t = torch.topk(mag, k).values[-1]  # NaNs sort first
    if torch.isnan(t):  # every one of the k is NaN
        cand = torch.nonzero(torch.isnan(mag)).reshape(-1)
    else:
        cand = torch.nonzero((mag >= t) | torch.isnan(mag)).reshape(-1)
    order = torch.sort(mag[cand], descending=True, stable=True).indices
    return cand[order[:k]]


class TopKCodec(Codec):
    """Magnitude top-k sparsification: ``k`` (value, int32 index) pairs a
    leaf, ``k`` fixed per shape (``fraction`` of the element count,
    floored at 1, or ``k``), so codes have static shapes.  ``decode_sum``
    scatter-adds the rank-flattened values into a zero tensor with
    ``index_put_(accumulate=True)``: indices repeat across ranks, and on
    the card that call sorts the indices and adds each one's values in
    rank order, so the sum does not depend on the order of atomics.

    ``approx=True`` is the JAX package's ``lax.approx_max_k``, which
    returns at least ``recall_target`` of the true top-k; here the exact
    selection runs (recall 1.0 meets any target), as the JAX
    package's own selection does on the CPU.  The wire format is the
    same, so exact and approximate ranks interoperate."""

    name = "topk"

    def __init__(self, fraction: float = 0.01, k: int | None = None,
                 approx: bool = False, recall_target: float = 0.95):
        if k is not None and k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        if k is None and not 0.0 < fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got {fraction}")
        if not 0.0 < recall_target <= 1.0:
            raise ValueError(
                f"recall_target must be in (0, 1], got {recall_target}")
        self.fraction = fraction
        self.k = k
        self.approx = approx
        self.recall_target = recall_target

    def _k_for(self, n: int) -> int:
        k = (self.k if self.k is not None
             else max(1, int(math.ceil(self.fraction * n))))
        return min(k, n)

    def encode(self, grad):
        flat = grad.reshape(-1)
        idx = _top_k_indices(flat.abs(), self._k_for(flat.numel()))
        return {"values": flat[idx], "indices": idx.to(torch.int32)}

    def decode(self, code, *, shape=None, dtype=None):
        if shape is None:
            raise ValueError("TopKCodec.decode needs the dense shape")
        values = code["values"]
        dense = values.new_zeros((math.prod(shape),),
                                 dtype=dtype or values.dtype)
        dense[code["indices"].long()] = values.to(dense.dtype)
        return dense.view(shape)

    def decode_sum(self, codes, *, shape, dtype):
        values = codes["values"].reshape(-1)
        dense = values.new_zeros((math.prod(shape),),
                                 dtype=dtype or values.dtype)
        dense.index_put_((codes["indices"].reshape(-1).long(),),
                         values.to(dense.dtype), accumulate=True)
        return dense.view(shape)

    def wire_bytes(self, shape, dtype):
        k = self._k_for(math.prod(shape))
        return k * (_itemsize(dtype) + 4)  # value + int32 index


class QuantizeCodec(Codec):
    """Symmetric per-tensor linear quantization to int8 (or int16):
    ``scale = max|g| / qmax``, code ``{q: int[shape], scale: f32[]}``.  The
    scale divides by a tensor (on the card a division by a Python number
    is a multiply by its reciprocal), in the gradient's dtype as JAX's
    weak-typed ``amax / qmax`` is; the codes round half to even, and a NaN
    becomes code 0, as XLA's conversion makes it."""

    name = "quantize"

    def __init__(self, bits: int = 8):
        if bits not in (8, 16):
            raise ValueError("bits must be 8 or 16")
        self.bits = bits
        self.qdtype = torch.int8 if bits == 8 else torch.int16
        self.qmax = float(2 ** (bits - 1) - 1)

    def encode(self, grad):
        amax = grad.abs().amax()
        scale = torch.where(amax > 0, amax / amax.new_full((), self.qmax),
                            amax.new_ones(())).to(torch.float32)
        q = torch.clamp(torch.round(grad.to(torch.float32) / scale),
                        -self.qmax, self.qmax)
        q = torch.where(torch.isnan(q), q.new_zeros(()), q)
        return {"q": q.to(self.qdtype), "scale": scale}

    def decode(self, code, *, shape=None, dtype=None):
        dtype = torch.float32 if dtype is None else dtype
        return code["q"].to(dtype) * code["scale"].to(dtype)

    def wire_bytes(self, shape, dtype):
        return math.prod(shape) * (self.bits // 8) + 4


_SHIFTS = (0, 1, 2, 3, 4, 5, 6, 7)


def pack_signs(flat: torch.Tensor) -> torch.Tensor:
    """``flat`` ``(n,)`` with n % 8 == 0 -> uint8 ``(n//8,)`` of sign bits
    (bit k of byte b is the sign of element 8*b+k; 1 means >= 0; NaN is
    0).  Torch bit operations, the JAX package's jnp ``pack_signs``."""
    shifts = torch.tensor(_SHIFTS, dtype=torch.int32, device=flat.device)
    bits = (flat >= 0).to(torch.int32).view(-1, 8)
    return (bits << shifts).sum(dim=1).to(torch.uint8)


def unpack_signs(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of `pack_signs`: uint8 ``(n//8,)`` -> f32 ``(n,)`` of ±1."""
    shifts = torch.tensor(_SHIFTS, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[:, None] >> shifts) & 1
    return (bits.to(torch.float32) * 2.0 - 1.0).reshape(-1)[:n]


class SignCodec(Codec):
    """1-bit sign compression with a mean-|g| scale: the signs packed 8 to
    a byte (`pack_signs`; the tail padded with +1s, which decode drops)
    and one f32 scale, the mean in f32 rounded to the gradient's dtype as
    ``jnp.mean`` gives it.  The mean sums in another order than XLA's, so
    the scale agrees with the JAX package's to a few ulps, not bitwise."""

    name = "sign"

    def encode(self, grad):
        flat = grad.reshape(-1)
        pad = (-flat.numel()) % 8
        if pad:
            flat = torch.cat([flat, flat.new_ones((pad,))])
        scale = grad.abs().mean(dtype=torch.float32).to(grad.dtype).to(
            torch.float32)
        return {"sign": pack_signs(flat), "scale": scale}

    def decode(self, code, *, shape=None, dtype=None):
        if shape is None:
            raise ValueError("SignCodec.decode needs the dense shape")
        dtype = torch.float32 if dtype is None else dtype
        sign = unpack_signs(code["sign"], math.prod(shape)).to(dtype)
        return (sign * code["scale"].to(dtype)).view(shape)

    def wire_bytes(self, shape, dtype):
        n = math.prod(shape)
        return (n + (-n) % 8) // 8 + 4


_TABLE = {"identity": IdentityCodec, "bf16": CastCodec, "topk": TopKCodec,
          "topk_approx": lambda: TopKCodec(approx=True),
          "quantize": QuantizeCodec, "sign": SignCodec,
          "blockq": BlockQuantizeCodec}


def get_codec(spec) -> Codec:
    """Resolve a codec from an instance, ``None`` (identity) or a name
    (the JAX package's table)."""
    if spec is None:
        return IdentityCodec()
    if isinstance(spec, Codec):
        return spec
    if spec not in _TABLE:
        raise ValueError(f"unknown codec {spec!r}; have {sorted(_TABLE)}")
    return _TABLE[spec]()


# ---------------------------------------------------------------------------
# The server->reader parameter WIRE codec (protocol v12): host-side numpy.
#
# Copied from the JAX package, bit for bit.  The multihost server runs
# it on its connection threads (`multihost_async.AsyncPSServer
# ._parm_payload`), once per served version before
# `native.serializer.encode_segments`; frames carry a one-byte codec id
# (`WIRE_CODEC_IDS`), so readers decode from the frame alone.
#
# Wire representations (per f32 leaf; every other dtype passes through
# untouched — a lossy cast of an integer step counter would corrupt it):
#   bf16:  {"__psw_b16": uint16[shape]}   — round-to-nearest-even high
#          halves of the f32 bits (decode is a bit shift; no ml_dtypes).
#   int8:  {"__psw_q": int8[nblk, B], "__psw_s": f32[nblk],
#           "__psw_sh": int64[ndim]}      — flat blocks of at most 4,096
#          elements with a symmetric per-block scale.
# ---------------------------------------------------------------------------

WIRE_CODEC_IDS = {"identity": 0, "bf16": 1, "int8": 2}
WIRE_CODEC_NAMES = {v: k for k, v in WIRE_CODEC_IDS.items()}
_WIRE_BLOCK = 4096


def wire_codec_id(name: str) -> int:
    """Resolve a wire-codec name to its frame id byte (loud on drift)."""
    if name not in WIRE_CODEC_IDS:
        raise ValueError(
            f"unknown wire codec {name!r}; have {sorted(WIRE_CODEC_IDS)}")
    return WIRE_CODEC_IDS[name]


def _f32_to_bf16_bits(a: np.ndarray) -> np.ndarray:
    """f32 -> bf16 as raw uint16 bits, round-to-nearest-even, NaN
    payloads quieted instead of rounding into an inf."""
    a = np.ascontiguousarray(a, np.float32)
    u = a.view(np.uint32)
    bias = np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
    r = ((u + bias) >> np.uint32(16)).astype(np.uint16)
    nan = np.isnan(a)
    if nan.any():
        r = np.where(nan,
                     ((u >> np.uint32(16)).astype(np.uint16)
                      | np.uint16(0x0040)), r)
    return r


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (np.ascontiguousarray(bits, np.uint16).astype(np.uint32)
            << np.uint32(16)).view(np.float32)


def _wire_block_for(n: int) -> int:
    """Per-leaf quantization block length: the smallest 64-aligned block
    that holds a small leaf, else 4,096 — derived from the element count
    alone, so encoder and decoder agree without shipping it."""
    return min(_WIRE_BLOCK, max(64, -(-n // 64) * 64))


def _f32_to_blockq(a: np.ndarray):
    flat = np.ascontiguousarray(a, np.float32).reshape(-1)
    n = flat.size
    blk = _wire_block_for(n)
    nblk = max(1, -(-n // blk))
    pad = nblk * blk - n
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    blocks = flat.reshape(nblk, blk)
    amax = np.abs(blocks).max(axis=1)
    scales = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(blocks / scales[:, None]), -127, 127).astype(np.int8)
    return q, scales


def _blockq_to_f32(q: np.ndarray, scales: np.ndarray,
                   shape) -> np.ndarray:
    n = int(np.prod(shape, dtype=np.int64))
    out = (q.astype(np.float32) * scales[:, None]).reshape(-1)[:n]
    return out.reshape(shape)


def _is_wire_leaf(x) -> bool:
    return isinstance(x, dict) and ("__psw_b16" in x or "__psw_q" in x)


def _map_host(fn, tree, is_leaf=None):
    """``fn`` over the leaves of a tree of dicts, lists and tuples (the
    container types kept), ``is_leaf`` marking subtrees taken whole."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, _map_host(fn, v, is_leaf))
                          for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_host(fn, v, is_leaf) for v in tree)
    return fn(tree)


def encode_wire_tree(name: str, tree):
    """Apply the wire codec to every f32 leaf of a (numpy) tree — the
    encode-once half the server runs per served version.  Identity
    returns the tree unchanged (no copy: the segmented encoder's
    zero-copy views keep aliasing the served arrays)."""
    if wire_codec_id(name) == 0:
        return tree

    def enc(leaf):
        if isinstance(leaf, torch.Tensor):
            return leaf  # a bf16 leaf: not f32, passes through
        a = np.asarray(leaf)
        if a.dtype != np.float32:
            return a
        if name == "bf16":
            return {"__psw_b16": _f32_to_bf16_bits(a)}
        q, scales = _f32_to_blockq(a)
        sh = np.asarray(a.shape, np.int64)
        if q.nbytes + scales.nbytes + sh.nbytes >= a.nbytes:
            # Sub-block leaf: the padded int8 form would inflate the
            # wire — ship it raw f32.
            return a
        return {"__psw_q": q, "__psw_s": scales, "__psw_sh": sh}

    return _map_host(enc, tree)


def decode_wire_tree(codec, tree):
    """Invert `encode_wire_tree` from the frame's codec id (or name):
    every marker-dict leaf expands back to a dense f32 array; pass-
    through leaves return as they are."""
    name = (WIRE_CODEC_NAMES.get(codec, None)
            if isinstance(codec, int) else codec)
    if name is None:
        raise ValueError(f"unknown wire codec id {codec!r}")
    if wire_codec_id(name) == 0:
        return tree

    def dec(leaf):
        if not _is_wire_leaf(leaf):
            return leaf
        if "__psw_b16" in leaf:
            return _bf16_bits_to_f32(leaf["__psw_b16"])
        return _blockq_to_f32(leaf["__psw_q"], leaf["__psw_s"],
                              tuple(int(d) for d in leaf["__psw_sh"]))

    return _map_host(dec, tree, is_leaf=_is_wire_leaf)


def tree_raw_nbytes(tree) -> int:
    """Total leaf payload bytes of a host tree — the f32-baseline
    numerator of the ``parm_bytes_raw``/``parm_bytes_wire`` ratio."""
    return int(sum(_leaf_nbytes(leaf) for leaf in tree_leaves(tree)))


# -- delta framing (protocol v12, the DELT delta path) ----------------------
#
# A delta leaf is {"__psd_i": uint32 flat indices, "__psd_v": changed
# values} against the reader's known version of the SAME decoded tree;
# a leaf whose shape/dtype changed (never in steady state) ships whole
# as {"__psd_full": array}.  Patching writes the server's decoded-
# current values at the changed positions, so the patched reader tree
# is bitwise the full-snapshot decode — delta vs full is a pure wire-
# size decision.  Copied from the JAX package; a leaf is a numpy array
# or, for bfloat16 (no numpy dtype), a CPU tensor, compared by value
# with ``!=`` as numpy compares (``-0.0 == +0.0``, NaN always changed).


def _leaf_meta(a):
    if isinstance(a, torch.Tensor):
        return tuple(a.shape), a.dtype
    return a.shape, a.dtype


def _leaf_nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return np.asarray(a).nbytes


def diff_wire_delta(base_tree, cur_tree):
    """Per-leaf sparse diff ``base -> cur`` over two same-structure host
    trees: ``(delta_tree, payload_bytes)``.  Bytes count the index+value
    payloads only (framing is per-frame constant), so the server can
    compare against the full snapshot's wire size and fall back when the
    tree churned too much for a delta to win."""
    delta = OrderedDict()
    nbytes = 0
    for n2, cur in cur_tree.items():
        if not isinstance(cur, torch.Tensor):
            cur = np.asarray(cur)
        base = base_tree.get(n2)
        if base is not None and not isinstance(base, torch.Tensor):
            base = np.asarray(base)
        if (base is None or type(base) is not type(cur)
                or _leaf_meta(base) != _leaf_meta(cur)):
            delta[n2] = {"__psd_full": cur}
            nbytes += _leaf_nbytes(cur)
            continue
        if isinstance(cur, torch.Tensor):
            changed = (base != cur).reshape(-1).numpy()
            idx = np.flatnonzero(changed).astype(np.uint32)
            vals = cur.reshape(-1)[torch.from_numpy(idx.astype(np.int64))]
        else:
            changed = (base != cur).reshape(-1)
            idx = np.flatnonzero(changed).astype(np.uint32)
            vals = cur.reshape(-1)[idx]
        delta[n2] = {"__psd_i": idx, "__psd_v": vals}
        nbytes += idx.nbytes + _leaf_nbytes(vals)
    return delta, nbytes


def apply_wire_delta(base_tree, delta_tree):
    """Patch a reader's decoded tree with a `diff_wire_delta` payload —
    unchanged leaves alias the base (no copy), patched leaves are fresh
    arrays (the reader's cached tree may be arena views)."""
    out = OrderedDict()
    for n2, d in delta_tree.items():
        if "__psd_full" in d:
            full = d["__psd_full"]
            out[n2] = (full if isinstance(full, torch.Tensor)
                       else np.asarray(full))
            continue
        base = base_tree[n2]
        if not isinstance(base, torch.Tensor):
            base = np.asarray(base)
        idx = np.asarray(d["__psd_i"])
        if idx.size == 0:
            out[n2] = base
            continue
        if isinstance(base, torch.Tensor):
            flat = base.reshape(-1).clone()
            flat[torch.from_numpy(idx.astype(np.int64))] = d["__psd_v"]
        else:
            flat = np.array(base, copy=True).reshape(-1)
            flat[idx] = d["__psd_v"]
        out[n2] = flat.reshape(base.shape)
    return out
