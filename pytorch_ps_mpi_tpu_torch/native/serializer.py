"""Zero-copy tree serialization over the native byte pipeline.

Counterpart of `pytorch_ps_mpi_tpu/native/serializer.py`, copied but for
the tree metadata:

* array payloads never pass through pickle: numpy buffer pointers go to
  the C++ shuffle+LZ pipeline through ctypes (GIL released, threaded
  across leaves for multi-MB trees);
* metadata (the tree's structure, shapes, dtypes and the user's ``meta``)
  is a small separate pickle;
* ``level=0`` stores with framing only; ``level>=1`` adds byte-shuffle +
  LZ.

Buffer frame: ``PSZ2 | flags(u8) | itemsize(u8) | orig(u64) | comp(u64) |
crc32(u32) | payload``; flags bit0 = LZ-compressed, bit1 = byte-shuffled;
crc32 covers the header bytes before the crc field plus the on-wire
payload, verified before decode.  These frames are byte for byte the JAX
package's for the same arrays.  Legacy ``PSZ1`` frames (no crc) remain
readable.

Tree frame: ``PSTP | meta_len(u64) | meta_crc32(u32) | meta_pickle |
buffer_frame*``.  The JAX package's tree frame (``PST2``, legacy
``PSTR``) pickles a JAX ``PyTreeDef`` into its metadata, which cannot be
read (or written) without JAX.  This package describes the tree with plain
Python data instead — nested ``("dict" | "odict", keys, children)``,
``("list" | "tuple", children)``, ``("none",)`` and ``"*"`` for a leaf,
flattened in JAX's leaf order (`utils.flatten`) — under a magic of its
own, ``PSTP``.  A JAX-written tree frame is refused with
`ForeignTreeFrameError`, whose message names the way across.

A ``torch.bfloat16`` leaf (the bf16 gradient codec's wire) has no numpy
dtype without ``ml_dtypes``: it crosses as its 16-bit patterns (an
``int16`` buffer frame) under the dtype tag ``"bf16"``, this package's
own, and `loads` returns it as a ``torch.bfloat16`` tensor, bit for bit.
Other tensors cross as their numpy arrays.  `encode_segments` is the
scatter-gather form of `dumps` the multihost wire sends: the same bytes,
never assembled into one blob.

Trust model: the metadata blob is a pickle; `loads` runs it through a
restricted unpickler that resolves only an explicit closed set of
data-constructor globals (``_SAFE_PICKLE_GLOBALS``: containers, no JAX
entries).  User ``meta`` must be plain-Python data.  Only load
checkpoints you trust regardless.
"""

from __future__ import annotations

import ctypes
import io
import math
import os
import pickle
import struct
import zlib
from collections import OrderedDict
from typing import Any

import numpy as np

from . import lib
from ..utils.crc import crc32_combine, fast_crc32

_BUF_MAGIC = b"PSZ2"
_BUF_MAGIC_V1 = b"PSZ1"
_TREE_MAGIC = b"PSTP"
# The JAX package's tree frames: their metadata holds a JAX PyTreeDef.
_JAX_TREE_MAGICS = (b"PST2", b"PSTR")
_BUF_HDR = struct.Struct("<4sBBQQI")
_BUF_HDR_V1 = struct.Struct("<4sBBQQ")
_TREE_HDR = struct.Struct("<4sQI")

_FLAG_LZ = 1
_FLAG_SHUFFLE = 2

# Threading threshold for the batched native codec: below ~1 MB the spawn
# cost exceeds the win; above it, frames fan out over std::thread inside
# the single GIL-released call, capped by the cores this process may use.
_THREAD_THRESHOLD = 1 << 20
try:
    _USABLE_CPUS = len(os.sched_getaffinity(0))
except (AttributeError, OSError):  # pragma: no cover - non-Linux
    _USABLE_CPUS = os.cpu_count() or 1
_MAX_THREADS = min(8, _USABLE_CPUS)


class ForeignTreeFrameError(ValueError):
    """A tree frame written by the JAX package (``PST2``/``PSTR``): its
    metadata is a pickled JAX ``PyTreeDef``, which this package cannot
    read.  The message names the way across."""


JAX_FRAME_HELP = (
    "it was written by the JAX package (tree frame {magic!r}: its metadata "
    "pickles a JAX PyTreeDef, which the PyTorch package cannot read "
    "without JAX). Carry it across with both packages installed: read it "
    "with the JAX package (pytorch_ps_mpi_tpu.utils.checkpoint."
    "load_optimizer into a JAX optimizer, then its state_dict()), convert "
    "the state with pytorch_ps_mpi_tpu_torch.utils.interop.state_from_jax, "
    "load it with MPI_PS.load_state_dict and write it again with "
    "pytorch_ps_mpi_tpu_torch.utils.checkpoint.save_optimizer")


# The dtype tag of a bfloat16 leaf (numpy has no bfloat16 without
# ml_dtypes): its payload is the int16 view of the bits.
_BF16_TAG = "bf16"


def _leaf_array(leaf) -> "tuple[np.ndarray, str]":
    """A leaf as ``(host array, dtype tag)``: tensors leave the card and
    the autograd graph; a bfloat16 leaf (tensor, or an ``ml_dtypes``
    array) becomes the int16 view of its bits under `_BF16_TAG`."""
    import torch

    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy(), _BF16_TAG
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16), _BF16_TAG
    return a, a.dtype.str


def _leaf_from(arr: np.ndarray, tag: str):
    """Inverse of `_leaf_array`'s tag: a bf16 leaf comes back as a
    ``torch.bfloat16`` tensor sharing the decoded bytes."""
    if tag != _BF16_TAG:
        return arr
    import torch

    return torch.from_numpy(arr).view(torch.bfloat16)


def _native_threads(total_bytes: int, nframes: int) -> int:
    if total_bytes < _THREAD_THRESHOLD or nframes < 2:
        return 1
    return min(_MAX_THREADS, nframes)


def _ptr(buf, offset: int = 0) -> ctypes.c_void_p:
    if isinstance(buf, np.ndarray):
        return ctypes.c_void_p(buf.ctypes.data + offset)
    addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
    return ctypes.c_void_p(addr + offset)


def compress(data, *, itemsize: int | None = None, level: int = 1) -> bytes:
    """Compress a buffer (bytes-like or ndarray) into a framed payload.

    ndarray input is consumed zero-copy via its data pointer; ``itemsize``
    defaults to the array's (driving the shuffle filter) and to 1 for raw
    bytes.  ``level=0`` = store (framing only).  Falls back to store when
    LZ does not shrink the payload."""
    if isinstance(data, np.ndarray):
        arr = np.ascontiguousarray(data)
        n = arr.nbytes
        itemsize = arr.itemsize if itemsize is None else itemsize
        if itemsize > 255:  # u8 header field; shuffle is pointless there
            itemsize = 1
        src: Any = arr
    else:
        src = np.frombuffer(data, np.uint8)
        n = src.nbytes
        itemsize = 1 if itemsize is None else itemsize

    L = lib()
    flags = 0
    work = src
    if level >= 1 and itemsize > 1 and n % itemsize == 0 and n > 0:
        shuffled = np.empty(n, np.uint8)
        L.ps_shuffle(_ptr(work), _ptr(shuffled), n, itemsize)
        work = shuffled
        flags |= _FLAG_SHUFFLE
    if level >= 1 and n > 0:
        cap = L.ps_max_compressed(n)
        out = np.empty(cap, np.uint8)
        csize = L.ps_lz_compress(_ptr(work), n, _ptr(out), cap)
        if 0 < csize < n:
            flags |= _FLAG_LZ
            payload = out[:csize].tobytes()
        else:
            payload = _as_bytes(work, n)
    else:
        payload = _as_bytes(work, n)
    # The crc field is the last header field, so the covered bytes are the
    # V1-layout prefix (same fields, PSZ2 magic) followed by the payload.
    head = _BUF_HDR_V1.pack(_BUF_MAGIC, flags, itemsize, n, len(payload))
    return head + struct.pack("<I", fast_crc32(payload, zlib.crc32(head))) \
        + payload


def _as_bytes(buf, n: int) -> bytes:
    if isinstance(buf, np.ndarray):
        return buf.tobytes()
    return bytes(buf[:n])


def _parse_buf_header(view, off: int = 0):
    """Parse a PSZ2 (or legacy PSZ1) buffer-frame header at ``off``:
    ``(flags, itemsize, orig, comp, crc, header_size)``, ``crc`` None for
    legacy frames."""
    if view.nbytes < off + 4:
        raise ValueError(
            f"truncated buffer frame: {view.nbytes - off} bytes < magic size")
    magic = bytes(view[off:off + 4])
    if magic == _BUF_MAGIC:
        hdr, has_crc = _BUF_HDR, True
    elif magic == _BUF_MAGIC_V1:
        hdr, has_crc = _BUF_HDR_V1, False
    else:
        raise ValueError("bad buffer frame magic")
    if view.nbytes < off + hdr.size:
        raise ValueError(
            f"truncated buffer frame: {view.nbytes - off} bytes < header size")
    fields = hdr.unpack_from(view, off)
    _, flags, itemsize, orig, comp = fields[:5]
    crc = fields[5] if has_crc else None
    return flags, itemsize, orig, comp, crc, hdr.size


def decompress(frame, *, out: np.ndarray | None = None) -> np.ndarray:
    """Decompress a framed payload into a fresh (or caller-provided) uint8
    array."""
    view = memoryview(frame)
    flags, itemsize, orig, comp, crc, hdr_size = _parse_buf_header(view)
    payload = np.frombuffer(view[hdr_size:], np.uint8)[:comp]
    if payload.nbytes != comp:
        raise ValueError("truncated buffer frame")
    if crc is not None:
        head_crc = zlib.crc32(bytes(view[:hdr_size - 4]))
        if fast_crc32(payload, head_crc) != crc:
            raise ValueError(
                "buffer frame failed crc32 check — corrupted data")
    if not flags & _FLAG_LZ and comp != orig:
        raise ValueError(
            f"corrupt store frame: payload {comp} bytes != original {orig}")
    L = lib()
    if out is None:
        out = np.empty(orig, np.uint8)
    elif (out.nbytes != orig or out.dtype != np.uint8
          or not out.flags["C_CONTIGUOUS"]):
        raise ValueError(
            f"out must be a C-contiguous uint8 buffer of {orig} bytes "
            f"(got {out.dtype}, {out.nbytes} bytes, "
            f"contiguous={out.flags['C_CONTIGUOUS']})")
    if flags & _FLAG_LZ:
        dst = np.empty(orig, np.uint8) if flags & _FLAG_SHUFFLE else out
        written = L.ps_lz_decompress(_ptr(payload), comp, _ptr(dst), orig)
        if written != orig:
            raise ValueError(f"corrupt LZ stream: {written} != {orig}")
    else:
        dst = payload
        if not flags & _FLAG_SHUFFLE:
            out[:orig] = dst
            return out
    if flags & _FLAG_SHUFFLE:
        L.ps_unshuffle(_ptr(np.ascontiguousarray(dst)), _ptr(out), orig,
                       itemsize)
    return out


# ---------------------------------------------------------------------------
# tree structure as plain data
# ---------------------------------------------------------------------------

_LEAF = "*"


def tree_spec(tree) -> "tuple[list[Any], Any]":
    """``(leaves, spec)``: the leaves in JAX's flattening order (an
    ``OrderedDict`` in insertion order, any other ``dict`` by sorted key,
    lists and tuples in order; None holds no leaf) and the structure as
    plain, hashable Python data."""
    leaves: list[Any] = []

    def rec(node):
        if node is None:
            return ("none",)
        if isinstance(node, dict):
            keys = (tuple(node) if isinstance(node, OrderedDict)
                    else tuple(sorted(node)))
            kind = "odict" if isinstance(node, OrderedDict) else "dict"
            return (kind, keys, tuple(rec(node[k]) for k in keys))
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            return (kind, tuple(rec(k) for k in node))
        leaves.append(node)
        return _LEAF

    return leaves, rec(tree)


def tree_from_spec(spec, leaves):
    """Inverse of `tree_spec`."""
    it = iter(leaves)

    def rec(s):
        if s == _LEAF:
            return next(it)
        kind = s[0]
        if kind == "none":
            return None
        if kind in ("dict", "odict"):
            vals = [rec(k) for k in s[2]]
            return (OrderedDict if kind == "odict" else dict)(zip(s[1], vals))
        vals = [rec(k) for k in s[1]]
        return vals if kind == "list" else tuple(vals)

    return rec(spec)


# Exact (module, name) pairs the metadata unpickler may resolve — data
# constructors only.  Module-root allowlists are not safe (``builtins``
# holds ``eval``; numpy's object-dtype ``scalar`` nests an unrestricted
# pickle.loads).  The JAX package's treedef entries are absent: this
# package's metadata is plain data.
_SAFE_PICKLE_GLOBALS = {
    ("collections", "OrderedDict"),
    ("collections", "deque"),
} | {("builtins", n) for n in (
    "complex", "bytes", "bytearray", "set", "frozenset", "slice",
    "range", "list", "tuple", "dict", "str", "int", "float", "bool")}


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _SAFE_PICKLE_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"checkpoint metadata references {module}.{name}, which is "
            f"not in the allowlist of data-constructor globals")


def _restricted_loads(blob: bytes):
    return _RestrictedUnpickler(io.BytesIO(blob)).load()


def dumps(tree, *, level: int = 1, meta: dict | None = None) -> bytes:
    """Serialize a tree of arrays: small pickled meta (structure + per-leaf
    shape/dtype + optional user ``meta`` dict) + native-compressed array
    payloads, compressed in parallel across leaves.

    The metadata is validated against the restricted unpickler `loads`
    uses, so a blob that could not be re-read fails at save time."""
    leaves, spec = tree_spec(tree)
    arrs, tags = _leaf_arrays(leaves)
    meta_blob = _tree_meta_blob(arrs, tags, spec, meta)
    frames = _encode_frames(arrs, level)
    out = io.BytesIO()
    out.write(meta_blob)
    out.write(frames)
    return out.getvalue()


def _leaf_arrays(leaves) -> "tuple[list[np.ndarray], list[str]]":
    pairs = [_leaf_array(leaf) for leaf in leaves]
    return [a for a, _ in pairs], [t for _, t in pairs]


def _encode_layout(arrs: list[np.ndarray]):
    """Contiguous leaves + the batched native encode's layout vectors:
    ``(arrs, sizes, itemsizes, src pointers, worst-case regions, arena
    capacity)``."""
    n = len(arrs)
    arrs = [np.ascontiguousarray(a) for a in arrs]
    sizes = np.fromiter((a.nbytes for a in arrs), np.uint64, n)
    items = np.fromiter(
        ((a.itemsize if a.itemsize <= 255 else 1) for a in arrs), np.uint8, n)
    ptrs = np.fromiter((a.ctypes.data for a in arrs), np.uint64, n)
    regions = np.zeros(n, np.uint64)
    np.cumsum(sizes[:-1] + np.uint64(_BUF_HDR.size), out=regions[1:])
    cap = int(sizes.sum()) + _BUF_HDR.size * n
    return arrs, sizes, items, ptrs, regions, cap


def _encode_into(arrs, sizes, items, ptrs, regions, level: int, out):
    """Run ``ps_tree_encode`` into the caller-owned arena ``out``; returns
    ``(fsizes, total)``: per-frame compacted sizes and the byte count."""
    n = len(arrs)
    fsizes = np.empty(n, np.uint64)
    err = ctypes.c_longlong(-1)
    total = lib().ps_tree_encode(
        ptrs.ctypes.data, sizes.ctypes.data, items.ctypes.data, n, level,
        out.ctypes.data, out.nbytes, regions.ctypes.data,
        fsizes.ctypes.data, _native_threads(out.nbytes, n),
        ctypes.byref(err))
    if total < 0:  # pragma: no cover - regions are worst-case sized
        from ..errors import NativeToolchainError
        raise NativeToolchainError(
            f"native tree encode failed (code {total}, frame {err.value})")
    del arrs  # keep-alive for ptrs through the call
    return fsizes, int(total)


def _encode_frames(arrs: list[np.ndarray], level: int):
    """Every leaf's buffer frame in one native call (`ps_tree_encode`):
    header, crc32, shuffle and LZ in C, threaded across frames for
    multi-MB trees.  Byte-identical to per-leaf `compress`."""
    if not arrs:
        return b""
    arrs, sizes, items, ptrs, regions, cap = _encode_layout(arrs)
    out = np.empty(cap, np.uint8)
    _fsizes, total = _encode_into(arrs, sizes, items, ptrs, regions,
                                  level, out)
    return out[:total].data


# Framed-meta cache: a tree of the same structure, shapes and dtypes
# (and no user meta) reuses its validated metadata blob.
_META_CACHE: "dict[tuple, bytes]" = {}
_META_CACHE_MAX = 64


def _tree_meta_blob(arrs, tags, spec, meta) -> bytes:
    """The framed metadata prefix of a tree blob: tree header + crc'd
    meta pickle, validated against the restricted reader at save time.
    ``tags`` are the leaves' dtype tags (`_leaf_array`)."""
    key = None
    if meta is None:
        try:
            key = (spec, tuple(a.shape for a in arrs), tuple(tags))
            cached = _META_CACHE.get(key)
        except TypeError:  # unhashable keys
            key, cached = None, None
        if cached is not None:
            return cached
    md = {
        "tree": spec,
        "shapes": [a.shape for a in arrs],
        "dtypes": list(tags),
        "user": meta,
    }
    meta_pickle = pickle.dumps(md, protocol=pickle.HIGHEST_PROTOCOL)
    try:
        _restricted_loads(meta_pickle)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"this tree/meta cannot be re-read by the restricted loader "
            f"({e}); restructure it to dict/list/tuple nodes with "
            f"plain-Python meta (dict/list/str/numbers/None)") from None
    blob = _TREE_HDR.pack(_TREE_MAGIC, len(meta_pickle),
                          zlib.crc32(meta_pickle)) + meta_pickle
    if key is not None:
        if len(_META_CACHE) >= _META_CACHE_MAX:
            _META_CACHE.clear()
        _META_CACHE[key] = blob
    return blob


class SegmentList(list):
    """The segments half of `encode_segments`, with the whole payload's
    chained checksum precomputed: ``wire_crc``/``wire_len`` cover
    ``meta_blob + b"".join(segments)`` — what a transport frame whose
    payload is (meta + segments) needs, derived without a second pass
    over the leaf bytes (`utils.crc.crc32_combine`)."""

    __slots__ = ("wire_crc", "wire_len")


def encode_segments(tree, *, level: int = 0, meta: dict | None = None):
    """Scatter-gather form of `dumps`: ``(meta_blob, segments)`` with
    ``b"".join([meta_blob, *segments]) == dumps(tree, ...)`` — the wire
    bytes without ever assembling them into one blob, so a sender hands
    the pieces straight to ``socket.sendmsg``
    (`transport.send_frame_segments`) and a PARM publisher encodes once
    and fans the same list out to every puller.  ``segments`` is a
    `SegmentList` carrying the payload's chained crc32.

    * ``level=0`` (the wire's operating point): segments alternate
      ``(frame_header_bytes, leaf_buffer_view)`` — each leaf's payload is
      a zero-copy byte view of the caller's (C-contiguous) array, and one
      crc32 pass over it yields both the leaf frame's crc and the chained
      frame crc (`crc32_combine`).  The views alias the caller's arrays:
      it must not write them until the send completes
      (`transport.Session.send_data_segments` copies on park).
    * ``level>=1``: the batched native shuffle+LZ encode runs as in
      `dumps`, and the segments are per-frame views into its arena.
    """
    leaves, spec = tree_spec(tree)
    arrs, tags = _leaf_arrays(leaves)
    meta_blob = _tree_meta_blob(arrs, tags, spec, meta)
    segments = SegmentList()
    chain = zlib.crc32(meta_blob)
    wire_len = len(meta_blob)
    if level == 0:
        for a in arrs:
            if not a.flags["C_CONTIGUOUS"]:
                a = np.ascontiguousarray(a)
            n = a.nbytes
            itemsize = a.itemsize if a.itemsize <= 255 else 1
            head = _BUF_HDR_V1.pack(_BUF_MAGIC, 0, itemsize, n, n)
            # One read pass over the leaf: both the header-seeded leaf
            # frame crc and the running frame chain come from it.
            p0 = fast_crc32(a)
            leaf_crc = crc32_combine(zlib.crc32(head), p0, n)
            seg_head = head + struct.pack("<I", leaf_crc)
            segments.append(seg_head)
            chain = zlib.crc32(seg_head, chain)
            wire_len += len(seg_head)
            if n:
                segments.append(memoryview(a.reshape(-1)).cast("B"))
                chain = crc32_combine(chain, p0, n)
                wire_len += n
    elif arrs:
        arrs2, sizes, items, ptrs, regions, cap = _encode_layout(arrs)
        arena = np.empty(cap, np.uint8)
        fsizes, total = _encode_into(arrs2, sizes, items, ptrs, regions,
                                     level, arena)
        # The native encode compacts the frames: they sit back to back.
        view = arena[:total].data
        off = 0
        for fsz in fsizes.tolist():
            seg = view[off:off + int(fsz)]
            segments.append(seg)
            chain = fast_crc32(seg, chain)
            wire_len += int(fsz)
            off += int(fsz)
    segments.wire_crc = chain
    segments.wire_len = wire_len
    return meta_blob, segments


def check_tree_frame(blob) -> None:
    """Refuse, from its magic alone, a blob that is not this package's
    tree frame: `ForeignTreeFrameError` for the JAX package's, ValueError
    for anything else."""
    view = memoryview(blob)
    if view.nbytes < 4:
        raise ValueError(
            f"truncated tree frame: {view.nbytes} bytes < magic size")
    magic = bytes(view[:4])
    if magic in _JAX_TREE_MAGICS:
        raise ForeignTreeFrameError(JAX_FRAME_HELP.format(magic=magic))
    if magic != _TREE_MAGIC:
        raise ValueError("bad tree frame magic")


def loads(blob, *, with_meta: bool = False):
    """Inverse of `dumps`; returns the tree with numpy leaves (or
    ``(tree, user_meta)`` when ``with_meta``).  A tree frame written by the
    JAX package raises `ForeignTreeFrameError`.

    Leaves are zero-copy views into one decoded arena; ``np.array(leaf)``
    the pieces you keep long-term if the tree is large.  The metadata is
    read through the restricted unpickler."""
    check_tree_frame(blob)
    view = memoryview(blob)
    if view.nbytes < _TREE_HDR.size:
        raise ValueError(
            f"truncated tree frame: {view.nbytes} bytes < header size")
    _, meta_len, meta_crc = _TREE_HDR.unpack_from(view, 0)
    off = _TREE_HDR.size
    if view.nbytes < off + meta_len:
        raise ValueError("truncated tree frame: metadata cut short")
    meta_bytes = bytes(view[off:off + meta_len])
    # Integrity before unpickling.
    if zlib.crc32(meta_bytes) != meta_crc:
        raise ValueError(
            "tree frame metadata failed crc32 check — corrupted data")
    meta = _restricted_loads(meta_bytes)
    off += meta_len

    tags = meta["dtypes"]
    leaves = _decode_frames(view, off, meta["shapes"], tags)
    tree = tree_from_spec(meta["tree"], [_leaf_from(a, t)
                                         for a, t in zip(leaves, tags)])
    if with_meta:
        return tree, meta.get("user")
    return tree


# Native decode error codes -> the loud failures they stand for.
_DECODE_ERRORS = {
    -1: "truncated tree frame: buffer frame {i} cut short",
    -2: "bad buffer frame magic (frame {i})",
    -3: "corrupt tree frame: leaf {i} size does not match metadata",
    -4: "corrupt tree frame: leaf {i} overflows the arena",
    -5: "buffer frame {i} failed crc32 check — corrupted data",
    -6: "corrupt store frame: leaf {i} payload size != original size",
    -7: "corrupt LZ stream in buffer frame {i}",
}


def _decode_frames(view: memoryview, off: int, shapes, dtype_strs):
    """Decode all buffer frames in one native call (`ps_tree_decode`):
    frame walking, crc32 verification and LZ/unshuffle in C (threaded for
    multi-MB payloads) into one arena; each leaf is a view into it at a
    64-byte-aligned offset."""
    n = len(shapes)
    if n == 0:
        return []
    dtypes = [np.dtype(np.int16 if d == _BF16_TAG else d)
              for d in dtype_strs]
    sizes_py = [math.prod(s) * dt.itemsize for s, dt in zip(shapes, dtypes)]
    offs_py, pos = [], 0
    for sz in sizes_py:
        offs_py.append(pos)
        pos += (sz + 63) & ~63
    cap = offs_py[-1] + sizes_py[-1]
    sizes = np.array(sizes_py, np.uint64)
    offsets = np.array(offs_py, np.uint64)
    arena = np.empty(max(cap, 1), np.uint8)
    src = np.frombuffer(view[off:], np.uint8)
    err = ctypes.c_longlong(-1)
    rc = lib().ps_tree_decode(
        src.ctypes.data, src.nbytes, offsets.ctypes.data, sizes.ctypes.data,
        n, arena.ctypes.data, arena.nbytes, _native_threads(cap, n),
        ctypes.byref(err))
    if rc < 0:
        msg = _DECODE_ERRORS.get(int(rc), "native decode error {rc}")
        raise ValueError(msg.format(i=err.value, rc=rc))
    return [np.ndarray(shape, dt, arena, int(o))
            for shape, dt, o in zip(shapes, dtypes, offsets)]
