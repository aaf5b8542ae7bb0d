"""Codec kernels: CUDA on the card, their plain PyTorch versions on the CPU.

Counterpart of `pytorch_ps_mpi_tpu/ops/pallas_kernels.py`.  The Pallas TPU
kernels of the codec hot path become hand-written Hopper kernels in
``csrc/codec_kernels.cu`` (built by `ops._build`):

* ``block_quantize`` — per ``(block_rows, 128)`` tile: ``amax = max|x|``,
  ``scale = amax/qmax`` (1.0 unless ``amax > 0``), codes
  ``clip(round_half_even(x/scale), ±qmax)`` as int8 (int16 for 16 bits);
  on the card one thread-block cluster of `cluster_ctas` CTAs per tile,
  which reads the gradient once;
* ``block_dequant_sum`` — given codes gathered across ranks (leading
  world dim), the f32 **sum** over ranks of ``q * scale``, in rank order;
* ``cast_sum`` — the f32 sum over ranks of bf16/f16/f32 wire tensors,
  upcast per element, never materialising a ``(world, n)`` f32 copy.

The two decode sums run on the card as grouped kernels:
`block_dequant_sum_group` and `cast_sum_group` take all of a step's leaves
and decode them into one f32 buffer in one launch (or as few as the
kernel's parameter space needs, `group_launches`); `block_dequant_sum` and
`cast_sum` are groups of one.

Each wrapper runs the plain version when its input lies on the CPU and
launches the kernel when it lies on a CUDA device (raising if the launch
fails); there is no fallback from one to the other.  ``LAUNCHES`` counts
the kernel launches per wrapper (launches, not leaves).  The plain
versions (``*_ref``) repeat the JAX ``*_ref`` functions' arithmetic in the
same order, so on the CPU they agree with the JAX package, and on the card
with the kernels, bit for bit.

Layout contract (a wire format, so it carries over from the TPU): a
gradient of any shape is flattened and zero-padded to ``(rows, 128)`` with
one scale per ``(block_rows, 128)`` tile; zero padding is exact for the
codecs here.
"""

from __future__ import annotations

import array
import ctypes
import threading

import torch

from . import _build

LANE = 128
# Rows per tile: the scale granularity of the blockq wire format.
BLOCK_ROWS = 512

# The block_quantize kernel's clusters: at most MAX_CLUSTER CTAs (the
# portable cluster size) of QUANT_THREADS threads per tile, each thread
# holding at most QUANT_VEC groups of 4 elements in registers.
MAX_CLUSTER, QUANT_THREADS, QUANT_VEC = 8, 256, 8

LAUNCHES = {"block_quantize": 0, "block_dequant_sum": 0, "cast_sum": 0}

_CAST_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


# The async PS's worker threads launch concurrently: counts move under
# this lock.
_COUNT_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(kernel: str, n: int = 1) -> None:
    with _COUNT_LOCK:
        LAUNCHES[kernel] += n


def _qmax(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


def _qdtype(bits: int) -> torch.dtype:
    if bits not in (8, 16):
        raise ValueError("bits must be 8 or 16")
    return torch.int8 if bits == 8 else torch.int16


def pad_to_blocks(flat: torch.Tensor, block_rows: int = BLOCK_ROWS):
    """Zero-pad a 1-D tensor and reshape to ``(n_blocks * block_rows,
    LANE)``.  Returns ``(padded_2d, n_blocks)``."""
    n = flat.shape[0]
    per_block = block_rows * LANE
    n_blocks = max(1, -(-n // per_block))
    padded = flat.new_zeros((n_blocks * per_block,))
    padded[:n] = flat
    return padded.view(n_blocks * block_rows, LANE), n_blocks


def rows_for_flat(n: int, block_rows: int = BLOCK_ROWS) -> int:
    """Per-tensor tile height for a flat n-element payload: the smallest
    multiple of 8 rows that holds it, capped at ``block_rows`` (so a
    (128,) bias costs an 8x128 tile, not a full 512x128 block)."""
    need = -(-n // LANE)               # rows to hold n elements
    aligned = -(-need // 8) * 8        # multiple of 8
    return min(block_rows, max(8, aligned))


def cluster_ctas(tile: int) -> int:
    """CTAs in the cluster that quantizes one ``tile``-element tile on the
    card: the fewest, a power of two up to ``MAX_CLUSTER``, whose threads
    hold the whole tile in registers (8 for a 65,536-element tile, 1 for a
    1,024-element one).  A power of two divides the tile's 4-element groups
    whenever ``tile`` is a multiple of 32 elements, as every
    ``rows * LANE`` tile is."""
    groups = tile // 4
    ctas = 1
    while ctas < MAX_CLUSTER and groups > ctas * QUANT_THREADS * QUANT_VEC:
        ctas *= 2
    return ctas


def _on_cuda(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raise otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name} lies on {t.device}; the codec kernels take "
                     "CUDA tensors and their plain versions CPU tensors")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# block quantize (encode)
# ---------------------------------------------------------------------------


def block_quantize_ref(x2d: torch.Tensor, *, bits: int = 8,
                       block_rows: int = BLOCK_ROWS):
    """Plain version: ``x2d`` is ``(n_blocks*block_rows, LANE)``; returns
    ``(q, scales)`` with ``scales`` of shape ``(n_blocks, 1)`` f32."""
    qmax = _qmax(bits)
    qdtype = _qdtype(bits)
    n_blocks = x2d.shape[0] // block_rows
    blocks = x2d.to(torch.float32).reshape(n_blocks, block_rows * LANE)
    amax = blocks.abs().amax(dim=1, keepdim=True)  # propagates NaN
    # Divide by a tensor, not a Python number: on the card PyTorch turns
    # division by a host scalar into a multiply by its reciprocal.
    scales = torch.where(amax > 0, amax / amax.new_full((), qmax),
                         amax.new_ones(()))
    q = torch.clamp(torch.round(blocks / scales), -qmax, qmax)
    q = torch.where(torch.isnan(q), q.new_zeros(()), q)  # XLA: NaN -> 0
    return q.to(qdtype).reshape(x2d.shape), scales


def block_quantize(flat: torch.Tensor, *, bits: int = 8,
                   block_rows: int = BLOCK_ROWS):
    """Quantize a flat gradient of any length: ``(q, scales)`` with ``q``
    of the padded shape ``(n_blocks*block_rows, LANE)``."""
    if flat.dim() != 1:
        raise ValueError(f"block_quantize takes a 1-D tensor, got "
                         f"shape {tuple(flat.shape)}")
    if not _on_cuda(flat, "flat"):
        x2d, _ = pad_to_blocks(flat, block_rows)
        return block_quantize_ref(x2d, bits=bits, block_rows=block_rows)
    if flat.dtype != torch.float32 or not flat.is_contiguous():
        raise ValueError("the block_quantize kernel takes a contiguous "
                         f"float32 tensor, got {flat.dtype}")
    if block_rows % 8:
        raise ValueError(f"block_rows must be a multiple of 8, got "
                         f"{block_rows}")
    qdtype = _qdtype(bits)
    n = flat.numel()
    tile = block_rows * LANE
    n_blocks = max(1, -(-n // tile))
    q = torch.empty((n_blocks * block_rows, LANE), dtype=qdtype,
                    device=flat.device)
    scales = torch.empty((n_blocks, 1), dtype=torch.float32,
                         device=flat.device)
    with torch.cuda.device(flat.device):
        err = _build.library("codec_kernels").ps_block_quantize(
            flat.data_ptr(), n, tile, n_blocks, bits,
            int(flat.data_ptr() % 16 == 0), cluster_ctas(tile), q.data_ptr(),
            scales.data_ptr(), _stream(flat))
    _build.check("codec_kernels", "block_quantize", err)
    _count("block_quantize")
    return q, scales


# ---------------------------------------------------------------------------
# Grouped decode sums: one launch for all of a step's leaves
# ---------------------------------------------------------------------------


def _pad4(n: int) -> int:
    """A leaf's room in its group's f32 buffer: ``n`` padded to 4 elements,
    so that every leaf starts 16-byte aligned for the kernels' stores."""
    return -(-n // 4) * 4


def _run_group(kernel, fn, rows, fields, total, world, kind, t):
    """Launch a group on the card: ``rows`` holds ``fields`` int64 values
    per leaf of ``t``'s device, the last an element offset into the
    group's f32 buffer of ``total`` elements.  Allocates the buffer, calls
    the C entry ``fn``, counts its launches under ``kernel`` and returns
    the buffer."""
    flat = torch.empty((total,), dtype=torch.float32, device=t.device)
    base = flat.data_ptr()
    rows[fields - 1::fields] = [base + 4 * o for o in rows[fields - 1::fields]]
    table = array.array("q", rows)
    launches = ctypes.c_int(0)
    with torch.cuda.device(t.device):
        err = getattr(_build.library("codec_kernels"), fn)(
            table.buffer_info()[0], len(rows) // fields, world, kind,
            _stream(t), ctypes.byref(launches))
    _build.check("codec_kernels", kernel, err)
    _count(kernel, launches.value)
    return flat


def _views(flat, ns):
    """Each leaf's ``n`` sums: 1-D views of ``flat`` at padded offsets."""
    views, o = [], 0
    for n in ns:
        views.append(flat[o:o + n])
        o += _pad4(n)
    return views


def group_capacity(kernel: str) -> "dict[str, int]":
    """What one launch of ``kernel`` ("block_dequant_sum" or "cast_sum")
    holds on this card: leaves in a 4 KB parameter table (``small``) and
    in the table its launches use (``large``: 32,764 bytes where the
    toolkit and CUDA driver are both >= 12.1, else 4 KB), that table's
    bytes, and the CUDA runtime's and CUDA driver's versions."""
    out = (ctypes.c_int * 5)()
    err = _build.library("codec_kernels").ps_group_info(
        {"block_dequant_sum": 0, "cast_sum": 1}[kernel], out)
    _build.check("codec_kernels", "ps_group_info", err)
    return dict(zip(("small", "large", "param_bytes", "runtime", "cuda_driver"),
                    out))


def group_launches(kernel: str, leaves: int) -> int:
    """Launches a group of ``leaves`` non-empty leaves takes on this card:
    as few as its launches' table needs."""
    return max(1, -(-leaves // group_capacity(kernel)["large"]))


# ---------------------------------------------------------------------------
# block dequantize + cross-rank sum (decode_sum)
# ---------------------------------------------------------------------------


def block_dequant_sum_ref(q: torch.Tensor, scales: torch.Tensor, *,
                          block_rows: int = BLOCK_ROWS):
    """Plain version: ``q`` ``(world, rows, LANE)`` int8/int16, ``scales``
    ``(world, n_blocks, 1)`` f32 -> f32 ``(rows, LANE)``, summed over ranks
    in order starting from rank 0's value."""
    world, rows, _ = q.shape
    n_blocks = rows // block_rows
    out = None
    for r in range(world):
        d = (q[r].to(torch.float32).reshape(n_blocks, block_rows * LANE)
             * scales[r].reshape(n_blocks, 1))
        out = d if out is None else out + d
    return out.reshape(rows, LANE)


def block_dequant_sum_group(leaves):
    """Decode and sum a group of leaves, all in one launch on the card (or
    as few as the kernel's parameter space needs).

    ``leaves``: a sequence of ``(q, scales, n, block_rows)``, with ``q``
    and ``scales`` as `block_dequant_sum` takes them (either may be a
    strided view of a gathered bucket; one world and code dtype for the
    group) and ``n`` the leaf's valid elements, at most ``rows * LANE``.
    Returns ``(flat, views)``: one f32 buffer for the group and, for each
    leaf, its ``n`` sums as a 1-D view of the buffer, at an offset padded
    to 4 elements.  Only the valid elements are written.  On the CPU the
    plain version runs leaf by leaf into the same layout."""
    leaves = list(leaves)
    if not leaves:
        raise ValueError("block_dequant_sum_group takes at least one leaf")
    first = leaves[0][0]
    dev, qdtype, f32 = first.device, first.dtype, torch.float32
    if qdtype not in (torch.int8, torch.int16):
        raise ValueError(f"block_dequant_sum takes int8/int16 codes, got "
                         f"{qdtype}")
    world = first.shape[0] if first.dim() == 3 else None
    cuda = _on_cuda(first, "q")
    ns, rows, off = [], [], 0
    for q, scales, n, block_rows in leaves:
        qshape, sshape = q.shape, scales.shape
        if len(qshape) != 3 or qshape[2] != LANE or len(sshape) != 3:
            raise ValueError(f"block_dequant_sum takes q (world, rows, "
                             f"{LANE}) and scales (world, n_blocks, 1), got "
                             f"{tuple(qshape)} and {tuple(sshape)}")
        w, r, _ = qshape
        if r % block_rows or sshape != (w, r // block_rows, 1):
            raise ValueError(f"rows {r} / block_rows {block_rows} do not "
                             f"match scales {tuple(sshape)}")
        if not 0 <= n <= r * LANE:
            raise ValueError(f"a leaf of {n} elements does not fit codes "
                             f"of {r} x {LANE}")
        if q.device != dev or scales.device != dev:
            raise ValueError(f"the group's leaves lie on {dev}, this one "
                             f"on {q.device} and {scales.device}")
        if q.dtype != qdtype or scales.dtype != f32:
            raise ValueError(f"block_dequant_sum takes int8/int16 codes of "
                             f"one dtype and f32 scales, got {q.dtype} "
                             f"(group {qdtype}) and {scales.dtype}")
        if w != world:
            raise ValueError(f"the group's world is {world}, this leaf's "
                             f"{w}")
        if cuda and n:
            qs, ss = q.stride(), scales.stride()
            if qs[2] != 1 or (r > 1 and qs[1] != LANE) or (
                    sshape[1] > 1 and ss[1] != 1):
                raise ValueError("block_dequant_sum needs each rank's codes "
                                 "and scales contiguous")
            rows += (q.data_ptr(), scales.data_ptr(), qs[0], ss[0], n,
                     block_rows * LANE, off)
        ns.append(n)
        off += _pad4(n)
    if cuda:
        flat = _run_group("block_dequant_sum", "ps_block_dequant_sum_group",
                          rows, 7, off, world, 8 * first.element_size(),
                          first)
        return flat, _views(flat, ns)
    flat = torch.empty((off,), dtype=f32, device=dev)
    views = _views(flat, ns)
    for (q, scales, n, block_rows), v in zip(leaves, views):
        v.copy_(block_dequant_sum_ref(q, scales,
                                      block_rows=block_rows).view(-1)[:n])
    return flat, views


def block_dequant_sum(q: torch.Tensor, scales: torch.Tensor, *,
                      block_rows: int = BLOCK_ROWS):
    """``q``: (world, rows, LANE) int8/int16; ``scales``: (world,
    n_blocks, 1) f32; either may be a strided view of a gathered bucket.
    Returns f32 ``(rows, LANE)`` = sum over the world dim of q*scale: a
    group of one (`block_dequant_sum_group`)."""
    if q.dim() != 3:
        raise ValueError(f"block_dequant_sum takes q (world, rows, {LANE}) "
                         f"and scales (world, n_blocks, 1), got "
                         f"{tuple(q.shape)} and {tuple(scales.shape)}")
    flat, _ = block_dequant_sum_group(
        [(q, scales, q.shape[1] * q.shape[2], block_rows)])
    return flat.view(q.shape[1], q.shape[2])


# ---------------------------------------------------------------------------
# cast decode + cross-rank sum (CastCodec's decode_sum)
# ---------------------------------------------------------------------------


def cast_sum_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version: f32 sum over the leading (world) dim, each rank
    upcast before it is added, in rank order from rank 0's value."""
    out = x[0].to(torch.float32, copy=True)
    for r in range(1, x.shape[0]):
        out = out + x[r].to(torch.float32)
    return out


def cast_sum_group(leaves):
    """The f32 sums over ranks of a group of wire leaves, all in one
    launch on the card (or as few as the kernel's parameter space needs).

    ``leaves``: a sequence of ``(world, n)`` bf16/f16/f32 tensors of one
    world and dtype, each rank's row contiguous (rows may be strided views
    of a gathered bucket, at any element offset).  Returns ``(flat,
    views)`` as `block_dequant_sum_group` does.  On the CPU the plain
    version runs leaf by leaf into the same layout."""
    leaves = list(leaves)
    if not leaves:
        raise ValueError("cast_sum_group takes at least one leaf")
    first = leaves[0]
    dev, dtype = first.device, first.dtype
    if dtype not in _CAST_DTYPES:
        raise ValueError(f"cast_sum takes bf16/f16/f32 rows, got {dtype}")
    world = first.shape[0] if first.dim() == 2 else None
    cuda = _on_cuda(first, "x")
    ns, rows, off = [], [], 0
    for x in leaves:
        shape = x.shape
        if len(shape) != 2:
            raise ValueError(f"cast_sum takes (world, n), got "
                             f"{tuple(shape)}")
        w, n = shape
        if x.device != dev:
            raise ValueError(f"the group's leaves lie on {dev}, this one "
                             f"on {x.device}")
        if x.dtype != dtype:
            raise ValueError(f"cast_sum takes bf16/f16/f32 rows of one "
                             f"dtype, got {x.dtype} (group {dtype})")
        if w != world:
            raise ValueError(f"the group's world is {world}, this leaf's "
                             f"{w}")
        if cuda and n:
            st = x.stride()
            if n > 1 and st[1] != 1:
                raise ValueError(f"the cast_sum kernel takes rows with unit "
                                 f"stride, got strides {st}")
            rows += (x.data_ptr(), st[0], n, off)
        ns.append(n)
        off += _pad4(n)
    if cuda:
        flat = _run_group("cast_sum", "ps_cast_sum_group", rows, 4, off,
                          world, _CAST_DTYPES[dtype], first)
        return flat, _views(flat, ns)
    flat = torch.empty((off,), dtype=torch.float32, device=dev)
    views = _views(flat, ns)
    for x, v in zip(leaves, views):
        v.copy_(cast_sum_ref(x))
    return flat, views


def cast_sum(x: torch.Tensor) -> torch.Tensor:
    """``x``: (world, n) wire-dtype (bf16/f16/f32), each rank's row
    contiguous (rows may be a strided view of a gathered bucket).  Returns
    f32 ``(n,)``; the sum is always accumulated in f32.  A group of one
    (`cast_sum_group`)."""
    if x.dim() != 2:
        raise ValueError(f"cast_sum takes (world, n), got {tuple(x.shape)}")
    return cast_sum_group([x])[1][0]
