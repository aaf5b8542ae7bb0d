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

Each wrapper runs the plain version when its input lies on the CPU and
launches the kernel when it lies on a CUDA device (raising if the launch
fails); there is no fallback from one to the other.  ``LAUNCHES`` counts
the kernel launches per wrapper.  The plain versions (``*_ref``) repeat
the JAX ``*_ref`` functions' arithmetic in the same order, so on the CPU
they agree with the JAX package, and on the card with the kernels, bit
for bit.

Layout contract (a wire format, so it carries over from the TPU): a
gradient of any shape is flattened and zero-padded to ``(rows, 128)`` with
one scale per ``(block_rows, 128)`` tile; zero padding is exact for the
codecs here.
"""

from __future__ import annotations

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


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    LAUNCHES["block_quantize"] += 1
    return q, scales


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


def block_dequant_sum(q: torch.Tensor, scales: torch.Tensor, *,
                      block_rows: int = BLOCK_ROWS):
    """``q``: (world, rows, LANE) int8/int16; ``scales``: (world,
    n_blocks, 1) f32; either may be a strided view of a gathered bucket.
    Returns f32 ``(rows, LANE)`` = sum over the world dim of q*scale."""
    if q.dim() != 3 or q.shape[2] != LANE or scales.dim() != 3:
        raise ValueError(f"block_dequant_sum takes q (world, rows, {LANE}) "
                         f"and scales (world, n_blocks, 1), got "
                         f"{tuple(q.shape)} and {tuple(scales.shape)}")
    world, rows, _ = q.shape
    n_blocks = rows // block_rows
    if rows % block_rows or tuple(scales.shape) != (world, n_blocks, 1):
        raise ValueError(f"rows {rows} / block_rows {block_rows} do not "
                         f"match scales {tuple(scales.shape)}")
    if not _on_cuda(q, "q"):
        return block_dequant_sum_ref(q, scales, block_rows=block_rows)
    if q.dtype not in (torch.int8, torch.int16) or scales.dtype != torch.float32:
        raise ValueError(f"block_dequant_sum takes int8/int16 codes and f32 "
                         f"scales, got {q.dtype} and {scales.dtype}")
    item = q.element_size()
    if (q.stride(2) != 1 or q.stride(1) != LANE
            or (n_blocks > 1 and scales.stride(1) != 1)
            or q.data_ptr() % (4 * item)
            or (world > 1 and q.stride(0) % 4)):
        raise ValueError("block_dequant_sum needs each rank's codes "
                         "contiguous and 4-element aligned, and each rank's "
                         "scales contiguous")
    out = torch.empty((rows, LANE), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _build.library("codec_kernels").ps_block_dequant_sum(
            q.data_ptr(), q.stride(0), 8 * item, scales.data_ptr(),
            scales.stride(0), world, rows * LANE, block_rows * LANE,
            out.data_ptr(), _stream(q))
    _build.check("codec_kernels", "block_dequant_sum", err)
    LAUNCHES["block_dequant_sum"] += 1
    return out


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


def cast_sum(x: torch.Tensor) -> torch.Tensor:
    """``x``: (world, n) wire-dtype (bf16/f16/f32), each rank's row
    contiguous (rows may be a strided view of a gathered bucket).  Returns
    f32 ``(n,)``; the sum is always accumulated in f32."""
    if x.dim() != 2:
        raise ValueError(f"cast_sum takes (world, n), got {tuple(x.shape)}")
    if not _on_cuda(x, "x"):
        return cast_sum_ref(x)
    if x.dtype not in _CAST_DTYPES or (x.shape[1] > 1 and x.stride(1) != 1):
        raise ValueError(f"the cast_sum kernel takes bf16/f16/f32 rows with "
                         f"unit stride, got {x.dtype}, strides {x.stride()}")
    world, n = x.shape
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    vec = (x.data_ptr() % (4 * x.element_size()) == 0
           and (world == 1 or x.stride(0) % 4 == 0))
    with torch.cuda.device(x.device):
        err = _build.library("codec_kernels").ps_cast_sum(
            x.data_ptr(), x.stride(0), _CAST_DTYPES[x.dtype], world, n,
            int(vec), out.data_ptr(), _stream(x))
    _build.check("codec_kernels", "cast_sum", err)
    LAUNCHES["cast_sum"] += 1
    return out
