"""Flash attention: CUDA kernels on the card, plain versions on the CPU.

Counterpart of `pytorch_ps_mpi_tpu/ops/flash_attention.py`.  Exact softmax
attention with O(S * tile) live memory, ``q, k, v: [B, S, H, D]`` ->
``[B, S, H, D]``, a drop-in for `parallel.ring_attention.dense_attention`.
The three Pallas TPU kernels become hand-written Hopper kernels in
``csrc/flash_attention.cu`` (built by `ops._build`):

* ``flash_fwd`` — streaming softmax over k tiles: ``o`` and the per-row
  logsumexp ``lse`` (f32 ``[B, H, S]``), the one residual the backward
  needs;
* ``flash_bwd_dkdv`` — FlashAttention-2 dK and dV, sweeping q tiles per k
  tile, ``p`` recomputed as ``exp(s - lse)``;
* ``flash_bwd_dq`` — dQ, sweeping k tiles per q tile.

In bf16 all three kernels are Hopper designs (TMA tile ring, wgmma,
softmax and accumulators in registers) over blocks of ``BLOCK_ROWS`` rows;
the f32 kernels stage their 64-row tiles through shared memory and
multiply with FMAs.  ``kernel_info`` reads back how each kernel occupies
the card.

`flash_attention` wraps them in a `torch.autograd.Function` (the
analogue of the JAX ``custom_vjp``).  Its backward computes
``delta = rowsum(dO * O)`` as a plain op outside the kernels, as the JAX
package does, then launches the two backward kernels.

Each wrapper runs its plain version when its inputs lie on the CPU and
launches the kernel when they lie on a CUDA device, raising for what the
kernels do not take (a dtype other than bf16/f32, a head dim over 128);
there is no fallback from one to the other.  ``LAUNCHES`` counts the kernel
launches per wrapper.  The kernels take head dims 64 and 128; the wrappers
zero-pad any other ``D <= 128`` up to the next of them and slice the result
back, which is exact, as the JAX package's lane padding is.

The plain versions (``*_ref``) repeat the Pallas math tile by tile, over
the 64-row tiles the kernels stream (k tiles for the forward, q tiles for
dK/dV, k tiles for dQ): f32 scores ``dot(q, k^T) * scale``, the finite
``NEG_INF`` for causal positions and the ragged tail, the running max /
normaliser / accumulator rescale, ``p`` rounded to the value dtype before
``p @ v``, ``lse = m + log(l > 0 ? l : 1)``; in the backward the mask
applies before the exp, ``ds = p * (dp - delta) * scale``, and ``p`` and
``ds`` are rounded to the operand dtype before each product.  Operands are
widened to f32 before each product, which is a bf16 product summed in f32
(the MXU's ``preferred_element_type=f32``) exactly.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from . import _build

TILE = 64          # rows of a streamed tile in the kernels and plain versions
NEG_INF = -1e30    # finite, as in the Pallas kernels: masked rows stay finite
HEAD_DIMS = (64, 128)
# Rows of the tile one block of a kernel owns, as csrc/flash_attention.cu
# launches them (its grid is ceil(S / rows) blocks per (batch, head)):
# (kernel, dtype, kernel head dim) -> rows, TILE for any not listed.
BLOCK_ROWS = {("flash_fwd", torch.bfloat16, 64): 128,
              ("flash_fwd", torch.bfloat16, 128): 128,
              ("flash_bwd_dkdv", torch.bfloat16, 64): 128,
              ("flash_bwd_dq", torch.bfloat16, 64): 128,
              ("flash_bwd_dq", torch.bfloat16, 128): 128}

LAUNCHES = {"flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# The async PS's worker threads launch concurrently: counts move under
# this lock.
_COUNT_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(kernel: str) -> None:
    with _COUNT_LOCK:
        LAUNCHES[kernel] += 1


def _bh(x: torch.Tensor) -> torch.Tensor:
    """``[B, S, H, D]`` -> a ``[B, H, S, D]`` view."""
    return x.transpose(1, 2)


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero-pad dim -2 of a ``[B, H, S, D]`` (or dim -1 of a ``[B, H, S]``)
    tensor up to ``rows``."""
    if x.dim() == 3:
        return F.pad(x, (0, rows - x.shape[-1]))
    return F.pad(x, (0, 0, 0, rows - x.shape[-2]))


def _mask(q0, n_q, k0, n_k, seq_len, causal, device):
    """The Pallas mask of one (q rows, k rows) tile pair: in range, and
    causal where asked."""
    q_pos = torch.arange(q0, q0 + n_q, device=device)[:, None]
    k_pos = torch.arange(k0, k0 + n_k, device=device)[None, :]
    mask = (k_pos < seq_len) & (q_pos < seq_len)
    if causal:
        mask = mask & (q_pos >= k_pos)
    return mask


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of operands widened to f32: a bf16 product summed in f32."""
    return torch.matmul(a.float(), b.float())


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def flash_fwd_ref(q, k, v, *, causal: bool, scale: float):
    """Plain forward, tile by tile over k: ``(o [B, S, H, D] in q's dtype,
    lse f32 [B, H, S])``."""
    b, s, h, d = q.shape
    n_k = -(-s // TILE)
    q3 = _bh(q)
    k3, v3 = _pad_rows(_bh(k), n_k * TILE), _pad_rows(_bh(v), n_k * TILE)
    m = q.new_full((b, h, s), NEG_INF, dtype=torch.float32)
    l = q.new_zeros((b, h, s), dtype=torch.float32)
    acc = q.new_zeros((b, h, s, d), dtype=torch.float32)
    for j in range(n_k):
        k0 = j * TILE
        kt, vt = k3[:, :, k0:k0 + TILE], v3[:, :, k0:k0 + TILE]
        sc = _dot(q3, kt.transpose(-1, -2)) * scale
        sc = torch.where(_mask(0, s, k0, TILE, s, causal, q.device), sc,
                         NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _dot(p.to(v.dtype), vt)
        m = m_new
    safe = torch.where(l > 0, l, torch.ones_like(l))
    o = (acc / safe[..., None]).to(q.dtype)
    return o.transpose(1, 2).contiguous(), m + torch.log(safe)


def _bwd_probs(qt, kt, dot, vt, lse_t, delta_t, mask, scale):
    """Shared backward tile math (the JAX ``_bwd_probs``): ``p`` from the
    saved logsumexp, masked before the exp, and ``ds``."""
    sc = _dot(qt, kt.transpose(-1, -2)) * scale
    p = torch.exp(torch.where(mask, sc - lse_t[..., None], NEG_INF))
    dp = _dot(dot, vt.transpose(-1, -2))
    return p, p * (dp - delta_t[..., None]) * scale


def flash_bwd_dkdv_ref(q, k, v, do, lse, delta, *, causal: bool,
                       scale: float):
    """Plain dK, dV, tile by tile over q: ``(dk, dv)`` ``[B, S, H, D]``."""
    s = q.shape[1]
    n_q = -(-s // TILE)
    q3, do3 = (_pad_rows(_bh(x), n_q * TILE) for x in (q, do))
    lse3, delta3 = _pad_rows(lse, n_q * TILE), _pad_rows(delta, n_q * TILE)
    k3, v3 = _bh(k), _bh(v)
    dk = torch.zeros(k3.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for i in range(n_q):
        q0 = i * TILE
        rows = slice(q0, q0 + TILE)
        qt, dot = q3[:, :, rows], do3[:, :, rows]
        p, ds = _bwd_probs(qt, k3, dot, v3, lse3[..., rows],
                           delta3[..., rows],
                           _mask(q0, TILE, 0, s, s, causal, q.device), scale)
        dv = dv + _dot(p.to(do.dtype).transpose(-1, -2), dot)
        dk = dk + _dot(ds.to(q.dtype).transpose(-1, -2), qt)
    return (dk.to(k.dtype).transpose(1, 2).contiguous(),
            dv.to(v.dtype).transpose(1, 2).contiguous())


def flash_bwd_dq_ref(q, k, v, do, lse, delta, *, causal: bool,
                     scale: float):
    """Plain dQ, tile by tile over k: ``dq`` ``[B, S, H, D]``."""
    s = q.shape[1]
    n_k = -(-s // TILE)
    k3, v3 = (_pad_rows(_bh(x), n_k * TILE) for x in (k, v))
    q3, do3 = _bh(q), _bh(do)
    dq = torch.zeros(q3.shape, dtype=torch.float32, device=q.device)
    for j in range(n_k):
        k0 = j * TILE
        kt = k3[:, :, k0:k0 + TILE]
        _, ds = _bwd_probs(q3, kt, do3, v3[:, :, k0:k0 + TILE], lse, delta,
                           _mask(0, s, k0, TILE, s, causal, q.device), scale)
        dq = dq + _dot(ds.to(k.dtype), kt)
    return dq.to(q.dtype).transpose(1, 2).contiguous()


def flash_bwd_ref(q, k, v, do, lse, delta, *, causal: bool, scale: float):
    """Plain backward: ``(dq, dk, dv)``."""
    dk, dv = flash_bwd_dkdv_ref(q, k, v, do, lse, delta, causal=causal,
                                scale=scale)
    dq = flash_bwd_dq_ref(q, k, v, do, lse, delta, causal=causal,
                          scale=scale)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _on_cuda(tensors) -> bool:
    """True for CUDA operands, False for CPU ones; raise for a mix or any
    other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"flash attention operands lie on {sorted(kinds)}; the "
                     "kernels take CUDA tensors and their plain versions "
                     "CPU tensors")


def _check_operands(q, k, v, do=None):
    ops = (q, k, v) if do is None else (q, k, v, do)
    if q.dim() != 4 or any(t.shape != q.shape for t in ops):
        raise ValueError("flash attention takes q, k, v (and dout) of one "
                         "shape [B, S, H, D], got "
                         f"{[tuple(t.shape) for t in ops]}")
    if any(t.dtype != q.dtype for t in ops):
        raise ValueError(f"flash attention operands differ in dtype: "
                         f"{[t.dtype for t in ops]}")


def _kernel_dim(q: torch.Tensor) -> int:
    """The kernels' head dim for ``q``; raise for what they do not take."""
    if q.dtype not in _DTYPES:
        raise ValueError(f"the flash attention kernels take bfloat16 or "
                         f"float32, got {q.dtype}")
    d = q.shape[-1]
    if not 0 < d <= HEAD_DIMS[-1]:
        raise ValueError(f"the flash attention kernels take a head dim of "
                         f"at most {HEAD_DIMS[-1]}, got {d}")
    return next(w for w in HEAD_DIMS if d <= w)


def _rows_ok(t: torch.Tensor) -> bool:
    """Unit stride along D, every (batch, seq, head) row start 16-byte
    aligned, and the strides nested as ``[D, H, S, B]`` (each at least the
    extent of the dimensions inside it): what the kernels' 16-byte loads and
    the TMA tensor maps over ``[D, H, S, B]`` take."""
    size = t.element_size()
    _, s, h, d = t.shape
    st_b, st_s, st_h, st_d = t.stride()
    return (st_d == 1 and t.data_ptr() % 16 == 0
            and all(st * size % 16 == 0 for st in (st_b, st_s, st_h))
            and st_h >= d and st_s >= h * st_h and st_b >= s * st_s)


def _kernel_operand(t: torch.Tensor, dk: int) -> torch.Tensor:
    if t.shape[-1] != dk:
        return F.pad(t, (0, dk - t.shape[-1]))
    return t if _rows_ok(t) else t.contiguous()


def _strides(ops) -> "ctypes.Array":
    vals = [st for t in ops for st in t.stride()[:3]]
    vals += [0] * (12 - len(vals))
    return (ctypes.c_longlong * 12)(*vals)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_len(kernel, dtype, dk, b, s, h):
    """The grid's limits: B*H blocks along x, and at most 65535 blocks of
    the kernel's ``BLOCK_ROWS`` rows along S."""
    rows = BLOCK_ROWS.get((kernel, dtype, dk), TILE)
    if b * h >= 2 ** 31 or s >= 65535 * rows:
        raise ValueError(f"{kernel} takes B*H < 2^31 and S < "
                         f"{65535 * rows}, got B={b}, S={s}, H={h}")


def flash_fwd(q, k, v, *, causal: bool, scale: float):
    """``(o, lse)``: ``o`` ``[B, S, H, D]`` in q's dtype, ``lse`` f32
    ``[B, H, S]``."""
    _check_operands(q, k, v)
    if not _on_cuda((q, k, v)):
        return flash_fwd_ref(q, k, v, causal=causal, scale=scale)
    dk = _kernel_dim(q)
    b, s, h, d = q.shape
    _check_len("flash_fwd", q.dtype, dk, b, s, h)
    ops = [_kernel_operand(t, dk) for t in (q, k, v)]
    o = torch.empty((b, s, h, dk), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o[..., :d], lse
    with torch.cuda.device(q.device):
        err = _build.library("flash_attention").ps_flash_fwd(
            _DTYPES[q.dtype], dk, *(t.data_ptr() for t in ops),
            _strides(ops), o.data_ptr(), lse.data_ptr(), b, h, s,
            float(scale), int(causal), _stream(q))
    _build.check("flash_attention", "flash_fwd", err)
    _count("flash_fwd")
    return (o if dk == d else o[..., :d]), lse


def _bwd_kernel_args(kernel, q, k, v, do, lse, delta):
    dk = _kernel_dim(q)
    b, s, h, _ = q.shape
    _check_len(kernel, q.dtype, dk, b, s, h)
    if (lse.shape != (b, h, s) or delta.shape != (b, h, s)
            or lse.dtype != torch.float32 or delta.dtype != torch.float32):
        raise ValueError("flash attention backward takes lse and delta as "
                         f"f32 [B, H, S] = {(b, h, s)}, got "
                         f"{tuple(lse.shape)} {lse.dtype} and "
                         f"{tuple(delta.shape)} {delta.dtype}")
    ops = [_kernel_operand(t, dk) for t in (q, k, v, do)]
    return dk, ops, lse.contiguous(), delta.contiguous()


def flash_bwd_dkdv(q, k, v, do, lse, delta, *, causal: bool, scale: float):
    """``(dk, dv)`` ``[B, S, H, D]`` in the operands' dtype."""
    _check_operands(q, k, v, do)
    if not _on_cuda((q, k, v, do, lse, delta)):
        return flash_bwd_dkdv_ref(q, k, v, do, lse, delta, causal=causal,
                                  scale=scale)
    dk_, ops, lse, delta = _bwd_kernel_args("flash_bwd_dkdv", q, k, v, do,
                                            lse, delta)
    b, s, h, d = q.shape
    dk = torch.empty((b, s, h, dk_), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dk.numel() == 0:
        return dk[..., :d], dv[..., :d]
    with torch.cuda.device(q.device):
        err = _build.library("flash_attention").ps_flash_bwd_dkdv(
            _DTYPES[q.dtype], dk_, *(t.data_ptr() for t in ops),
            _strides(ops), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, h, s, float(scale), int(causal), _stream(q))
    _build.check("flash_attention", "flash_bwd_dkdv", err)
    _count("flash_bwd_dkdv")
    if dk_ != d:
        dk, dv = dk[..., :d], dv[..., :d]
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool, scale: float):
    """``dq`` ``[B, S, H, D]`` in the operands' dtype."""
    _check_operands(q, k, v, do)
    if not _on_cuda((q, k, v, do, lse, delta)):
        return flash_bwd_dq_ref(q, k, v, do, lse, delta, causal=causal,
                                scale=scale)
    dk_, ops, lse, delta = _bwd_kernel_args("flash_bwd_dq", q, k, v, do, lse,
                                            delta)
    b, s, h, d = q.shape
    dq = torch.empty((b, s, h, dk_), dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq[..., :d]
    with torch.cuda.device(q.device):
        err = _build.library("flash_attention").ps_flash_bwd_dq(
            _DTYPES[q.dtype], dk_, *(t.data_ptr() for t in ops),
            _strides(ops), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, h, s, float(scale), int(causal), _stream(q))
    _build.check("flash_attention", "flash_bwd_dq", err)
    _count("flash_bwd_dq")
    return dq if dk_ == d else dq[..., :d]


def kernel_info(kernel: str, dtype: torch.dtype, d: int) -> "dict[str, int]":
    """How the CUDA kernel ``kernel`` for ``dtype`` and head dim ``d`` (64 or
    128) occupies the card: threads and rows per block, dynamic shared
    memory bytes, registers and local (spilled) bytes per thread, resident
    blocks per SM.  Needs the card; builds the library on first use."""
    kind = list(LAUNCHES).index(kernel)
    out = (ctypes.c_int * 6)()
    err = _build.library("flash_attention").ps_flash_kernel_info(
        kind, _DTYPES[dtype], d, out)
    _build.check("flash_attention", kernel, err)
    keys = ("threads", "rows", "smem_bytes", "registers", "local_bytes",
            "blocks_per_sm")
    return dict(zip(keys, out))


# ---------------------------------------------------------------------------
# the differentiable op
# ---------------------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    """Forward saves ``q, k, v, o, lse``; backward recomputes ``p`` from
    ``lse`` (the JAX ``_flash`` custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # delta = rowsum(dO * O): the one extra residual FA-2 needs, a plain
        # op outside the kernels, as in the JAX package.
        delta = torch.sum(do.float() * o.float(), -1).transpose(1, 2)
        kw = dict(causal=ctx.causal, scale=ctx.scale)
        dk, dv = flash_bwd_dkdv(q, k, v, do, lse, delta, **kw)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: float | None = None):
    """Exact attention, O(S * tile) memory.  ``q, k, v: [B, S, H, D]`` ->
    ``[B, S, H, D]``, with ``scale = D ** -0.5`` unless given."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    return _FlashAttention.apply(q, k, v, bool(causal), float(scale))
