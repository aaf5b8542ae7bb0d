"""Attention over the sequence axis, and ring attention across ranks.

Counterpart of `pytorch_ps_mpi_tpu/parallel/ring_attention.py`.
`dense_attention` is the transformer's default attention and the oracle
the flash kernels are held against.  `ring_attention` shards the
*sequence* across the ranks of an ``sp`` axis (Liu et al., "Ring
Attention with Blockwise Transformers"): every rank holds its shard of
Q/K/V ``[B, S/N, H, D]``; K/V travel the ring one hop a step through the
differentiable `collectives.ppermute`, and each rank accumulates its
stationary Q against every visiting block with a streaming softmax —
running row max ``m``, normalizer ``l``, unnormalized output ``o``, in
f32 — so no rank holds the ``S × S`` scores and the softmax is exact.
The causal mask is built from global positions, so the result equals
dense causal attention on the gathered sequence.

Call it under a mesh (``with mesh:`` or inside an `MPI_PS` step) with this
rank's sequence shard.  The streaming softmax is plain PyTorch: no flash
kernel runs on the ring (the JAX CLI refuses ``--attn flash`` with the
ring for the same reason).
"""

from __future__ import annotations

import torch

from .collectives import ppermute
from .mesh import axis_index, axis_size

SEQ_AXIS = "sp"


def dense_attention(q, k, v, *, causal: bool = False,
                    scale: float | None = None):
    """Reference softmax attention.  ``q,k,v: [B, S, H, D]`` -> ``[B, S, H,
    D]``; causal positions are masked with ``-inf``, as in the JAX
    version."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        keep = torch.ones((s_q, s_k), dtype=torch.bool,
                          device=scores.device).tril(s_k - s_q)
        scores = scores.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _block_accumulate(q, k, v, m, l, o, *, scale, mask):
    """One streaming-softmax accumulation step.

    ``q: [B, Sq, H, D]``; ``k,v: [B, Sk, H, D]``; ``m,l: [B, H, Sq]``;
    ``o: [B, H, Sq, D]``; ``mask: [Sq, Sk] bool`` or None.
    """
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        scores = torch.where(mask[None, None], scores,
                             scores.new_full((), float("-inf")))
    m_blk = scores.amax(dim=-1)
    m_new = torch.maximum(m, m_blk)
    # Rows fully masked so far keep m == -inf; use 0 as the subtraction
    # base there so exp() sees finite inputs (p comes out 0 via scores ==
    # -inf).
    zero = m_new.new_zeros(())
    m_safe = torch.where(torch.isfinite(m_new), m_new, zero)
    p = torch.exp(scores - m_safe[..., None])          # [B,H,Sq,Sk]
    alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), zero)
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v)
    return m_new, l_new, o_new


def ring_attention(q, k, v, *, axis: str = SEQ_AXIS, causal: bool = False,
                   scale: float | None = None, loop: str = "auto"):
    """Exact attention over a sequence sharded across mesh axis ``axis``.

    ``q,k,v: [B, S_local, H, D]`` are this rank's sequence shard; returns
    the local shard of the output, in ``q``'s dtype.  ``loop`` is the JAX
    version's choice of how the sweep is expressed (``"unrolled"``,
    ``"scan"``, or ``"auto"``); PyTorch runs eagerly, so all three are
    the same loop of ``N`` accumulation steps here.  The rotation after
    the last step, whose result nothing reads, is not sent."""
    if loop not in ("auto", "unrolled", "scan"):
        raise ValueError(f"loop must be auto|unrolled|scan, got {loop!r}")
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    n = axis_size(axis)
    my = axis_index(axis)
    b, s_local, h, _ = q.shape

    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s_local), float("-inf"), **f32)
    l = torch.zeros((b, h, s_local), **f32)
    o = torch.zeros((b, h, s_local, d), **f32)

    perm = [(i, (i + 1) % n) for i in range(n)]
    q32 = q.to(torch.float32)
    pos = torch.arange(s_local, device=q.device)
    k_cur, v_cur = k, v
    for step in range(n):
        mask = None
        if causal:
            # The visiting block started on shard (my - step) mod n.
            src = (my - step) % n
            mask = (my * s_local + pos)[:, None] >= (src * s_local
                                                     + pos)[None, :]
        m, l, o = _block_accumulate(
            q32, k_cur.to(torch.float32), v_cur.to(torch.float32), m, l, o,
            scale=scale, mask=mask)
        if step + 1 < n:
            k_cur = ppermute(k_cur, axis, perm)
            v_cur = ppermute(v_cur, axis, perm)

    out = o / torch.where(l > 0, l, l.new_ones(()))[..., None]
    return torch.einsum("bhqd->bqhd", out).to(q.dtype)


def make_ring_attention(mesh, *, axis: str = SEQ_AXIS, causal: bool = False,
                        loop: str = "auto"):
    """Ring attention bound to ``mesh``, for use outside a step: ``fn(q, k,
    v)`` on this rank's sequence shards (the port has no global arrays:
    each rank passes its own)."""
    def fn(q, k, v):
        with mesh:
            return ring_attention(q, k, v, axis=axis, causal=causal,
                                  loop=loop)
    return fn
