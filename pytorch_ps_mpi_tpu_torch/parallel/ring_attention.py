"""Attention over the sequence axis.

Counterpart of `pytorch_ps_mpi_tpu/parallel/ring_attention.py`.  Only
`dense_attention` is ported so far: the transformer's default attention
and the oracle the flash kernels are held against.  The ring and streaming
variants, which shard the sequence across ranks, are not ported yet.
"""

from __future__ import annotations

import torch


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
