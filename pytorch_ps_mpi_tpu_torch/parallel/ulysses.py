"""Ulysses-style sequence parallelism — all-to-all head/sequence resharding.

Counterpart of `pytorch_ps_mpi_tpu/parallel/ulysses.py` (DeepSpeed
Ulysses).  Where `ring_attention` keeps Q stationary and rotates K/V, this
*reshards*: an all-to-all turns sequence-sharded ``[B, S/N, H, D]`` into
head-sharded ``[B, S, H/N, D]``, each rank runs ordinary full-sequence
attention over its heads (``inner``: `dense_attention`, or the flash
kernels through `ops.flash_attention.flash_attention`), and a second
all-to-all restores the sequence sharding.  Both all-to-alls are the
differentiable `collectives.all_to_all`, whose backward is the inverse
all-to-all.
"""

from __future__ import annotations

from .collectives import all_to_all
from .mesh import axis_size
from .ring_attention import dense_attention

SEQ_AXIS = "sp"


def ulysses_attention(q, k, v, *, axis: str = SEQ_AXIS, causal: bool = False,
                      scale: float | None = None, inner=None):
    """Exact attention over a sequence sharded across mesh axis ``axis``.

    ``q,k,v: [B, S_local, H, D]`` are this rank's sequence shard; returns
    the local output shard.  ``inner`` is the single-device attention run
    after resharding (default `dense_attention`).

    Head order: the forward all-to-all hands rank ``r`` head chunk ``r``;
    the inverse concatenates the chunks back in rank order, so the head
    axis round-trips bitwise."""
    n = axis_size(axis)
    h = q.shape[2]
    if h % n:
        raise ValueError(
            f"{h} heads do not split across {n}-way sequence parallelism; "
            "Ulysses shards heads (use ring_attention for H < N)")
    if inner is None:
        inner = dense_attention

    # [B, S/N, H, D] -> [B, S, H/N, D]: split heads, concat sequence.
    def reshard(x):
        return all_to_all(x, axis, 2, 1, tiled=True)

    o_g = inner(reshard(q), reshard(k), reshard(v), causal=causal,
                scale=scale)
    # [B, S, H/N, D] -> [B, S/N, H, D]: split sequence, concat heads.
    return all_to_all(o_g, axis, 1, 2, tiled=True)


def make_ulysses_attention(mesh, *, axis: str = SEQ_AXIS,
                           causal: bool = False, inner=None):
    """Ulysses attention bound to ``mesh``, for use outside a step: ``fn(q,
    k, v)`` on this rank's sequence shards."""
    def fn(q, k, v):
        with mesh:
            return ulysses_attention(q, k, v, axis=axis, causal=causal,
                                     inner=inner)
    return fn
