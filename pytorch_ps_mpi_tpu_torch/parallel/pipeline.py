"""Pipeline parallelism — a differentiable GPipe schedule over a mesh axis.

Counterpart of `pytorch_ps_mpi_tpu/parallel/pipeline.py`.  The schedule
is a loop of ``M + pp - 1`` ticks: each tick applies this rank's stage and
sends the activation one hop around the ring through the differentiable
`collectives.ppermute`, so autograd derives the backward pipeline (the
transpose of a ppermute ring is the reverse ring) and no hand-written
backward schedule exists.

Ownership/gradient contract (how this composes with `MPI_PS` unchanged):

* stage 0 consumes its inputs through a ``torch.where(rank == 0, ...)``
  mask, and the last rank stores finished microbatches through another,
  so every rank runs the same graph (the backward collectives then run in
  the same order on every rank) and the fill and drain ticks, which
  compute on the zero carry, pass no gradient;
* the caller masks its scalar loss to the last stage with
  `last_stage_value`, which makes every parameter single-owner;
* every rank differentiates its own copy of the replicated loss, so the
  owner's gradient carries a ×pp factor — cancelled by the PS step's
  mean over the non-data mesh axes.
"""

from __future__ import annotations

import torch

from ..utils.flatten import tree_leaves, tree_map
from .collectives import ppermute, psum
from .mesh import axis_index, axis_size


def last_stage_value(x, axis: str):
    """``x`` as computed on the LAST rank of ``axis``, replicated: a psum
    of ``where(rank == last, x, 0)``.  Gradients flow only into the last
    rank's copy."""
    last = axis_index(axis) == axis_size(axis) - 1
    mask = torch.tensor(last, device=x.device)
    return psum(torch.where(mask, x, torch.zeros_like(x)), axis)


def stage_slice(stacked, axis: str):
    """This rank's stage out of layer-stacked parameters: leaves with a
    leading layer dim ``L`` split contiguously into ``axis``-many stages,
    and rank ``r`` gets layers ``[r*L/pp, (r+1)*L/pp)``."""
    i = axis_index(axis)
    n = axis_size(axis)
    leaves = tree_leaves(stacked)
    if not leaves:
        return stacked
    L = leaves[0].shape[0]
    if L % n:
        raise ValueError(f"{L} layers do not split into {n} pipeline stages")
    lps = L // n
    return tree_map(lambda v: v[i * lps:(i + 1) * lps], stacked)


def pipeline_apply(stage_fn, x, *, axis: str, n_micro: int | None = None):
    """Run ``x`` through a ``pp``-stage pipeline; returns the final
    activations, replicated over ``axis``.

    ``stage_fn(mb) -> mb`` applies THIS rank's stage to one microbatch and
    must preserve shape and dtype.  ``x`` is the local batch ``[B, ...]``,
    replicated over ``axis``; it splits into ``n_micro`` microbatches
    (default: the stage count) along dim 0.

    Schedule: ``T = M + pp - 1`` ticks.  At tick ``t`` rank 0 feeds
    microbatch ``t`` (masked select), every rank applies its stage to the
    activation in front of it, the last rank stores finished microbatch
    ``t - (pp-1)`` (masked), and the activation shifts one hop.  The
    carry starts as zeros.  The shift after the last tick, whose result
    nothing reads, is not sent."""
    i = axis_index(axis)
    n = axis_size(axis)
    M = int(n_micro) if n_micro is not None else n
    b = x.shape[0]
    if M < 1:
        raise ValueError(f"n_micro must be >= 1, got {M}")
    if b % M:
        raise ValueError(
            f"local batch {b} does not split into {M} microbatches")
    xm = x.reshape((M, b // M) + tuple(x.shape[1:]))
    perm = [(j, (j + 1) % n) for j in range(n)]
    first = torch.tensor(i == 0, device=x.device)
    last = torch.tensor(i == n - 1, device=x.device)

    act = torch.zeros_like(xm[0])
    ys = [torch.zeros_like(xm[0]) for _ in range(M)]
    ticks = M + n - 1
    for t in range(ticks):
        feed = xm[min(max(t, 0), M - 1)]
        out = stage_fn(torch.where(first, feed, act))
        if out.shape != feed.shape or out.dtype != feed.dtype:
            raise ValueError(
                f"stage_fn must preserve shape/dtype: {tuple(feed.shape)}/"
                f"{feed.dtype} -> {tuple(out.shape)}/{out.dtype}")
        w = t - (n - 1)
        if 0 <= w < M:
            ys[w] = torch.where(last, out, ys[w])
        if t + 1 < ticks:
            act = ppermute(out, axis, perm)
    out = last_stage_value(torch.stack(ys), axis)
    return out.reshape((b,) + tuple(out.shape[2:]))
