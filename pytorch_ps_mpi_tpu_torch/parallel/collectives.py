"""Bucketed collectives over ``torch.distributed``.

Counterpart of `pytorch_ps_mpi_tpu/parallel/collectives.py` (its in-step
tier).  The reference posts one non-blocking collective per parameter;
the JAX package packs same-dtype leaves into flat buckets of about
``bucket_bytes`` and runs one collective per bucket, and gives a leaf that
amortizes a collective alone a bucket of its own.  The port keeps that
plan verbatim (`_plan_buckets`, `_solo_default`), so its buckets equal
the JAX package's for the same tree, and runs each bucket through NCCL
(card) or gloo (CPU).  Packing is pure data movement: the sums are the
same elementwise sums as the per-leaf lowering.

Trees are nested dicts of tensors, flattened in JAX's leaf order
(`utils.flatten`).

The host API at the end (`iallgather`, `igather`, `ibroadcast`,
`ialltoall`, `ireduce`, each returning a `PendingTree`) is the
reference's nonblocking layer (its ``mpi_comms.py``): collectives posted
with ``async_op=True``, waited for by `PendingTree.wait`.  Where the JAX
package passes a global array whose slice ``r`` is rank ``r``'s payload,
each rank here passes its own payload, in a process group (``group``,
the default group when None) in place of a mesh axis.
"""

from __future__ import annotations

import threading
import time
from typing import Any

import torch
import torch.distributed as dist

from ..utils.bytes import bytes_of
from ..utils.flatten import (tree_flatten, tree_leaves, tree_map,
                             tree_unflatten)
from .mesh import PS_AXIS, axis_group

Tree = Any

DEFAULT_BUCKET_BYTES = 4 << 20  # 4 MiB: ~ICI bandwidth-delay product scale

# Solo threshold as a fraction of the bucket budget: a leaf already
# carrying bucket_bytes/16 (256 KiB at the default) amortizes a
# collective's issue latency on its own, so packing it into a shared
# bucket buys nothing and pays the concatenate-in / slice-out memcpy both
# ways.
_SOLO_DIVISOR = 16


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


def _plan_buckets(leaves, bucket_bytes: int, solo_bytes: int = 0):
    """Greedy same-dtype packing: lists of leaf indices, each list's total
    payload <= bucket_bytes (a single oversized leaf gets its own bucket).
    Deterministic in leaf order.

    ``solo_bytes`` (0 = off, the legacy plan): leaves at or above the
    threshold get their own bucket instead of sharing one — packing
    exists to amortize per-collective dispatch/latency over many SMALL
    leaves, and a leaf that already amortizes it alone only pays the
    concat/slice memcpy for sharing.  The resulting collectives compute
    the same elementwise sums (grouping never changes per-element
    operand order)."""
    by_dtype: "dict[Any, list[int]]" = {}
    plan: list[list[int]] = []
    for i, x in enumerate(leaves):
        nb = _nbytes(x)
        if solo_bytes and nb >= solo_bytes:
            plan.append([i])
            continue
        by_dtype.setdefault(x.dtype, []).append(i)
    for idxs in by_dtype.values():
        cur: list[int] = []
        cur_bytes = 0
        for i in idxs:
            nb = _nbytes(leaves[i])
            if cur and cur_bytes + nb > bucket_bytes:
                plan.append(cur)
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += nb
        if cur:
            plan.append(cur)
    return plan


# Auto-solo floor: below ~64 KiB a leaf does NOT amortize its own
# collective/frame dispatch, so solo-ing it would multiply issue cost —
# the exact failure packing exists to prevent.  The auto threshold
# therefore never drops below this, however small the bucket budget.
_SOLO_FLOOR = 64 << 10


def _solo_default(bucket_bytes: int, solo_bytes: "int | None") -> int:
    """Resolve the solo threshold: None = auto (bucket_bytes /
    `_SOLO_DIVISOR`, floored at `_SOLO_FLOOR`), 0 = disabled (pack
    everything, the legacy plan)."""
    if solo_bytes is None:
        return max(_SOLO_FLOOR, int(bucket_bytes) // _SOLO_DIVISOR)
    return int(solo_bytes)


# ---------------------------------------------------------------------------
# One flat collective
# ---------------------------------------------------------------------------

# Flat collectives issued by each thread (each bucket's, each solo
# leaf's), read before and after a phase (`flat_calls`): per thread, so no
# other thread's collectives fall inside the phase and no increment is
# lost to a race.
_issued = threading.local()


def _count(n: int = 1) -> None:
    _issued.n = getattr(_issued, "n", 0) + n


def flat_calls() -> int:
    """How many flat collectives the bucketed tree collectives have
    issued from this thread so far."""
    return getattr(_issued, "n", 0)


def _all_reduce_flat(flat: torch.Tensor, group) -> torch.Tensor:
    """Sum a contiguous 1-D tensor across ranks, in place."""
    _count()
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return flat


def _all_gather_flat(flat: torch.Tensor, group, works=None) -> torch.Tensor:
    """Gather a contiguous 1-D tensor from every rank into ``(world, n)``.

    A gather is pure data movement, so it moves the bytes: one path for
    every dtype, including int16, which neither gloo nor NCCL takes.  With
    a ``works`` list the gather is issued asynchronously and ``(work,
    input)`` is appended to it; the result holds the gathered bytes once
    the work has been waited for."""
    _count()
    world = dist.get_world_size(group)
    raw = flat.view(torch.int8)
    out = torch.empty((world * raw.numel(),), dtype=torch.int8,
                      device=flat.device)
    work = _all_gather_into(out, raw, group=group,
                            async_op=works is not None)
    if works is not None:
        works.append((work, raw))
    return out.view(flat.dtype).view(world, flat.numel())


# The same collectives under their newer names, where PyTorch has them (the
# old names warn there).
_all_gather_into = getattr(dist, "all_gather_single",
                           dist.all_gather_into_tensor)
_reduce_scatter_into = getattr(dist, "reduce_scatter_single",
                               dist.reduce_scatter_tensor)


def _allreduce_rs_ag(x: torch.Tensor, group, world: int, *,
                     async_op: bool = False):
    """All-reduce one flat tensor as a reduce-scatter and an all-gather.

    The same cross-rank sum as an all-reduce (an all-reduce is the two on
    the wire), after the JAX package's `_allreduce_rs_ag`: pad to a
    multiple of ``world``, reduce-scatter, all-gather, slice.  ``x`` is
    not written.  With ``async_op=True`` returns ``(result, works)``:
    ``works`` holds each collective's handle with the buffers it reads or
    writes, and the result is valid once they have been waited for, in
    order.  NCCL runs a group's collectives in issue order on one stream,
    so there the gather is queued behind the scatter at once; gloo runs
    them on several threads, so there the scatter is waited for first."""
    _count(2)
    n = x.numel()
    pad = (-n) % world
    if pad:
        x = torch.cat([x, x.new_zeros((pad,))])
    mine = x.new_empty((x.numel() // world,))
    full = torch.empty_like(x)
    rs = _reduce_scatter_into(mine, x, op=dist.ReduceOp.SUM, group=group,
                              async_op=True)
    if not x.is_cuda:
        rs.wait()
    ag = _all_gather_into(full, mine, group=group, async_op=True)
    out = full[:n] if pad else full
    works = [(rs, x), (ag, mine)]
    if async_op:
        return out, works
    for work, _ in works:
        work.wait()
    return out


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------


def _bucketed_leafwise(tree: Tree, collective, bucket_bytes: "int | None",
                       solo_bytes: int = 0) -> Tree:
    """Run ``collective`` (flat 1-D tensor -> tensor, possibly growing a
    leading world dim) over dtype-bucketed concatenations of the tree's
    leaves, then slice each leaf's segment back out of the last axis and
    restore its shape (keeping any grown leading dim).
    ``bucket_bytes=None``/0 runs one collective per leaf.  A leaf alone in
    its bucket goes through as a flat view (for a reduction, in place)."""
    leaves, treedef = tree_flatten(tree)
    if bucket_bytes:
        plan = _plan_buckets(leaves, bucket_bytes, solo_bytes)
    else:
        plan = [[i] for i in range(len(leaves))]
    out: list[Any] = [None] * len(leaves)
    for idxs in plan:
        if len(idxs) == 1:
            x = leaves[idxs[0]]
            res = collective(x.contiguous().view(-1))
            out[idxs[0]] = res.view(res.shape[:-1] + x.shape)
            continue
        flat = torch.cat([leaves[i].reshape(-1) for i in idxs])
        res = collective(flat)
        off = 0
        for i in idxs:
            n = leaves[i].numel()
            seg = res[..., off:off + n]
            out[i] = seg.reshape(seg.shape[:-1] + leaves[i].shape)
            off += n
    return tree_unflatten(treedef, out)


def psum_tree_bucketed(tree: Tree, group=None, *,
                       bucket_bytes: "int | None" = DEFAULT_BUCKET_BYTES,
                       decompose: bool = False,
                       solo_bytes: "int | None" = None) -> Tree:
    """Sum every leaf across ranks — the reference's ``sum(grads)``: a
    **sum, not a mean** — with dtype-bucketed flat all-reduces.  A
    contiguous leaf that goes solo is reduced in place (the PS step owns
    its gradients); callers that need their tree intact pass a copy.
    ``decompose=True`` sums each bucket (each leaf, with
    ``bucket_bytes=None``) as a reduce-scatter and an all-gather
    (`_allreduce_rs_ag`): the same sum, and no leaf is written."""
    if decompose:
        world = dist.get_world_size(group)

        def reduce(x):
            return _allreduce_rs_ag(x, group, world)
    else:
        def reduce(x):
            return _all_reduce_flat(x, group)
    solo = _solo_default(bucket_bytes, solo_bytes) if bucket_bytes else 0
    return _bucketed_leafwise(tree, reduce, bucket_bytes, solo)


def allgather_tree_bucketed(tree: Tree, group=None, *,
                            bucket_bytes: "int | None" = DEFAULT_BUCKET_BYTES,
                            solo_bytes: "int | None" = None,
                            works: "list | None" = None) -> Tree:
    """All-gather every leaf (untiled: leaves grow a leading world dim)
    with dtype-bucketed flat all-gathers.  A leaf of a shared bucket comes
    back as a strided view ``(world, *shape)`` of the gathered bucket; the
    codec kernels read it in place.  With a ``works`` list each gather is
    issued asynchronously (see `_all_gather_flat`), and the leaves hold
    the gathered codes once every work appended to it has been waited
    for."""
    solo = _solo_default(bucket_bytes, solo_bytes) if bucket_bytes else 0
    return _bucketed_leafwise(
        tree, lambda x: _all_gather_flat(x, group, works), bucket_bytes, solo)


def pmean_tree(tree: Tree, group=None, *,
               bucket_bytes: "int | None" = DEFAULT_BUCKET_BYTES) -> Tree:
    """Mean of every leaf across ranks (``psum / world``, as ``lax.pmean``
    computes it), bucketed like `psum_tree_bucketed`; the input tree is
    left as it is.  ``group`` is a process group (None: the default) or
    an axis name or tuple of the current mesh.  A tree with a leaf that
    requires grad goes through the differentiable `psum_tree` (whose
    transpose is a psum), leaf by leaf."""
    group = axis_group(group)
    world = dist.get_world_size(group)
    if any(x.requires_grad for x in tree_leaves(tree)):
        return tree_map(lambda x: _PSum.apply(x, group) / world, tree)
    summed = psum_tree_bucketed(tree_map(torch.clone, tree), group,
                                bucket_bytes=bucket_bytes)
    return tree_map(lambda x: x / world, summed)


def reduce_scatter_flats_bucketed(
        tree: Tree, group=None, *, world: int,
        bucket_bytes: "int | None" = DEFAULT_BUCKET_BYTES) -> Tree:
    """Bucketed ZeRO gradient sync: every leaf is a padded flat
    ``(world * chunk_leaf,)`` whose tile ``r`` belongs to rank ``r``;
    returns ``(chunk_leaf,)`` leaves holding the cross-rank SUM of this
    rank's tile.  A bucket concatenates the per-rank tiles of its leaves
    into one ``(world, total)`` block, so a single reduce-scatter serves
    them all — the same elementwise sums as the per-leaf lowering.  The
    JAX package's plan: same-dtype buckets, large leaves solo."""
    def per_leaf(x):
        _count()
        mine = x.new_empty((x.numel() // world,))
        _reduce_scatter_into(mine, x.contiguous(), op=dist.ReduceOp.SUM,
                             group=group)
        return mine

    leaves, treedef = tree_flatten(tree)
    if not bucket_bytes:
        return tree_unflatten(treedef, [per_leaf(x) for x in leaves])
    out: list[Any] = [None] * len(leaves)
    for idxs in _plan_buckets(leaves, bucket_bytes,
                              _solo_default(bucket_bytes, None)):
        if len(idxs) == 1:
            out[idxs[0]] = per_leaf(leaves[idxs[0]])
            continue
        cat = torch.cat([leaves[i].reshape(world, -1) for i in idxs], dim=1)
        mine = per_leaf(cat.reshape(-1))
        off = 0
        for i in idxs:
            chunk = leaves[i].numel() // world
            out[i] = mine[off:off + chunk]
            off += chunk
    return tree_unflatten(treedef, out)


# ---------------------------------------------------------------------------
# Host API — nonblocking collectives on trees
# ---------------------------------------------------------------------------


class PendingTree:
    """A posted collective — the ``MPI.Request`` analogue.  ``result`` holds
    the output tree (valid after `wait`); ``timings`` has ``msg_bytes``
    (the bytes of the tree this rank passed) and ``<name>_time`` (the
    time to post).  `wait` blocks until every transfer is complete (on
    the card, until the stream has run them) and records ``comm_wait``
    once, as the reference's ``ps.py`` does."""

    def __init__(self, result: Tree, timings: "dict[str, float]",
                 works=()):
        self.result = result
        self.timings = timings
        # (work, buffer) pairs: each buffer the work reads or writes is
        # referenced until the wait.
        self._works = list(works)
        self._done = False

    def wait(self) -> Tree:
        start = time.perf_counter()
        for work, _ in self._works:
            work.wait()
        cards = {x.device for x in tree_flatten(self.result)[0]
                 if isinstance(x, torch.Tensor) and x.is_cuda}
        for device in cards:
            torch.cuda.current_stream(device).synchronize()
        if not self._done:
            self.timings["comm_wait"] = time.perf_counter() - start
            self._done = True
        return self.result

    # The Request-like spelling.
    Wait = wait


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x``'s bytes: what a collective may write,
    in a dtype every backend moves."""
    return x.detach().contiguous().clone().reshape(-1).view(torch.int8)


def _post(name: str, tree: Tree, per_leaf) -> PendingTree:
    """Post ``per_leaf(x, works) -> out`` on every leaf; one PendingTree."""
    timings: "dict[str, float]" = {"msg_bytes": bytes_of(tree)}
    works: list = []
    start = time.perf_counter()
    leaves, treedef = tree_flatten(tree)
    out = tree_unflatten(treedef, [per_leaf(x, works) for x in leaves])
    timings[f"{name}_time"] = time.perf_counter() - start
    return PendingTree(out, timings, works)


def _src(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def iallgather(tree: Tree, group=None) -> PendingTree:
    """Every rank ends with the stack ``[world, ...]`` of every rank's
    leaves — the reference's ``Iallgather`` of sizes and ``Iallgatherv``
    of payloads."""
    def leaf(x, works):
        world = dist.get_world_size(group)
        flat = x.detach().contiguous().reshape(-1)
        return _all_gather_flat(flat, group, works).view(world, *x.shape)

    return _post("iallgather", tree, leaf)


def igather(tree: Tree, group=None, *, root: int = 0,
            root_only: bool = False) -> PendingTree:
    """Gather to ``root`` — the reference's ``Igatherv``.  ``root_only=
    False`` is the all-gather (every rank holds the stack, as the JAX
    package's SPMD lowering has it); ``root_only=True`` is a true gather:
    the stack ``[world, ...]`` lands on ``root`` alone, and every other
    rank sends its payload and holds no stack (its result is None)."""
    if not root_only:
        return iallgather(tree, group)
    world = dist.get_world_size(group)
    me = dist.get_rank(group)

    def leaf(x, works):
        raw = _bytes(x)
        if me != root:
            works.append((dist.gather(raw, None, dst=_src(group, root),
                                      group=group, async_op=True), raw))
            return None
        stack = raw.new_empty((world, raw.numel()))
        works.append((dist.gather(raw, list(stack.unbind(0)),
                                  dst=_src(group, root), group=group,
                                  async_op=True), raw))
        return stack.view(x.dtype).view(world, *x.shape)

    pending = _post("igather", tree, leaf)
    if me != root:
        pending.result = None
    return pending


def ibroadcast(tree: Tree, group=None, *, root: int = 0) -> PendingTree:
    """Every rank ends with ``root``'s payload — the reference's ``Ibcast``
    of the parameters (AsySG-InCon's push); the caller's tree is not
    written."""
    def leaf(x, works):
        raw = _bytes(x)
        works.append((dist.broadcast(raw, src=_src(group, root),
                                     group=group, async_op=True), raw))
        return raw.view(x.dtype).view(x.shape)

    return _post("ibroadcast", tree, leaf)


def ialltoall(tree: Tree, group=None) -> PendingTree:
    """Slice ``j`` of each rank's ``[world, ...]`` payload goes to rank
    ``j``: afterwards slice ``i`` of rank ``j``'s result is rank ``i``'s
    slice ``j`` — the reference's ``Ialltoallv``, static shapes."""
    def leaf(x, works):
        world = dist.get_world_size(group)
        if x.shape[0] != world:
            raise ValueError(f"ialltoall needs a leading dim of the world "
                             f"size {world}, got shape {tuple(x.shape)}")
        raw = _bytes(x).view(world, -1)
        out = torch.empty_like(raw)
        works.append((dist.all_to_all_single(out, raw, group=group,
                                             async_op=True), raw))
        return out.view(x.dtype).view(x.shape)

    return _post("ialltoall", tree, leaf)


def ireduce(tree: Tree, group=None) -> PendingTree:
    """The sum of every rank's payload, on every rank (an all-reduce, as
    the JAX package lowers it); the caller's tree is not written."""
    def leaf(x, works):
        out = x.detach().contiguous().clone()
        works.append((dist.all_reduce(out, op=dist.ReduceOp.SUM,
                                      group=group, async_op=True), out))
        return out

    return _post("ireduce", tree, leaf)


# ---------------------------------------------------------------------------
# In-step collectives over mesh axes, with JAX's transposes
# ---------------------------------------------------------------------------
#
# The JAX package's in-step tier (``psum_tree``, ``ppermute_tree``, ...)
# names a mesh axis inside ``shard_map`` and differentiates through
# ``lax.psum``, ``lax.ppermute`` and ``lax.all_to_all`` by their
# transposes.  Here ``axis`` is resolved against the current mesh
# (`parallel.mesh.axis_group`; a process group also passes), and each
# collective a loss differentiates through is a `torch.autograd.Function`
# whose backward is the JAX transpose: a psum's is a psum of the
# cotangent (not the identity: the ×tp and ×pp factors it gives are what
# the PS step's mean over the extra axes cancels), a ppermute's the
# inverse permutation, an all-to-all's the inverse all-to-all.
# ``torch.distributed``'s own collectives have no gradient.  Every rank of
# a group runs the same graph, so the backward collectives run in the
# same order on each.


def _axis(axis):
    """``(group, index, size)`` of an axis name, tuple or process group."""
    group = axis_group(axis)
    return group, dist.get_rank(group), dist.get_world_size(group)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def psum(x: torch.Tensor, axis=PS_AXIS) -> torch.Tensor:
    """``lax.psum`` of one tensor: the sum over ``axis``, differentiable
    (the cotangent is summed too).  Bool and sub-word integers sum as
    int32, as ``lax.psum`` promotes them."""
    group = axis_group(axis)
    if x.dtype in (torch.bool, torch.int8, torch.uint8, torch.int16):
        return _PSum.apply(x.to(torch.int32), group)
    return _PSum.apply(x, group)


def _perm_pairs(perm, size: int):
    pairs = [(int(s), int(d)) for s, d in perm]
    for s, d in pairs:
        if not (0 <= s < size and 0 <= d < size):
            raise ValueError(f"ppermute pair {(s, d)} out of range for an "
                             f"axis of size {size}")
    if (len({s for s, _ in pairs}) != len(pairs)
            or len({d for _, d in pairs}) != len(pairs)):
        raise ValueError(f"ppermute needs a permutation: sources and "
                         f"destinations each distinct, got {pairs}")
    return pairs


def _ppermute_raw(x: torch.Tensor, group, me: int, pairs) -> torch.Tensor:
    """Send ``x`` along each ``(src, dst)`` pair of group ranks; a rank
    no pair sends to gets zeros.  A pair ``(i, i)`` is a local copy: no
    collective library gets a send to self."""
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in pairs:
        if src == dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x,
                                  dist.get_global_rank(group, dst), group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, src), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, me, pairs):
        ctx.group, ctx.me, ctx.pairs = group, me, pairs
        return _ppermute_raw(x, group, me, pairs)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.pairs]
        return _ppermute_raw(g, ctx.group, ctx.me, inverse), None, None, None


def ppermute(x: torch.Tensor, axis, perm) -> torch.Tensor:
    """``lax.ppermute``: rank ``src`` of ``axis`` sends ``x`` to rank
    ``dst`` for each pair of ``perm``; ranks that receive nothing get
    zeros.  The backward sends the cotangents along the inverse pairs."""
    group, me, size = _axis(axis)
    return _PPermute.apply(x, group, me, _perm_pairs(perm, size))


def _all_to_all_raw(x: torch.Tensor, group, size: int, split_axis: int,
                    concat_axis: int, tiled: bool) -> torch.Tensor:
    """``lax.all_to_all``: chunk ``j`` of ``x`` along ``split_axis`` goes to
    rank ``j``; the chunks received are concatenated along
    ``concat_axis`` in rank order (``tiled``), or stacked into a new axis
    there (``tiled=False``, where ``split_axis`` has size ``size`` and is
    removed)."""
    if tiled:
        if x.shape[split_axis] % size:
            raise ValueError(f"all_to_all: dimension {split_axis} of size "
                             f"{x.shape[split_axis]} does not split into "
                             f"{size}")
        chunks = x.chunk(size, dim=split_axis)
    else:
        if x.shape[split_axis] != size:
            raise ValueError(f"all_to_all (untiled): dimension {split_axis}"
                             f" has size {x.shape[split_axis]}, not the "
                             f"axis size {size}")
        chunks = x.unbind(split_axis)
    send = torch.stack(chunks).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    parts = recv.unbind(0)
    if tiled:
        return torch.cat(parts, dim=concat_axis)
    return torch.stack(parts, dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, split_axis, concat_axis, tiled):
        ctx.args = (group, size, split_axis, concat_axis, tiled)
        return _all_to_all_raw(x, group, size, split_axis, concat_axis,
                               tiled)

    @staticmethod
    def backward(ctx, g):
        group, size, split_axis, concat_axis, tiled = ctx.args
        # The inverse all-to-all: split where the forward concatenated,
        # concatenate where it split.
        return (_all_to_all_raw(g, group, size, concat_axis, split_axis,
                                tiled), None, None, None, None, None)


def all_to_all(x: torch.Tensor, axis, split_axis: int, concat_axis: int,
               *, tiled: bool = False) -> torch.Tensor:
    """``lax.all_to_all`` over ``axis``, differentiable (the backward is
    the inverse all-to-all)."""
    group, _, size = _axis(axis)
    nd = x.dim()
    split_axis %= nd
    concat_axis %= (nd if tiled else nd - 1)
    return _AllToAll.apply(x, group, size, split_axis, concat_axis, tiled)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, me, size):
        ctx.group, ctx.me = group, me
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, g):
        # The transpose of a gather is a reduce-scatter: the sum over
        # ranks of the cotangent's row of this rank.
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g[ctx.me], None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, me, size):
        ctx.group, ctx.me, ctx.size = group, me, size
        if x.shape[0] % size:
            raise ValueError(f"psum_scatter: dimension 0 of size "
                             f"{x.shape[0]} does not split into {size}")
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y.chunk(size)[me].clone()

    @staticmethod
    def backward(ctx, g):
        parts = [torch.empty_like(g, memory_format=torch.contiguous_format)
                 for _ in range(ctx.size)]
        dist.all_gather(parts, g.contiguous(), group=ctx.group)
        return torch.cat(parts), None, None, None


def psum_tree(tree: Tree, axis=PS_AXIS) -> Tree:
    """Sum every leaf across ``axis`` — the reference's ``d_p =
    sum(grads)``, a **sum, not a mean** — differentiable."""
    return tree_map(lambda x: psum(x, axis), tree)


def allgather_tree(tree: Tree, axis=PS_AXIS, *, tiled: bool = False) -> Tree:
    """All-gather every leaf across ``axis``: a new leading dim of the
    axis size, or (``tiled``) the rows concatenated along dim 0."""
    group, me, size = _axis(axis)

    def one(x):
        y = _AllGather.apply(x, group, me, size)
        return y.reshape((-1,) + tuple(x.shape[1:])) if tiled else y
    return tree_map(one, tree)


def bcast_tree(tree: Tree, axis=PS_AXIS, *, root: int = 0) -> Tree:
    """Every rank of ``axis`` receives ``root``'s value, as a masked
    all-reduce (every other rank contributes zeros), dtype-preserving."""
    group, me, _ = _axis(axis)

    def one(x):
        contrib = x if me == root else torch.zeros_like(x)
        return psum(contrib, group).to(x.dtype)
    return tree_map(one, tree)


def reduce_scatter_tree(tree: Tree, axis=PS_AXIS) -> Tree:
    """Sum across ``axis``; each rank keeps its tile of dim 0."""
    group, me, size = _axis(axis)
    return tree_map(lambda x: _ReduceScatter.apply(x, group, me, size), tree)


def alltoall_tree(tree: Tree, axis=PS_AXIS) -> Tree:
    """Transpose rank and leading dim: tile ``j`` of dim 0 goes to rank
    ``j`` (the reference's ``Ialltoallv`` with static shapes)."""
    return tree_map(lambda x: all_to_all(x, axis, 0, 0, tiled=True), tree)


def ppermute_tree(tree: Tree, axis, perm) -> Tree:
    """Point-to-point permutation of every leaf over ``axis``."""
    return tree_map(lambda x: ppermute(x, axis, perm), tree)


def ring_shift_tree(tree: Tree, axis=PS_AXIS, *, shift: int = 1,
                    size: "int | None" = None) -> Tree:
    """Shift every leaf ``shift`` hops around the ring of ``axis``."""
    n = size if size is not None else _axis(axis)[2]
    perm = [(i, (i + shift) % n) for i in range(n)]
    return ppermute_tree(tree, axis, perm)


def rank(axis=PS_AXIS) -> int:
    """``comm.Get_rank()``: this rank's index along ``axis``."""
    return _axis(axis)[1]
