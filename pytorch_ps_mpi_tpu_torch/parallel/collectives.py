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

import time
from typing import Any

import torch
import torch.distributed as dist

from ..utils.bytes import bytes_of
from ..utils.flatten import tree_flatten, tree_map, tree_unflatten

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


def _all_reduce_flat(flat: torch.Tensor, group) -> torch.Tensor:
    """Sum a contiguous 1-D tensor across ranks, in place."""
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return flat


def _all_gather_flat(flat: torch.Tensor, group, works=None) -> torch.Tensor:
    """Gather a contiguous 1-D tensor from every rank into ``(world, n)``.

    A gather is pure data movement, so it moves the bytes: one path for
    every dtype, including int16, which neither gloo nor NCCL takes.  With
    a ``works`` list the gather is issued asynchronously and ``(work,
    input)`` is appended to it; the result holds the gathered bytes once
    the work has been waited for."""
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
    left as it is."""
    world = dist.get_world_size(group)
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
