"""Overlapped bucket-scheduled gradient sync — each bucket's exchange
issued inside backward — and the async PS's bucket-streamed gradient.

Counterpart of `pytorch_ps_mpi_tpu/parallel/overlap.py`: its sync half
first, its async half (`make_async_bucket_step`, `split_tree`,
`iter_ready_groups`, `merge_buckets`) at the end.
The reference hides communication behind computation with per-parameter
backward hooks that put each gradient on the wire the moment it is
produced (the reference's `ps.py:63-66,98-101`).  The gradients are
partitioned into size-targeted buckets (`plan_overlap`: the same greedy
same-dtype packing as the post-backward exchange), and each bucket's sync
is split in two:

* ``start(cot)`` runs inside backward, as soon as every gradient of the
  bucket exists: it issues the bucket's collective with ``async_op=True``
  (for a codec, after encoding the bucket) and returns a pending record;
* ``finish(pendings)`` runs after backward: it waits for the collectives
  and decodes every codec bucket of the step in one grouped launch.

Waiting inside backward would make the card's compute stream wait for the
collective, and every backward kernel queued after it with it; so nothing
waits before backward has returned.

`BucketHooks` drives a step: a hook on each parameter leaf collects its
gradient and starts the bucket once the bucket is complete.  Hooks on the
leaves run at the top priority of autograd's ready queue (a leaf's
gradient accumulator comes first), so a bucket starts as soon as its last
gradient is computed.  An identity `torch.autograd.Function` wrapped
around the parameters before the forward — `attach`, the JAX package's
``custom_vjp`` hook — has the opposite priority (its node is older than
every node of the forward), so its backward runs only once the rest of
the backward is done: `attach` and `wrap_loss` give the JAX contract
(gradients come back summed) and the step uses `BucketHooks`.

Two reducers for the identity codec, as in the JAX package: ``rs_ag`` (a
reduce-scatter and an all-gather per bucket, the default) and ``psum``
(one all-reduce per bucket).  ``fused_encode`` quantizes a blockq bucket
as one tensor (`_BlockqFusedSync`): one ``block_quantize`` launch and one
gather per bucket instead of a launch per leaf, with tiles that straddle
leaves.
"""

from __future__ import annotations

import json
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.distributed as dist

from ..ops import codec_kernels as ck
from ..ops.codecs import BlockQuantizeCodec, Codec
from ..utils.interop import from_jax_order as _unwire
from ..utils.interop import to_jax_order as _wire
from ..utils.timing import record_overlap_schedule
from . import collectives
from .collectives import _allreduce_rs_ag, _plan_buckets
from .mesh import record_event

# The JAX package's bounds for a tuned bucket: below ~1 MiB a bucket's
# wire time stops amortizing a collective's issue cost; above ~32 MiB the
# first bucket finishes so late that little backward is left to hide it.
MIN_BUCKET_BYTES = 1 << 20
MAX_BUCKET_BYTES = 32 << 20
TARGET_BUCKETS = 16
# The JAX package's per-hop latency scale for the tuner's amortization
# floor (a collective over a ring serializes ~world-1 hops).
PER_HOP_LATENCY_S = 10e-6
# HBM rate of one NVIDIA H100 SXM (HBM3, NVIDIA's data sheet): the rate
# `auto_bucket_bytes` uses unless a roofline file gives another.
H100_HBM_BYTES_PER_S = 3.35e12

# A bucket is already size-targeted: its codes go in one flat transfer per
# dtype (the inner re-bucketing is off at this size).
_WHOLE = 1 << 62


@dataclass(frozen=True)
class OverlapPlan:
    """A bucket schedule over named gradient leaves.

    ``buckets`` holds tuples of parameter names; every bucket is same-dtype
    (a `_plan_buckets` invariant) and its total payload is <= ``bucket_bytes``
    except for single oversized leaves, which get their own bucket.
    """

    buckets: tuple  # tuple[tuple[str, ...], ...]
    bucket_bytes: int
    total_bytes: int
    auto_tuned: bool = False

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    def describe(self) -> dict:
        """JSON-able schedule record for instrumentation."""
        return {
            "n_buckets": self.n_buckets,
            "bucket_bytes": int(self.bucket_bytes),
            "total_bytes": int(self.total_bytes),
            "auto_tuned": bool(self.auto_tuned),
            "bucket_sizes": [len(b) for b in self.buckets],
        }


def auto_bucket_bytes(total_bytes: int, *, world: int = 8,
                      roofline_path: str | None = None) -> int:
    """Pick a bucket size: the JAX package's formula.

    * **granularity** — aim for ~`TARGET_BUCKETS` buckets, so backward has
      pieces to overlap;
    * **latency floor** — a bucket carries enough bytes that its wire time
      (at a link rate taken as a tenth of the HBM rate) covers the
      ~(world-1) hops of a ring collective's latency.

    The HBM rate is ``peaks.hbm_bytes_per_s`` of the JSON file at
    ``roofline_path`` when one is given and readable, else
    `H100_HBM_BYTES_PER_S`.  No file is read by default: the repo's
    roofline file was measured on a TPU.  The result is clamped to
    [`MIN_BUCKET_BYTES`, `MAX_BUCKET_BYTES`].
    """
    hbm_bytes_per_s = H100_HBM_BYTES_PER_S
    if roofline_path is not None:
        try:
            with open(roofline_path) as f:
                hbm_bytes_per_s = float(
                    json.load(f)["peaks"]["hbm_bytes_per_s"])
        except (OSError, KeyError, ValueError):
            pass
    link_bytes_per_s = hbm_bytes_per_s / 10.0
    hops = max(int(world) - 1, 1)
    latency_floor = int(link_bytes_per_s * PER_HOP_LATENCY_S * hops)
    granularity = max(1, int(total_bytes) // TARGET_BUCKETS)
    raw = max(granularity, latency_floor)
    return int(min(max(raw, MIN_BUCKET_BYTES), MAX_BUCKET_BYTES))


def plan_overlap(named_tensors, bucket_bytes: int | None = None, *,
                 world: int = 8, record: bool = True,
                 roofline_path: str | None = None,
                 solo_bytes: int = 0) -> OverlapPlan:
    """Partition named gradient leaves into an `OverlapPlan`.

    ``named_tensors`` maps names to tensors (the params; gradients share
    their shapes and dtypes).  ``bucket_bytes=None``/0 auto-tunes
    (`auto_bucket_bytes`).  ``solo_bytes`` (default 0: pack everything)
    lets large leaves stand alone.  The schedule is recorded through
    `utils.timing.record_overlap_schedule` unless ``record=False``.
    """
    items = list(named_tensors.items())
    names = [n for n, _ in items]
    leaves = [x for _, x in items]
    total = sum(x.numel() * x.element_size() for x in leaves)
    tuned = not bucket_bytes
    if tuned:
        bucket_bytes = auto_bucket_bytes(total, world=world,
                                         roofline_path=roofline_path)
    plan_idx = _plan_buckets(leaves, bucket_bytes, int(solo_bytes))
    plan = OverlapPlan(
        buckets=tuple(tuple(names[i] for i in idxs) for idxs in plan_idx),
        bucket_bytes=int(bucket_bytes), total_bytes=int(total),
        auto_tuned=tuned)
    if record:
        record_overlap_schedule(plan.describe())
    return plan


# ---------------------------------------------------------------------------
# The bucket syncs: start inside backward, finish after it
# ---------------------------------------------------------------------------


@dataclass
class _Pending:
    """A started bucket: ``metas`` maps its names to ``(shape, dtype)``;
    ``works`` holds ``(work, buffer)`` pairs, each collective's handle
    with a buffer it reads or writes, referenced until the wait; ``out``
    is what `finish` reads once they are done."""

    metas: "OrderedDict[str, tuple]"
    works: list
    out: Any


def _metas(cot) -> "OrderedDict[str, tuple]":
    return OrderedDict((n, (g.shape, g.dtype)) for n, g in cot.items())


def _concat(cot, orders=None) -> torch.Tensor:
    """The bucket's gradients as one new flat tensor (a copy even for one
    leaf: a collective may write it, and autograd may share a cotangent),
    each leaf in the element order of ``orders`` (name -> permutation;
    a permuted leaf is copied in that order on its way into the
    concatenation)."""
    orders = orders or {}
    return torch.cat([_wire(g, orders.get(n)).reshape(-1)
                      for n, g in cot.items()])


def _split(flat: torch.Tensor, metas, orders=None) -> "OrderedDict":
    """Slice a bucket's flat sums back into its leaves' shapes and dtypes
    (a leaf of ``orders`` is sliced in that order and handed back as the
    inverse-permuted view)."""
    orders = orders or {}
    out, off = OrderedDict(), 0
    for n, (shape, dtype) in metas.items():
        size = shape.numel()
        order = orders.get(n)
        wire = shape if order is None else torch.Size(shape[i] for i in order)
        out[n] = _unwire(flat[off:off + size].view(wire).to(dtype), order)
        off += size
    return out


def _wait(pendings) -> None:
    for p in pendings:
        for work, _ in p.works:
            work.wait()


class _BucketSync:
    """Interface: ``start(cot) -> pending`` issues a bucket's exchange;
    ``finish(pendings) -> OrderedDict`` waits for a step's buckets and
    returns their summed gradients, by name.  Calling the sync on one
    bucket's cotangents does both, the JAX package's ``sync_fn(cot)``."""

    def start(self, cot) -> _Pending:
        raise NotImplementedError

    def finish(self, pendings) -> "OrderedDict":
        raise NotImplementedError

    def __call__(self, cot) -> "OrderedDict":
        return self.finish([self.start(cot)])


class _IdentitySync(_BucketSync):
    """One flat cross-rank SUM per same-dtype bucket: concat, reduce,
    slice back.  ``rs_ag`` reduce-scatters and all-gathers; ``psum`` is
    one all-reduce."""

    def __init__(self, group, world: int, reducer: str):
        self.group, self.world, self.reducer = group, world, reducer

    def start(self, cot):
        flat = _concat(cot)
        if self.reducer == "psum":
            work = dist.all_reduce(flat, op=dist.ReduceOp.SUM,
                                   group=self.group, async_op=True)
            return _Pending(_metas(cot), [(work, flat)], flat)
        out, works = _allreduce_rs_ag(flat, self.group, self.world,
                                      async_op=True)
        return _Pending(_metas(cot), works, out)

    def finish(self, pendings):
        _wait(pendings)
        out = OrderedDict()
        for p in pendings:
            out.update(_split(p.out, p.metas))
        return out


class _CodecSync(_BucketSync):
    """Codec-encoded bucket exchange: encode each leaf (in the element
    order of ``orders``), all-gather the bucket's codes as one flat
    transfer per code dtype; after backward, the decode-sums of every
    bucket of the step in one grouped launch (`Codec.decode_sum_leaves`),
    each handed back as the inverse-permuted view."""

    def __init__(self, group, codec: Codec, orders=None):
        self.group, self.codec = group, codec
        self.orders = orders or {}

    def start(self, cot):
        wire = OrderedDict((n, _wire(g, self.orders.get(n)))
                           for n, g in cot.items())
        codes = OrderedDict((n, self.codec.encode(g))
                            for n, g in wire.items())
        works: list = []
        gathered = collectives.allgather_tree_bucketed(
            codes, self.group, bucket_bytes=_WHOLE, works=works)
        return _Pending(_metas(wire), works, gathered)

    def finish(self, pendings):
        _wait(pendings)
        gathered, metas = OrderedDict(), OrderedDict()
        for p in pendings:
            gathered.update(p.out)
            metas.update(p.metas)
        if not metas:
            return OrderedDict()
        out = self.codec.decode_sum_leaves(gathered, metas)
        return OrderedDict((n, _unwire(g, self.orders.get(n)))
                           for n, g in out.items())


class _BlockqFusedSync(_BucketSync):
    """The fused bucket exchange of the blockq codec: one concat, one
    ``block_quantize`` launch over the whole bucket with
    ``codec._rows_for(bucket size)``-row tiles (tiles straddle leaves: the
    wire is the bucket's, not the leaves'), and one gather of the codes
    with the scales behind them; after backward, every bucket of the step
    is one leaf of one grouped ``block_dequant_sum`` launch, and each
    bucket's sums are sliced back and cast to its leaves' dtype.  Leaves
    of ``orders`` enter the bucket in that element order and come back
    as inverse-permuted views."""

    def __init__(self, group, codec: BlockQuantizeCodec, orders=None):
        self.group, self.codec = group, codec
        self.orders = orders or {}

    def start(self, cot):
        flat = _concat(cot, self.orders).to(torch.float32)
        rows = self.codec._rows_for(flat.numel())
        q, scales = ck.block_quantize(flat, bits=self.codec.bits,
                                      block_rows=rows)
        # One transfer a bucket: the codes' bytes, then the scales' (a
        # multiple of 128 codes, so the scales stay 4-byte aligned).
        wire = torch.cat([q.view(-1).view(torch.int8),
                          scales.view(-1).view(torch.int8)])
        works: list = []
        gathered = collectives._all_gather_flat(wire, self.group, works)
        return _Pending(_metas(cot), works,
                        (gathered, q.shape, q.dtype, scales.shape,
                         flat.numel(), rows))

    def finish(self, pendings):
        _wait(pendings)
        if not pendings:
            return OrderedDict()
        leaves = []
        for gathered, qshape, qdtype, sshape, n, rows in (
                p.out for p in pendings):
            world, split = gathered.shape[0], qshape.numel() * qdtype.itemsize
            q = gathered[:, :split].view(qdtype).view(world, *qshape)
            scales = gathered[:, split:].view(torch.float32).view(
                world, *sshape)
            leaves.append((q, scales, n, rows))
        _, views = ck.block_dequant_sum_group(leaves)
        out = OrderedDict()
        for p, v in zip(pendings, views):
            out.update(_split(v, p.metas, self.orders))
        return out


def _sync_identity(cot: "OrderedDict", group, world: int, reducer: str):
    """One bucket's cross-rank sum on the identity path, start to finish
    (the JAX package's `_sync_identity`)."""
    return _IdentitySync(group, world, reducer)(cot)


def _sync_codec(cot: "OrderedDict", group, codec: Codec):
    """One bucket's codec exchange, start to finish (the JAX package's
    `_sync_codec`)."""
    return _CodecSync(group, codec)(cot)


def _sync_blockq_fused(cot: "OrderedDict", group, codec: BlockQuantizeCodec):
    """One bucket's fused blockq exchange, start to finish (the JAX
    package's `_sync_blockq_fused`).  Parity contract: bitwise the staged
    composition — `block_quantize_ref` of each rank's concatenated bucket,
    stacked in rank order, `block_dequant_sum_ref`."""
    return _BlockqFusedSync(group, codec)(cot)


def make_bucket_sync_fn(*, group, world: int, codec=None,
                        reducer: str = "rs_ag",
                        fused_encode: bool = False,
                        orders=None) -> _BucketSync:
    """The per-bucket sync (applied to every bucket's cotangents).
    ``codec=None`` (the caller passes None for the identity codec) uses the
    flat-sum reducers; otherwise each bucket rides the codec's
    encode/gather/decode-sum, each leaf named in ``orders`` (name ->
    `utils.interop.jax_order` permutation) encoded in that order.

    ``fused_encode=True`` swaps in the fused twin: the identity path is
    already one flat sum per bucket, so it is unchanged there, and the
    blockq codec quantizes each bucket as one tensor.  Other codecs
    refuse: a knob that silently fell back to the per-leaf path would
    claim a fusion it never ran."""
    if reducer not in ("rs_ag", "psum"):
        raise ValueError(f"unknown overlap reducer {reducer!r}; "
                         "have ('rs_ag', 'psum')")
    if codec is None:
        return _IdentitySync(group, world, reducer)
    if not fused_encode:
        return _CodecSync(group, codec, orders)
    if not isinstance(codec, BlockQuantizeCodec):
        raise ValueError(
            f"fused_encode supports the identity and blockq codecs; "
            f"got {type(codec).__name__} — run it unfused, or switch "
            f"the sync codec to 'blockq'")
    return _BlockqFusedSync(group, codec, orders)


# ---------------------------------------------------------------------------
# Driving the syncs from backward
# ---------------------------------------------------------------------------


class BucketHooks:
    """One step's overlapped sync over ``leaves`` (name -> the tensors the
    loss is differentiated against, each requiring grad).

    A hook on each leaf keeps its gradient; the hook that completes a
    bucket starts the bucket's sync (`_BucketSync.start`), inside
    backward, in the order the buckets complete — the same on every rank,
    since every rank runs the same graph.  Call `finish` once backward has
    returned: a bucket some of whose leaves got no gradient (they do not
    reach the loss) starts there, with zeros for them; a bucket none of
    whose leaves got one gets zeros and no collective, on every rank
    alike.  The JAX package sums a zero cotangent in both cases, with the
    same result."""

    def __init__(self, leaves: "OrderedDict", plan: OverlapPlan,
                 sync: _BucketSync):
        self.leaves, self.sync = leaves, sync
        self.pending: list[_Pending] = []
        self._grads: list[Any] = [OrderedDict.fromkeys(b)
                                  for b in plan.buckets]
        self._left = [len(b) for b in plan.buckets]
        for i, names in enumerate(plan.buckets):
            for n in names:
                leaves[n].register_hook(self._hook(i, n))

    def _hook(self, i: int, name: str) -> Callable:
        def on_grad(grad):
            self._grads[i][name] = grad
            self._left[i] -= 1
            if not self._left[i]:
                self.pending.append(self.sync.start(self._grads[i]))
                self._grads[i] = None
        return on_grad

    def finish(self) -> "OrderedDict":
        """The summed gradients of every leaf, in ``leaves``' order."""
        for grads in self._grads:
            if grads is None or all(g is None for g in grads.values()):
                continue
            self.pending.append(self.sync.start(OrderedDict(
                (n, torch.zeros_like(self.leaves[n]) if g is None else g)
                for n, g in grads.items())))
        summed = self.sync.finish(self.pending)
        out = OrderedDict(
            (n, summed[n] if n in summed else torch.zeros_like(x))
            for n, x in self.leaves.items())
        # The leaves hold the hooks, which hold this object: drop the way
        # back, so the step's leaves (and the old params they share storage
        # with) are freed when the step lets go of them, not by the cycle
        # collector.
        self.leaves, self.pending, self._grads = None, [], None
        return out


class _BucketHook(torch.autograd.Function):
    """Identity on the forward; the bucket's sync on its cotangents."""

    @staticmethod
    def forward(ctx, sync, names, *leaves):
        ctx.sync, ctx.names = sync, names
        return tuple(x.view_as(x) for x in leaves)

    @staticmethod
    def backward(ctx, *cots):
        summed = ctx.sync(OrderedDict(zip(ctx.names, cots)))
        return (None, None, *summed.values())


def attach(params: "OrderedDict", plan: OverlapPlan,
           sync_fn: _BucketSync) -> "OrderedDict":
    """Wrap each bucket's params in an identity `torch.autograd.Function`
    whose backward runs ``sync_fn`` on the bucket's cotangents; returns an
    OrderedDict of the wrapped params in ``params``' order.
    Differentiating a loss of it yields cross-rank SUMMED gradients for
    the originals (the JAX package's ``custom_vjp`` hook).  Its backward
    runs after the rest of the backward (see the module docstring); the
    step overlaps through `BucketHooks`."""
    hooked = dict(params)
    for names in plan.buckets:
        out = _BucketHook.apply(sync_fn, names, *(params[n] for n in names))
        hooked.update(zip(names, out))
    return OrderedDict((n, hooked[n]) for n in params)


def wrap_loss(loss_fn: Callable, plan: OverlapPlan,
              sync_fn: _BucketSync) -> Callable:
    """``loss_fn(params, *rest)`` -> the same loss, whose gradients with
    respect to ``params`` come back cross-rank SUMMED (the reference's
    `ps.py:176` semantics)."""

    def wrapped(params, *rest):
        return loss_fn(attach(params, plan, sync_fn), *rest)

    return wrapped


# ---------------------------------------------------------------------------
# Async gradient production: bucket-streamed grad + encode
# ---------------------------------------------------------------------------
# The async PS's worker has no collective: a bucket's operation is its
# codec encode, an output of the step.  The step hands back one encoded
# sub-tree per bucket, each with the event that completes it on the card,
# so the worker can copy a finished bucket to the host and put it on the
# wire while earlier layers' backward still runs
# (`multihost_async.AsyncPSWorker.push_buckets`).


class BucketCodes(OrderedDict):
    """One bucket's codes (name -> code) and ``event``, recorded on the
    card after the bucket's encode was queued; None off the card."""

    event = None


def split_tree(tree: "OrderedDict", plan: OverlapPlan) -> tuple:
    """Slice a name-keyed tree into the plan's bucket sub-trees (every
    name exactly once, in plan order)."""
    return tuple(OrderedDict((n, tree[n]) for n in names)
                 for names in plan.buckets)


def _ready(sub) -> bool:
    event = getattr(sub, "event", None)
    return event is None or event.query()


def iter_ready_groups(subs, to_host: Callable):
    """Walk bucket sub-trees in stream order and group them: before
    ``to_host`` would block on a bucket whose event has not completed,
    yield the run already on the host as one group (its frames go out in
    one gather-send while the card finishes); a stream that is complete
    throughout is one group.  The JAX package asks each array
    ``is_ready()``; here the bucket's event answers (`BucketCodes`), and
    a bucket without one (on the CPU) is ready."""
    group: list = []
    for sub in subs:
        if not _ready(sub) and group:
            yield group
            group = []
        group.append(to_host(sub))
    if group:
        yield group


def merge_buckets(buckets, order) -> "OrderedDict":
    """Inverse of `split_tree`: one tree keyed in canonical ``order``."""
    flat: dict = {}
    for sub in buckets:
        flat.update(sub)
    return OrderedDict((n, flat[n]) for n in order)


def make_async_bucket_step(loss_fn: Callable, code: Codec, plan: OverlapPlan,
                           grad_transform=None, *, fused: bool = True,
                           orders=None):
    """The bucket-streamed worker program: ``(params, batch) -> (loss,
    bucket_codes)``, one `BucketCodes` per plan bucket, each leaf encoded
    in the element order ``orders`` names (`utils.interop.jax_order`), as
    `async_ps.make_worker_step` encodes the whole tree.

    ``fused=True`` encodes each bucket inside backward: a hook on every
    parameter leaf keeps its gradient, and the hook that completes a
    bucket encodes it and records its event (nothing waits in a hook).
    Leaves that get no gradient are zeros, encoded after backward.
    ``fused=False`` runs backward first, then encodes bucket by bucket.
    Both give codes bitwise equal to the whole-tree step's.

    ``grad_transform`` (the Byzantine map) runs on the raw gradients
    before encoding.  Every mode of `FaultPlan.byzantine_transform` maps
    each leaf on its own, so applying it to each bucket's sub-tree (as
    the fused hooks do) equals applying it to the whole tree."""
    orders = orders or {}

    def encode(grads: "OrderedDict", device) -> BucketCodes:
        with torch.no_grad():
            if grad_transform is not None:
                grads = grad_transform(grads)
            out = BucketCodes(
                (n, code.encode(_wire(g, orders.get(n))))
                for n, g in grads.items())
        out.event = record_event(device)
        return out

    def fused_step(params, batch):
        leaves = OrderedDict((n, p.detach().requires_grad_())
                             for n, p in params.items())
        device = next(iter(leaves.values())).device
        got: list = [OrderedDict.fromkeys(b) for b in plan.buckets]
        left = [len(b) for b in plan.buckets]
        out: list = [None] * plan.n_buckets

        def hook(i: int, name: str) -> Callable:
            def on_grad(grad):
                got[i][name] = grad
                left[i] -= 1
                if not left[i]:
                    out[i] = encode(got[i], device)
                    got[i] = None
            return on_grad

        handles = [leaves[n].register_hook(hook(i, n))
                   for i, names in enumerate(plan.buckets) for n in names]
        try:
            loss = loss_fn(leaves, batch)
            torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
        finally:
            for h in handles:
                h.remove()
        for i, grads in enumerate(got):
            if out[i] is None:
                out[i] = encode(OrderedDict(
                    (n, torch.zeros_like(leaves[n]) if g is None else g)
                    for n, g in grads.items()), device)
        return loss.detach(), tuple(out)

    def host_step(params, batch):
        leaves = OrderedDict((n, p.detach().requires_grad_())
                             for n, p in params.items())
        device = next(iter(leaves.values())).device
        loss = loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
        grads = OrderedDict(zip(leaves, grads))
        return loss.detach(), tuple(encode(sub, device)
                                    for sub in split_tree(grads, plan))

    return fused_step if fused else host_step
