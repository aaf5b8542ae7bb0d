"""PS optimizer layer — `MPI_PS` / `SGD` / `Adam` / `AdamW` on PyTorch.

Counterpart of `pytorch_ps_mpi_tpu/ps.py` (its synchronous step).  The
reference contract carries over unchanged:

* constructed from **named parameters** plus optimizer hyperparameters;
  names must be unique;
* each step: every rank computes gradients on its own shard of the global
  batch, encodes them with the pluggable codec, the ranks exchange the
  codes, decode all ``world_size`` of them and **sum** them (sum, not
  mean), and apply an identical update, leaving parameters replicated —
  every rank is its own parameter server;
* ``step()`` returns ``(loss, metrics)`` with the reference's metric keys.

Where the JAX step is one jitted SPMD program over a mesh, this one runs
eagerly on one device per rank: forward and backward by autograd, the
exchange through bucketed ``torch.distributed`` collectives
(`parallel.collectives`), the decode-sums on the codec kernels
(`ops.codec_kernels`), and the update rules (`optim.rules`) per
parameter.  BatchNorm statistics (``aux``) and the loss are averaged
across ranks, as the JAX step's ``pmean`` does.

Ported: every option of the JAX constructor — the mesh options
(``mesh``, ``axis``, ``batch_spec``: below), the ``post``, ``bucketed`` and
``overlap`` sync modes (the overlap engine, `parallel.overlap`, issues
each bucket's exchange inside backward; ``fused_encode`` quantizes a
blockq bucket as one tensor), every codec, ``decompose_allreduce``,
``clip_norm``, ``skip_nonfinite``, ``profile``, ``error_feedback``,
``zero``, ``ema_decay``, ``consensus_every``/``consensus_policy``, and
``compile_step``'s ``accum_steps`` and ``remat``; lr schedules, and the
checkpoint state (`state_dict`, `load_state_dict` with elastic N→M
resume, `rescale_lr`) as in-memory dicts of numpy arrays.

A codec whose wire depends on element order encodes each gradient in the
JAX package's layout (`utils.interop.jax_order`: conv kernels HWIO, Dense
kernels ``(in, out)``), so its codes equal the JAX package's; the decoded
sum comes back as the inverse-permuted view.

Over a mesh (``mesh=``, a `parallel.mesh.Mesh`): ``axis`` names the data
axes (a name or a tuple), and gradients are **summed** over them and
**averaged** over every other ("extra") axis of the mesh — an sp, tp or
pp rank holds the gradient of its own copy of the loss, and the rank's
true gradient is their mean.  ``world_size`` is the product of the data
axes.  The loss and ``aux`` are averaged over the whole mesh, and the
``skip_nonfinite`` vote and the consensus guard run over it; ZeRO and
error feedback shard over the data axes only.  In ``post`` and
``bucketed`` mode the mean over the extra axes comes before the
exchange; in ``overlap`` mode the sum runs inside backward and the mean
after it, as in the JAX step (the two round differently).
``batch_spec`` shards the global batch as the JAX ``PartitionSpec``
does: entry ``i`` names the axis (or tuple of axes, ranked row-major)
that dim ``i`` splits over, None leaves it whole; the default splits dim
0 over the data axes.  The mesh is current (``with mesh:``) while the
loss and its backward run, so the model's collectives resolve their
axis names against it.
"""

from __future__ import annotations

import sys
import time
from collections import OrderedDict
from contextlib import nullcontext
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from .errors import ElasticResumeError, NotCompiledError, SDCDetectedError
from .ops.codecs import Codec, IdentityCodec, get_codec
from .optim.rules import RULES
from .optim.schedules import (hyper_for_checkpoint, hyper_from_checkpoint,
                              resolve_hyper)
from .parallel import collectives, overlap
from .parallel.mesh import (PS_AXIS, as_axes, describe_mesh, make_ps_group,
                            make_ps_mesh, rank, resolve_device, world_size)
from .utils.bytes import bytes_of, host_numpy
from .utils.flatten import (tree_flatten, tree_leaves, tree_map,
                            tree_unflatten)
from .utils.interop import from_jax_order, jax_order, to_jax_order
from .utils.timing import (STEP_METRIC_KEYS, annotate, print_summary,
                           record_overlap_schedule)

# Hyperparameters accepted per optimizer — the analogue of the reference's
# kwargs filtering at dispatch.
_HYPER_KEYS = {
    "sgd": {"lr", "momentum", "dampening", "weight_decay", "nesterov"},
    "adam": {"lr", "betas", "eps", "weight_decay", "amsgrad"},
    "adamw": {"lr", "betas", "eps", "weight_decay", "amsgrad"},
}
_HYPER_DEFAULTS = {
    "sgd": dict(lr=0.01, momentum=0.0, dampening=0.0, weight_decay=0.0,
                nesterov=False),
    "adam": dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 amsgrad=False),
    "adamw": dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2,
                  amsgrad=False),
}


def init_ps_core(named_params, optim: str, hyper: dict, place):
    """Validate the optimizer name and hyperparameters, enforce name
    uniqueness, place params via ``place`` and build per-parameter
    optimizer state.  Returns ``(params, state, merged_hyper,
    update_fn)``."""
    if optim not in RULES:
        raise ValueError(
            f"optimizer {optim!r} not supported; have {sorted(RULES)}")
    unknown = set(hyper) - _HYPER_KEYS[optim]
    if unknown:
        raise TypeError(f"unexpected {optim} hyperparameters: {sorted(unknown)}")
    merged = dict(_HYPER_DEFAULTS[optim])
    merged.update(hyper)

    pairs = list(named_params)
    names_list = [n for n, _ in pairs]
    if len(set(names_list)) != len(names_list):
        raise ValueError("parameter names must be unique")
    params = OrderedDict((n, place(p)) for n, p in pairs)

    init_fn, update_fn = RULES[optim]
    init_kwargs = ({"amsgrad": merged["amsgrad"]}
                   if optim in ("adam", "adamw") else {})
    state = OrderedDict((n, init_fn(p, **init_kwargs))
                        for n, p in params.items())
    return params, state, merged, update_fn


def tree_all_finite(*trees) -> bool:
    """Host-side all-finite check over trees of tensors (float leaves
    only), the async PS's quarantine gate for one received gradient
    (the sync step's ``skip_nonfinite`` runs its check on the device
    instead).  Integer leaves (quantized codes, indices, packed signs)
    are finite by construction and skipped; bf16 is widened first, as
    the JAX package's host check does.  One host read for the whole
    tree, on the current stream."""
    flags = [torch.isfinite(leaf.to(torch.float32)
                            if leaf.dtype == torch.bfloat16 else leaf).all()
             for t in trees for leaf in tree_leaves(t)
             if isinstance(leaf, torch.Tensor)
             and (leaf.is_floating_point() or leaf.is_complex())]
    if not flags:
        return True
    return bool(torch.stack(flags).all())


def _bits(p: torch.Tensor) -> torch.Tensor:
    """``p``'s raw bit pattern, zero-extended to int64, flat (the JAX
    guard's ``bitcast_convert_type`` to an unsigned int of its width, then
    to uint32)."""
    width = p.element_size()
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[width]
    mask = (1 << (8 * width)) - 1
    return (p.detach().reshape(-1).view(view).to(torch.int64) & mask)


def _xor_fold(u: torch.Tensor) -> torch.Tensor:
    """The xor of every element of the flat int64 ``u`` (bits < 2^32), as a
    0-d tensor.  Torch has no xor reduction: pad to a power of two with
    zeros (the xor identity) and xor the halves together until one is
    left."""
    n = u.numel()
    if n == 0:
        return u.new_zeros(())
    size = 1 << (n - 1).bit_length()
    if size != n:
        u = torch.cat([u, u.new_zeros((size - n,))])
    while u.numel() > 1:
        half = u.numel() // 2
        u = torch.bitwise_xor(u[:half], u[half:])
    return u[0]


def param_fingerprints(params) -> torch.Tensor:
    """The replica-consensus fingerprint of a parameter tree: for each leaf
    a wrapping uint32 sum and an xor-fold of its bit pattern (any single
    flipped bit perturbs both), as int64 values below 2^32, sums first —
    the JAX guard's vector.  The sum runs in int64 and is taken mod 2^32
    (exact below 2^31 elements a leaf)."""
    bits = [_bits(p) for p in params.values()]
    sums = [u.sum() & 0xFFFFFFFF for u in bits]
    xors = [_xor_fold(u) for u in bits]
    return torch.stack(sums + xors)


class MPI_PS:
    """Replicated-state parameter-server optimizer over a process group.

    Usage::

        make_ps_group("cuda", rank=r, world_size=w, init_file=f)
        opt = SGD(model_named_params, lr=0.1, momentum=0.9, code="blockq")
        opt.compile_step(loss_fn)                  # loss_fn(params, batch)
        for batch in data:                         # the GLOBAL batch
            loss, metrics = opt.step(batch)

    ``device`` defaults to ``"cuda"`` and raises when no card is visible;
    tests pass ``device="cpu"``.  ``group`` defaults to the default process
    group, made for a world of one if none exists.
    """

    def __init__(self, named_params, *, optim: str = "sgd",
                 code: Codec | str | None = None, device=None, group=None,
                 mesh=None, axis: "str | tuple" = PS_AXIS,
                 batch_spec=None,
                 profile: bool = False, zero: bool = False,
                 skip_nonfinite: bool = False,
                 clip_norm: float | None = None,
                 error_feedback: bool = False,
                 ema_decay: float | None = None,
                 bucket_mb: float | None =
                 collectives.DEFAULT_BUCKET_BYTES / (1 << 20),
                 decompose_allreduce: bool = False,
                 sync_mode: str | None = None,
                 overlap_reducer: str = "rs_ag",
                 fused_encode: bool = False,
                 consensus_every: int = 0,
                 consensus_policy: str = "abort",
                 names=(), use_mpi: bool = True, cuda: bool = False,
                 **kwargs):
        # Accepted for API parity with the reference's constructor; the
        # device is ``device``'s, whatever ``cuda`` says.
        del names, use_mpi, cuda
        if mesh is not None and group is not None:
            raise ValueError("pass mesh= or group=, not both")
        if mesh is not None and device is None:
            device = mesh.device
        self.device = resolve_device("cuda" if device is None else device)
        self.axes = as_axes(axis)
        if mesh is None and (batch_spec is not None
                             or self.axes != (PS_AXIS,)):
            if group is not None:
                raise ValueError("axis= and batch_spec= name axes of a "
                                 "mesh: pass mesh=, not group=")
            # Axes name a mesh: the JAX default, one over the world.
            mesh = make_ps_mesh(device=self.device)
        self.mesh = mesh
        if mesh is not None:
            for a in self.axes:
                if a not in mesh.axis_names:
                    raise ValueError(
                        f"axis {a!r} not in mesh axes {mesh.axis_names}")
            # Every axis that is not a data axis is averaged over.
            self.extra_axes = tuple(a for a in mesh.axis_names
                                    if a not in self.axes)
            self.batch_spec = (tuple(batch_spec) if batch_spec is not None
                               else (self.axes,))
            for entry in self.batch_spec:
                for a in (() if entry is None else as_axes(entry)):
                    if a not in mesh.axis_names:
                        raise ValueError(
                            f"batch_spec {self.batch_spec} names axis "
                            f"{a!r}, not in mesh axes {mesh.axis_names}")
        else:
            self.extra_axes = ()
            self.batch_spec = None
        self.optim = optim
        self.code = get_codec(code)
        self.profile = profile
        if bucket_mb is not None and bucket_mb < 0:
            raise ValueError(f"bucket_mb must be >= 0, got {bucket_mb}")
        self.bucket_bytes = (int(bucket_mb * (1 << 20))
                             if bucket_mb else None)
        # Identity codec, post/bucketed modes: sum each bucket as a
        # reduce-scatter and an all-gather instead of one all-reduce.
        self.decompose_allreduce = bool(decompose_allreduce)
        # WHEN the cross-rank gradient sum happens:
        #   "post"     — after backward, one collective per parameter;
        #   "bucketed" — after backward, dtype-bucketed flat transfers
        #                (the default whenever bucket_mb is set);
        #   "overlap"  — each bucket's exchange issued INSIDE backward as
        #                soon as its gradients exist (`parallel.overlap`).
        if sync_mode is None:
            sync_mode = "bucketed" if self.bucket_bytes else "post"
        if sync_mode not in ("post", "bucketed", "overlap"):
            raise ValueError(f"sync_mode must be one of ('post', 'bucketed',"
                             f" 'overlap'), got {sync_mode!r}")
        if sync_mode == "post":
            self.bucket_bytes = None  # per-parameter collectives, explicitly
        if overlap_reducer not in ("rs_ag", "psum"):
            raise ValueError(f"overlap_reducer must be 'rs_ag' or 'psum', "
                             f"got {overlap_reducer!r}")
        self.sync_mode = sync_mode
        self.overlap_reducer = overlap_reducer
        # One quantize launch per bucket instead of one per leaf; it lives
        # in the overlap engine's hooks, and would be inert elsewhere.
        self.fused_encode = bool(fused_encode)
        if self.fused_encode and sync_mode != "overlap":
            raise ValueError(
                "fused_encode requires sync_mode='overlap' — the fused "
                "per-bucket encode lives inside the overlap engine's "
                "backward hooks and would be silently inert under "
                f"sync_mode={sync_mode!r}")
        if sync_mode == "overlap":
            if error_feedback:
                raise ValueError(
                    "sync_mode='overlap' does not compose with "
                    "error_feedback: the EF residual must be read and "
                    "written around the codec inside each bucket's "
                    "backward hook; use sync_mode='bucketed'")
            if skip_nonfinite and not isinstance(self.code, IdentityCodec):
                raise ValueError(
                    "sync_mode='overlap' + skip_nonfinite needs the "
                    "identity codec: the finiteness consensus then runs on "
                    "the summed gradient (NaN/inf propagates through the "
                    "sum), whereas a lossy codec could launder a NaN "
                    "before any post-sync check; use sync_mode='bucketed', "
                    "which checks the raw per-rank gradients pre-encode")
        # ZeRO: each rank owns 1/world of every elementwise state buffer;
        # gradients reduce-scatter (identity) or are sliced from the
        # decoded sum (codecs) to the owner's chunk, each rank updates its
        # chunk, and the chunks all-gather back to replicated params.
        self.zero = bool(zero)
        # Skip-on-NaN: if any rank's gradient holds a non-finite value, every
        # rank keeps its params, state, aux and extras and reports
        # ``nonfinite_skip=1``.  Global-norm clipping of the summed gradient
        # (what the update rules consume), identical on every rank.
        if clip_norm is not None and not clip_norm > 0:
            # `not >` also rejects NaN.
            raise ValueError(f"clip_norm must be positive, got {clip_norm}")
        self.clip_norm = clip_norm
        self.skip_nonfinite = skip_nonfinite
        # Error feedback: each rank keeps what its lossy codec dropped and
        # adds it back before the next encode (a rank-local residual).
        self.error_feedback = bool(error_feedback)
        if error_feedback and isinstance(self.code, IdentityCodec):
            raise ValueError(
                "error_feedback needs a lossy codec: the identity "
                "codec decodes exactly, so the residual is always 0")
        # Polyak/EMA weights: ema = decay*ema + (1-decay)*params each step.
        if ema_decay is not None and not 0.0 < ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in (0, 1), got {ema_decay}")
        self.ema_decay = ema_decay

        def place(x):
            return torch.as_tensor(x).detach().to(self.device, copy=True)

        self.params, self.state, self.hyper, self._update_fn = init_ps_core(
            named_params, optim, kwargs, place)
        if mesh is not None:
            # The data axes' group carries the exchange, ZeRO and the EF
            # residual; the extra axes' group the mean; the whole mesh's
            # group the loss, aux, the finiteness vote and the guard.
            self.group = mesh.group(self.axes)
            self._extra_group = (mesh.group(self.extra_axes)
                                 if self.extra_axes else None)
            self.mesh_group = mesh.group(mesh.axis_names)
            self.mesh_rank = mesh.axis_index(mesh.axis_names)
        else:
            self.group = group if group is not None else make_ps_group(
                self.device)
            self._extra_group = None
            self.mesh_group = self.group
            self.mesh_rank = rank(self.group)
        self.world_size = world_size(self.group)
        self.rank = rank(self.group)
        # The codec's element order per leaf (only where it differs from
        # the port's layout and the wire depends on it), and each leaf's
        # shape and dtype as the codec sees it.
        self._orders = {}
        if self.code.ordered:
            for n, p in self.params.items():
                order = jax_order(n, p.shape)
                if order is not None:
                    self._orders[n] = order
        self._metas = OrderedDict(
            (n, (to_jax_order(p, self._orders.get(n)).shape, p.dtype))
            for n, p in self.params.items())
        if self.zero:
            # Per-param flat size and per-rank chunk length (zero-padded up
            # to world_size * chunk); this rank keeps its chunk of each
            # elementwise state buffer.
            self._zero_meta = {
                n: (p.numel(), -(-p.numel() // self.world_size))
                for n, p in self.params.items()}
            self.state = self._chunk_state(self.state)
        # The overlap engine's bucket schedule, over the params' static
        # shapes; bucket_mb=0/None auto-tunes (`overlap.auto_bucket_bytes`).
        self.overlap_plan = None
        if sync_mode == "overlap":
            self.overlap_plan = overlap.plan_overlap(
                self.params, self.bucket_bytes, world=self.world_size,
                record=False)
            record_overlap_schedule({
                **self.overlap_plan.describe(),
                "reducer": overlap_reducer, "codec": self.code.name,
                "world": self.world_size, "zero": self.zero})
        # Carried state beyond params/state/aux: "ef", this rank's EF
        # residual ([1, ...] f32 leaves), and "ema", the averaged weights.
        self.extras: "OrderedDict[str, OrderedDict]" = OrderedDict()
        if self.error_feedback:
            self.extras["ef"] = OrderedDict(
                (n, torch.zeros((1,) + tuple(p.shape), dtype=torch.float32,
                                device=self.device))
                for n, p in self.params.items())
        if ema_decay is not None:
            self.extras["ema"] = OrderedDict(
                (n, p.clone()) for n, p in self.params.items())
        # Replica-consensus SDC guard: every ``consensus_every`` steps the
        # params are fingerprinted on each rank and compared across ranks
        # (replicas must be bitwise identical).  Policy "abort" raises
        # `SDCDetectedError`; "rebroadcast" restores rank 0's copy.
        if consensus_every < 0:
            raise ValueError(
                f"consensus_every must be >= 0, got {consensus_every}")
        if consensus_policy not in ("abort", "rebroadcast"):
            raise ValueError(f"consensus_policy must be 'abort' or "
                             f"'rebroadcast', got {consensus_policy!r}")
        self.consensus_every = int(consensus_every)
        self.consensus_policy = consensus_policy
        self._bucket_sync = None
        self._count_fused_sync = False
        # The sync trainer's failure-path counters, with the JAX package's
        # keys: the SDC guard's, and ``fused_sync_encodes`` (steps whose
        # sync ran the fused per-bucket encode).
        self.fault_stats: dict = {
            "sdc_checks": 0, "sdc_mismatches": 0, "sdc_rebroadcasts": 0,
            "sdc_first_leaf": None, "sdc_events": [],
            "fused_sync_encodes": 0, "rollbacks": []}
        self.timings: list[dict[str, float]] = []
        self.steps_completed = 0
        self.aux = OrderedDict()  # model aux state (BatchNorm statistics)
        self._has_aux = False
        self._accum = 1
        self._remat = False
        self._loss_fn = None
        self._warm = False
        self._byte_metrics = None
        # A skip_nonfinite step's consensus on its way to the host: the
        # rules' step counters (host tensors) are settled from it before
        # they are next read (`_settle_step_counters`).
        self._unsettled = None

    # -- ZeRO state layout ---------------------------------------------------

    def _my_chunk(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """This rank's chunk of ``x`` (of parameter ``name``'s size) in the
        port's flat order, zero-padded to the chunk length: row ``rank``
        of the zero-padded ``(world, chunk)`` layout."""
        sz, chunk = self._zero_meta[name]
        lo = min(self.rank * chunk, sz)
        piece = x.reshape(-1)[lo:min(lo + chunk, sz)]
        if piece.numel() < chunk:
            piece = torch.cat([piece, piece.new_zeros((chunk - piece.numel(),))])
        return piece

    def _chunk_state(self, state):
        """Full elementwise state buffers -> this rank's chunks; scalar
        leaves (the step counters) stay as they are."""
        out = OrderedDict()
        for n, st in state.items():
            shape = tuple(self.params[n].shape)
            out[n] = {k: (self._my_chunk(v, n) if tuple(v.shape) == shape
                          and v.dim() > 0 else v)
                      for k, v in st.items()}
        return out

    def _gather_chunks(self, chunks):
        """Every rank's chunk of each leaf of ``chunks`` (name -> tree of
        ``(chunk,)`` tensors and scalars): ``(world, chunk)`` tensors, one
        bucketed all-gather; scalars pass."""
        flat, treedef = tree_flatten(chunks)
        idx = [i for i, v in enumerate(flat) if v.dim() == 1]
        gathered = collectives.allgather_tree_bucketed(
            [flat[i] for i in idx], self.group, bucket_bytes=self.bucket_bytes)
        for i, g in zip(idx, gathered):
            flat[i] = g
        return tree_unflatten(treedef, flat)

    def _dechunk(self, name: str, rows: torch.Tensor) -> torch.Tensor:
        """``(world, chunk)`` rows of parameter ``name`` -> its full shape."""
        sz, _ = self._zero_meta[name]
        return rows.reshape(-1)[:sz].reshape(self.params[name].shape)

    # -- step construction ---------------------------------------------------

    def compile_step(self, loss_fn: Callable, *, has_aux: bool = False,
                     aux=None, accum_steps: int = 1,
                     remat: bool = False) -> None:
        """Bind the loss function.

        ``has_aux=True`` means ``loss_fn(params, aux, batch) -> (loss,
        new_aux)`` — for models carrying non-trained state (BatchNorm
        statistics), which the step averages across ranks and threads
        through.  Otherwise ``loss_fn(params, batch) -> loss``.  ``params``
        is an ordered dict of tensors that require grad.

        ``accum_steps=K`` splits each rank's batch shard into K
        microbatches run one after another (activation memory of one
        microbatch); the gradients average over them and BatchNorm
        statistics thread through in order.  ``remat=True`` runs the loss
        under ``torch.utils.checkpoint`` (non-reentrant): backward
        recomputes the forward instead of keeping its activations.
        PyTorch runs eagerly, so nothing is traced here; under
        ``sync_mode="overlap"`` the bucket sync is built here."""
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        if accum_steps > 1 and self.sync_mode == "overlap":
            raise ValueError(
                "sync_mode='overlap' does not compose with accum_steps > 1 "
                "(each microbatch's backward would re-run the cross-rank "
                "exchange); use sync_mode='bucketed' with accumulation")
        if self.sync_mode == "overlap":
            self._bucket_sync = overlap.make_bucket_sync_fn(
                group=self.group, world=self.world_size,
                codec=(None if isinstance(self.code, IdentityCodec)
                       else self.code),
                reducer=self.overlap_reducer, fused_encode=self.fused_encode,
                orders=self._orders)
            # Counted once per step from here on (`fault_stats`).
            self._count_fused_sync = self.fused_encode
        self._loss_fn = loss_fn
        self._has_aux = has_aux
        self._accum = int(accum_steps)
        self._remat = bool(remat)
        self._warm = False
        self._byte_metrics = None
        if aux is not None:
            self.aux = tree_map(
                lambda x: torch.as_tensor(x).detach().to(self.device,
                                                         copy=True), aux)

    def _call_loss(self, leaves, aux, batch):
        """``(loss, new_aux)`` of the bound loss function (under
        checkpointing with ``remat``)."""
        args = (leaves, aux, batch) if self._has_aux else (leaves, batch)
        if self._remat:
            out = checkpoint(self._loss_fn, *args, use_reentrant=False)
        else:
            out = self._loss_fn(*args)
        return out if self._has_aux else (out, aux)

    def _accumulated(self, leaves, batch):
        """Loss, gradients and aux over ``accum_steps`` microbatches of the
        rank's shard: each microbatch's gradients are summed as they come
        (from zeros, as the JAX scan's carry), then divided by the count
        (a tensor: the card would multiply by the reciprocal of a Python
        number); the loss is the microbatches' mean."""
        accum = self._accum
        first = tree_leaves(batch)[0]
        if first.shape[0] % accum:
            raise ValueError(
                f"per-rank batch of {first.shape[0]} does not split "
                f"into accum_steps={accum} microbatches")
        per = first.shape[0] // accum
        acc = [torch.zeros_like(x) for x in leaves.values()]
        aux, losses = self.aux, []
        for i in range(accum):
            mb = tree_map(lambda x: x[i * per:(i + 1) * per], batch)
            loss, aux = self._call_loss(leaves, aux, mb)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
            acc = [a + g for a, g in zip(acc, grads)]
            losses.append(loss.detach())
        grads = OrderedDict((n, a / a.new_full((), accum))
                            for n, a in zip(leaves, acc))
        return torch.stack(losses).mean(), grads, aux

    def _grads_and_aux(self, batch):
        """Loss and aux averaged across ranks, and the gradients: each
        rank's own (the cross-rank sum happens later, explicitly), or under
        ``sync_mode="overlap"`` already summed — each bucket's exchange
        issued inside backward, waited for and decoded after it.  Over a
        mesh, the gradients and the loss are averaged over the extra axes
        here (after the in-backward sum under overlap, before the exchange
        otherwise), with the mesh current around the loss and its
        backward.  A parameter the loss never reaches (a layer of another
        pipeline stage) gets a zero gradient, as in JAX."""
        with self.mesh if self.mesh is not None else nullcontext():
            leaves = OrderedDict((n, p.detach().requires_grad_())
                                 for n, p in self.params.items())
            if self._accum > 1:
                loss, grads, new_aux = self._accumulated(leaves, batch)
            else:
                hooks = (overlap.BucketHooks(leaves, self.overlap_plan,
                                             self._bucket_sync)
                         if self._bucket_sync is not None else None)
                loss, new_aux = self._call_loss(leaves, self.aux, batch)
                grads = torch.autograd.grad(loss, list(leaves.values()),
                                            allow_unused=True,
                                            materialize_grads=hooks is None)
                with torch.no_grad():
                    grads = (hooks.finish() if hooks is not None
                             else OrderedDict(zip(leaves, grads)))
        with torch.no_grad():
            loss = loss.detach()
            if self._extra_group is not None:
                # Collapse the extra axes first: every sp/tp/pp rank then
                # holds its data rank's gradient.
                synced = collectives.pmean_tree(
                    {"grads": grads, "loss": loss}, self._extra_group,
                    bucket_bytes=self.bucket_bytes)
                grads, loss = synced["grads"], synced["loss"]
            synced = collectives.pmean_tree(
                {"aux": new_aux, "loss": loss}, self.mesh_group,
                bucket_bytes=self.bucket_bytes)
        return synced["loss"], grads, synced["aux"]

    # -- the step's phases: encode, sync, update, ema --------------------------

    def _encode_all(self, grads):
        """Each gradient's code, encoded in the codec's element order."""
        return OrderedDict(
            (n, self.code.encode(to_jax_order(g, self._orders.get(n))))
            for n, g in grads.items())

    def _from_wire(self, tree):
        """Decoded sums in the codec's element order -> the port's layout
        (inverse-permuted views, no copy)."""
        return OrderedDict((n, from_jax_order(g, self._orders.get(n)))
                           for n, g in tree.items())

    def _sync_codes(self, codes):
        """Cross-rank gradient sum of a step's codes: the identity codec is
        a bucketed all-reduce (or reduce-scatter + all-gather); other
        codecs all-gather the codes (bucketed) and decode-sum all the
        parameters at once (one grouped kernel launch for the blockq and
        bf16 codecs)."""
        if isinstance(self.code, IdentityCodec):
            return collectives.psum_tree_bucketed(
                codes, self.group, bucket_bytes=self.bucket_bytes,
                decompose=self.decompose_allreduce)
        gathered = collectives.allgather_tree_bucketed(
            codes, self.group, bucket_bytes=self.bucket_bytes)
        return self._from_wire(self.code.decode_sum_leaves(gathered,
                                                           self._metas))

    def _encode_ef(self, grads):
        """Error-feedback encode: add this rank's residual to the raw
        gradient, encode, and keep what the codec dropped (``d -
        decode(encode(d))``) as the next residual.  The own codes decode
        as one group (one grouped launch for blockq), as a world of one."""
        ef = self.extras["ef"]
        d = OrderedDict((n, g + ef[n][0].to(g.dtype))
                        for n, g in grads.items())
        codes = self._encode_all(d)
        own = self._from_wire(self.code.decode_sum_leaves(
            OrderedDict((n, tree_map(lambda x: x[None], code))
                        for n, code in codes.items()), self._metas))
        self.extras["ef"] = OrderedDict(
            (n, (d[n] - own[n]).to(torch.float32)[None]) for n in d)
        return codes

    def _phase_encode(self, grads):
        """The encode phase: the codes (the EF variant also renews the
        residual), or the gradients themselves where nothing encodes
        (overlap: summed already; identity: the sync reduces them)."""
        if self.sync_mode == "overlap":
            return grads
        if self.error_feedback:
            return self._encode_ef(grads)
        if isinstance(self.code, IdentityCodec):
            return grads
        return self._encode_all(grads)

    def _phase_sync(self, codes):
        """The sync phase: the summed gradient (clipped), or under ZeRO
        this rank's chunks of it — the identity codec's reduce-scatter, or
        a slice of the decoded (or, under overlap, already summed) sum."""
        over = self.sync_mode == "overlap"
        if self.zero:
            if over:
                return self._zero_sync(None, codes)
            if isinstance(self.code, IdentityCodec):
                return self._zero_sync(codes, None)
            return self._zero_sync(None, self._sync_codes(codes))
        d_ps = codes if over else self._sync_codes(codes)
        if self.clip_norm is not None:
            d_ps = self._clip_tree(d_ps)
        return d_ps

    def _zero_sync(self, grads, d_full):
        """Gradient sync into per-rank chunks: reduce-scatter of the padded
        flats when ``d_full`` is None (the identity codec), this rank's
        slice of ``d_full`` otherwise; clipped with one scalar
        all-reduce."""
        if d_full is None:
            flats = OrderedDict()
            for n, g in grads.items():
                sz, chunk = self._zero_meta[n]
                flat = g.new_zeros((self.world_size * chunk,))
                flat[:sz] = g.reshape(-1)
                flats[n] = flat
            d_chunks = collectives.reduce_scatter_flats_bucketed(
                flats, self.group, world=self.world_size,
                bucket_bytes=self.bucket_bytes)
        else:
            d_chunks = OrderedDict((n, self._my_chunk(g, n))
                                   for n, g in d_full.items())
        if self.clip_norm is not None:
            d_chunks = self._clip_tree(d_chunks, across_ranks=True)
        return d_chunks

    def _all_finite(self, grads) -> torch.Tensor:
        """0-d bool on the device: no rank's gradient holds a NaN or inf
        (a cross-rank sum of the non-finite counts)."""
        bad = torch.stack([torch.isfinite(g).logical_not().sum()
                           for g in grads.values()]).sum().to(torch.float32)
        dist.all_reduce(bad, op=dist.ReduceOp.SUM, group=self.mesh_group)
        return bad == 0

    def _clip_tree(self, d_ps, *, across_ranks: bool = False):
        """Global-norm clip of the summed gradient, in float32:
        ``g * min(1, clip_norm / (|d_ps| + 1e-6))``.  ``across_ranks``: the
        leaves are this rank's disjoint chunks (ZeRO; pads are zero), and
        the squared norm sums over ranks by one scalar all-reduce."""
        sq = sum(torch.sum(torch.square(g.to(torch.float32)))
                 for g in d_ps.values())
        if across_ranks:
            dist.all_reduce(sq, op=dist.ReduceOp.SUM, group=self.group)
        one = torch.ones((), dtype=torch.float32, device=sq.device)
        # Divide by a tensor: the card would multiply by the reciprocal of
        # a Python number.
        scale = torch.minimum(one, (one * self.clip_norm)
                              / (torch.sqrt(sq) + 1e-6))
        return OrderedDict((n, (g.to(torch.float32) * scale).to(g.dtype))
                           for n, g in d_ps.items())

    def _settle_step_counters(self) -> "bool | None":
        """Settle the last skip_nonfinite step's consensus: if it skipped,
        take back its increment of the rules' step counters.  Returns
        whether it skipped (None if no step is unsettled)."""
        if self._unsettled is None:
            return None
        ok, event = self._unsettled
        self._unsettled = None
        if event is not None:
            event.synchronize()
        skipped = not bool(ok)
        if skipped:
            for st in self.state.values():
                st["step"] = st["step"] - 1
        return skipped

    def _phase_update(self, d):
        """The update phase: each parameter's rule on the summed gradient,
        or under ZeRO on this rank's chunks, whose new values all-gather
        (bucketed) back to replicated params."""
        self._settle_step_counters()
        if not self.zero:
            for n, p in self.params.items():
                st = self.state[n]
                self.params[n], self.state[n] = self._update_fn(
                    p, d[n], st, **resolve_hyper(self.hyper, st["step"]))
            return
        new_chunks = OrderedDict()
        for n, p in self.params.items():
            st = self.state[n]
            new_chunks[n], self.state[n] = self._update_fn(
                self._my_chunk(p, n), d[n].to(p.dtype), st,
                **resolve_hyper(self.hyper, st["step"]))
        gathered = collectives.allgather_tree_bucketed(
            new_chunks, self.group, bucket_bytes=self.bucket_bytes)
        for n in self.params:
            self.params[n] = self._dechunk(n, gathered[n])

    def _phase_ema(self) -> None:
        if self.ema_decay is None:
            return
        decay = self.ema_decay
        self.extras["ema"] = OrderedDict(
            (n, decay * e + (1.0 - decay) * self.params[n].to(e.dtype))
            for n, e in self.extras["ema"].items())

    def _keep_unless(self, ok, params, state, aux, extras):
        """After a skip_nonfinite step's update: every param, state tensor,
        aux tensor and extra (EF residual, EMA weights) takes its new value
        where ``ok`` (a device flag), else keeps the old one — no host
        sync.  The rules' step counters live on the host, so their
        increment is settled when they are next read
        (`_settle_step_counters`)."""
        def keep(new, old):
            return torch.where(ok, new, old)

        for n in self.params:
            self.params[n] = keep(self.params[n], params[n])
            self.state[n] = {k: v if k == "step" else keep(v, state[n][k])
                             for k, v in self.state[n].items()}
        new_aux, treedef = tree_flatten(self.aux)
        self.aux = tree_unflatten(treedef, [
            keep(a, b) for a, b in zip(new_aux, tree_leaves(aux))])
        for key, old in extras.items():
            self.extras[key] = OrderedDict(
                (n, keep(v, old[n])) for n, v in self.extras[key].items())
        host = ok.to("cpu", non_blocking=True)
        event = None
        if ok.is_cuda:
            event = torch.cuda.Event()
            event.record()
        self._unsettled = (host, event)

    # -- the step ------------------------------------------------------------

    def _shard_batch(self, batch):
        """This rank's shard of the global batch, on this rank's device:
        the contiguous slice of the leading dim (the JAX step's
        ``P('ps')``), or over a mesh the slices ``batch_spec`` names, dim
        by dim (an entry naming a tuple of axes splits over their
        row-major index)."""
        if self.mesh is None:
            spec = [(self.world_size, self.rank)]
        else:
            spec = [None if e is None else
                    (self.mesh.axis_size(e), self.mesh.axis_index(e))
                    for e in self.batch_spec]

        def shard(x):
            x = torch.as_tensor(x)
            for dim, split in enumerate(spec):
                if split is None:
                    continue
                n, me = split
                if x.shape[dim] % n:
                    if dim == 0:
                        raise ValueError(
                            f"batch leading dim {x.shape[0]} is not "
                            f"divisible by world size {n}")
                    raise ValueError(f"batch dim {dim} of size "
                                     f"{x.shape[dim]} is not divisible by "
                                     f"its {n} shards")
                per = x.shape[dim] // n
                x = x.narrow(dim, me * per, per)
            return x.to(self.device)

        return tree_map(shard, batch)

    def _static_byte_metrics(self) -> dict[str, float]:
        """``msg_bytes`` and ``packaged_bytes``: the parameters' shapes
        and the codec are fixed once the step is compiled, so they are
        counted once, on the first step after `compile_step`."""
        if self._byte_metrics is None:
            msg = sum(bytes_of(p) for p in self.params.values())
            packaged = sum(self.code.wire_bytes(p.shape, p.dtype)
                           for p in self.params.values())
            self._byte_metrics = {"msg_bytes": float(msg),
                                  "packaged_bytes": float(packaged)}
        return self._byte_metrics

    def step(self, batch=None, closure=None, loss_fn: Callable | None = None,
             block: bool = True):
        """Run one synchronous PS step on the GLOBAL batch.  Returns
        ``(loss, metrics)``: the loss averaged across ranks, and the
        reference's metric keys.

        ``block=False`` returns once the step is queued on the device, with
        the loss as a 0-d tensor and ``comm_wait`` 0 (``nonfinite_skip``
        is reported only by a blocking step).  ``closure`` is called and
        its loss discarded, as the JAX step does.  With ``profile=True``
        each phase runs to a device synchronize and is timed on its own
        (`_profiled_step`).  On the ``consensus_every`` cadence the
        replica-consensus guard runs after the step (`check_consensus`).
        ``sync_calls`` counts the flat collectives of the sync phase.

        Under ``torch.profiler`` the step is the span ``ps.step`` (its
        ``args`` the step's index) around the spans ``ps.grad``,
        ``ps.encode``, ``ps.sync`` and ``ps.update``
        (`utils.timing.annotate`)."""
        if loss_fn is not None and loss_fn is not self._loss_fn:
            self.compile_step(loss_fn, has_aux=self._has_aux,
                              accum_steps=self._accum, remat=self._remat)
        if self._loss_fn is None:
            raise NotCompiledError("call compile_step(loss_fn) before step()")
        if batch is None:
            raise ValueError("step() needs a batch")
        with annotate("ps.step", self.steps_completed):
            return self._step(batch, closure, block)

    def _step(self, batch, closure, block: bool):
        data: dict[str, float] = {k: 0.0 for k in STEP_METRIC_KEYS}
        data.update(self._static_byte_metrics())
        batch = self._shard_batch(batch)

        if closure is not None:  # API parity with the reference
            closure()

        if self.profile:
            loss = self._profiled_step(batch, data)
            self.steps_completed += 1
            if self._count_fused_sync:
                self.fault_stats["fused_sync_encodes"] += 1
            if block:
                loss = float(loss)
            self._maybe_check_consensus(data)
            self.timings.append(data)
            return loss, data

        start = time.perf_counter()
        with annotate("ps.grad"):
            loss, grads, new_aux = self._grads_and_aux(batch)
        with torch.no_grad():
            ok = self._all_finite(grads) if self.skip_nonfinite else None
            old = (dict(self.params), dict(self.state), self.aux,
                   {k: dict(v) for k, v in self.extras.items()})
            with annotate("ps.encode"):
                codes = self._phase_encode(grads)
            with annotate("ps.sync"):
                d = self._counted_sync(codes, data)
            del codes  # freed before the update allocates, as a temporary
            with annotate("ps.update"):
                self._phase_update(d)
                self._phase_ema()
            self.aux = new_aux
            if ok is not None:
                self._keep_unless(ok, *old)
        dispatch = time.perf_counter() - start
        if not self._warm:
            # The first step pays one-time set-up (kernel build and load,
            # cuDNN algorithm search): keep it out of isend_time.
            data["iallgather_prepare_time"] = dispatch
            self._warm = True
        else:
            data["isend_time"] = dispatch
        self.steps_completed += 1
        if self._count_fused_sync:
            self.fault_stats["fused_sync_encodes"] += 1
        if block:
            start = time.perf_counter()
            self._sync_device()
            data["comm_wait"] = time.perf_counter() - start
            data["nonfinite_skip"] = float(bool(self._settle_step_counters()))
            loss = float(loss)
        self._maybe_check_consensus(data)
        self.timings.append(data)
        return loss, data

    def _sync_device(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _counted_sync(self, codes, data):
        """`_phase_sync`, its flat collectives counted into
        ``data["sync_calls"]``."""
        before = collectives.flat_calls()
        d = self._phase_sync(codes)
        data["sync_calls"] = float(collectives.flat_calls() - before)
        return d

    def _profiled_step(self, batch, data):
        """The step as timed phases, each run to a device synchronize: grad
        (forward, backward, the loss and aux averages and, with
        skip_nonfinite, the consensus, read on the host), encode (with the
        EF residual), sync (exchange and decode, then clip; ZeRO: this
        rank's chunks), update (ZeRO: with the all-gather of the chunks)
        and ema; the JAX package's phase keys.  A skipped step runs no
        later phase.  Under ``sync_mode="overlap"`` the exchange runs
        inside backward, so ``backward_time`` includes it and the encode
        phase is empty."""
        identity = isinstance(self.code, IdentityCodec)
        t0 = time.perf_counter()
        with annotate("ps.grad"):
            loss, grads, new_aux = self._grads_and_aux(batch)
            with torch.no_grad():
                ok = (self._all_finite(grads) if self.skip_nonfinite
                      else None)
            self._sync_device()
        data["backward_time"] = time.perf_counter() - t0
        if ok is not None and not bool(ok):
            data["nonfinite_skip"] = 1.0
            return loss
        self.aux = new_aux
        data["nonfinite_skip"] = 0.0

        with torch.no_grad():
            t0 = time.perf_counter()
            with annotate("ps.encode"):
                codes = self._phase_encode(grads)
                self._sync_device()
            data["code_wait"] = time.perf_counter() - t0

            with annotate("ps.sync"):
                t0 = time.perf_counter()
                d = self._counted_sync(codes, data)
                data["isend_time"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                self._sync_device()
                data["comm_wait"] = time.perf_counter() - t0
            # The decode is part of the sync phase; report it there.
            data["decode_time"] = data["comm_wait"] if not identity else 0.0

            with annotate("ps.update"):
                t0 = time.perf_counter()
                self._phase_update(d)
                self._sync_device()
                data["optim_step_time"] = time.perf_counter() - t0
                if self.ema_decay is not None:
                    t0 = time.perf_counter()
                    self._phase_ema()
                    self._sync_device()
                    data["ema_time"] = time.perf_counter() - t0
        return loss

    # -- replica-consensus SDC guard -----------------------------------------

    def check_consensus(self) -> dict:
        """Run the replica-consensus SDC guard once (also runs on the
        ``consensus_every`` cadence inside `step`): fingerprint every
        parameter leaf on each rank (`param_fingerprints`) and compare
        across ranks by an all-reduce MAX and MIN.  Returns ``{"ok",
        "mismatched", "first_leaf"}``; counts into ``fault_stats`` and, on
        mismatch, either raises `SDCDetectedError` (policy "abort") or
        restores rank 0's params (policy "rebroadcast")."""
        names = list(self.params)
        fp = param_fingerprints(self.params)
        hi, lo = fp.clone(), fp.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=self.mesh_group)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=self.mesh_group)
        same = (hi == lo).cpu().numpy()
        leaf_ok = same[:len(names)] & same[len(names):]
        self.fault_stats["sdc_checks"] += 1
        bad = [n for n, ok in zip(names, leaf_ok) if not ok]
        if not bad:
            return {"ok": True, "mismatched": [], "first_leaf": None}
        first = bad[0]
        self.fault_stats["sdc_mismatches"] += 1
        if self.fault_stats["sdc_first_leaf"] is None:
            self.fault_stats["sdc_first_leaf"] = first
        self.fault_stats["sdc_events"].append(
            {"step": self.steps_completed, "leaves": bad[:8],
             "n_leaves": len(bad), "policy": self.consensus_policy})
        msg = (f"replica consensus violated at step {self.steps_completed}:"
               f" {len(bad)}/{len(names)} parameter leaves differ across "
               f"data-parallel replicas (first diverging leaf: {first!r}) "
               f"— silent data corruption or a desync bug")
        print(msg, file=sys.stderr)
        if self.consensus_policy == "abort":
            raise SDCDetectedError(msg)
        self._rebroadcast()
        self.fault_stats["sdc_rebroadcasts"] += 1
        print(f"re-broadcast replica 0's params over {len(names)} leaves "
              f"(policy=rebroadcast); training continues", file=sys.stderr)
        return {"ok": False, "mismatched": bad, "first_leaf": first}

    def _rebroadcast(self) -> None:
        """Restore consensus from rank 0 of the mesh: each leaf becomes
        the sum over the whole mesh of ``where(rank == 0, p, 0)`` (the JAX
        guard's masked sum, not a broadcast: the sum turns rank 0's -0.0
        into +0.0, as JAX's does), bucketed."""
        masked = OrderedDict(
            (n, p.clone() if self.mesh_rank == 0 else torch.zeros_like(p))
            for n, p in self.params.items())
        summed = collectives.psum_tree_bucketed(
            masked, self.mesh_group, bucket_bytes=self.bucket_bytes)
        self.params = OrderedDict((n, summed[n].to(p.dtype))
                                  for n, p in self.params.items())

    def _maybe_check_consensus(self, data: dict) -> None:
        if (self.consensus_every
                and self.steps_completed % self.consensus_every == 0):
            out = self.check_consensus()
            data["sdc_mismatch"] = 0.0 if out["ok"] else 1.0

    # -- checkpoint / resume -------------------------------------------------

    def topology(self) -> dict:
        """The source-topology record every checkpoint carries: what
        elastic N→M resume verifies (and de-chunks raw ZeRO shards
        against) at load."""
        if self.mesh is not None:
            mesh = describe_mesh(self.mesh)
        else:
            mesh = {"axis_names": ["ps"], "shape": {"ps": self.world_size},
                    "n_devices": self.world_size,
                    "platform": ("gpu" if self.device.type == "cuda"
                                 else "cpu")}
        return {"world_size": self.world_size, "axes": list(self.axes),
                "mesh": mesh, "zero": self.zero,
                "error_feedback": self.error_feedback}

    def state_dict(self, *, raw_shards: bool = False) -> dict:
        """Torch-style snapshot: params, per-param optimizer state, aux
        (BatchNorm stats), hyperparameters, the EF residual ``[world,
        ...]`` (an all-gather of the ranks' residuals), the EMA weights and
        the source topology — host numpy copies, every rank's the same.
        bfloat16 tensors come out as float32 (exactly; numpy has no
        bfloat16) and load back into their dtype.

        ZeRO state de-chunks to full buffers, so a checkpoint is world-size
        independent and interchanges with replicated mode;
        ``raw_shards=True`` keeps it as ``(world, chunk)`` rows instead,
        which `load_state_dict` de-chunks against the recorded topology.
        Every rank must call it (the gathers are collective)."""
        self._settle_step_counters()
        if self.zero:
            gathered = self._gather_chunks(self.state)
            state = OrderedDict(
                (n, {k: (v if v.dim() != 2 or raw_shards
                         else self._dechunk(n, v))
                     for k, v in st.items()})
                for n, st in gathered.items())
        else:
            state = self.state
        ef = None
        if self.error_feedback:
            ef = collectives.allgather_tree_bucketed(
                OrderedDict((n, v[0]) for n, v in self.extras["ef"].items()),
                self.group, bucket_bytes=self.bucket_bytes)
        return {
            "optim": self.optim,
            "hyper": hyper_for_checkpoint(self.hyper),
            "topology": {**self.topology(),
                         "raw_zero_shards": bool(raw_shards and self.zero)},
            "params": tree_map(host_numpy, self.params),
            "state": tree_map(host_numpy, state),
            "aux": tree_map(host_numpy, self.aux),
            "ef": None if ef is None else tree_map(host_numpy, ef),
            "ema": (tree_map(host_numpy, self.extras["ema"])
                    if self.ema_decay is not None else None),
        }

    def _normalize_state_leaf(self, a, *, name: str, src_world: int):
        """One optimizer-state leaf from a checkpoint -> full-shape host
        array on THIS topology: full buffers and scalars pass through; a
        ``(src_world, chunk)`` ZeRO shard row set from the recorded source
        topology de-chunks.  Anything else is refused by name."""
        a = np.asarray(a)
        shape = tuple(self.params[name].shape)
        if a.ndim == 0 or a.shape == shape:
            return a
        sz = int(np.prod(shape))
        if (src_world and a.ndim == 2
                and a.shape == (src_world, -(-sz // src_world))):
            return a.reshape(-1)[:sz].reshape(shape)
        raise ElasticResumeError(
            f"optimizer state for {name!r} has shape {a.shape}, which is "
            f"neither the full parameter shape {shape} nor a "
            f"(world={src_world or 'unrecorded'}, chunk) ZeRO shard layout "
            f"from the checkpoint's recorded source topology — this "
            f"component is topology-bound; re-save it de-chunked "
            f"(state_dict() without raw_shards) on the source mesh")

    def _ef_rows(self, name: str, saved) -> np.ndarray:
        """This rank's EF residual row ``(1, ...)`` from a checkpoint's
        ``[world, ...]`` residual: the same row on the same world size
        (bitwise resume), else the cross-rank sum split evenly
        (aggregate-exact); a legacy parameter-shaped sum splits too."""
        shape = tuple(self.params[name].shape)
        world = self.world_size
        if saved is None or name not in saved:  # trained without EF
            return np.zeros((1,) + shape, np.float32)
        a = np.asarray(saved[name], np.float32)
        if a.shape != shape and a.shape[1:] != shape:
            raise ElasticResumeError(
                f"error-feedback residual for {name!r}: shape {a.shape} is "
                f"neither the parameter shape {shape} (legacy sum format) "
                f"nor (world,) + parameter shape — cannot remap it to "
                f"({world},) + {shape}")
        if a.shape == (world,) + shape:
            return a[self.rank:self.rank + 1]
        total = a.sum(axis=0) if a.shape != shape else a
        return (total / world)[None]

    def load_state_dict(self, sd: dict) -> None:
        """Restore from `state_dict` output (or a JAX package checkpoint
        through `utils.interop.state_from_jax`) onto this optimizer's
        world — any size: params are replicated; ZeRO state de-chunks from
        the recorded source topology and re-chunks for this world; the EF
        residual keeps each rank's row on the same world size and splits
        the sum evenly on another.  A component that cannot be remapped
        raises `ElasticResumeError` naming it."""
        if sd["optim"] != self.optim:
            raise ValueError(
                f"checkpoint is for optim={sd['optim']!r}, this is {self.optim!r}")
        if set(sd["params"]) != set(self.params):
            missing = set(self.params) ^ set(sd["params"])
            raise ElasticResumeError(
                f"parameter name mismatch: {sorted(missing)}")
        for n, p in self.params.items():
            have = tuple(np.shape(sd["params"][n]))
            if have != tuple(p.shape):
                raise ElasticResumeError(
                    f"parameter {n!r}: checkpoint shape {have} does not "
                    f"match model shape {tuple(p.shape)} — a model change, "
                    f"not a topology change; elastic resume cannot remap it")
        src = sd.get("topology") or {}
        src_world = int(src.get("world_size") or 0)
        self.hyper = hyper_from_checkpoint(sd["hyper"], self.hyper)

        def place(a, like):
            return torch.as_tensor(np.array(a)).to(self.device, like.dtype)

        self.params = OrderedDict(
            (n, place(sd["params"][n], p)) for n, p in self.params.items())
        state = OrderedDict()
        for n, st in self.state.items():
            state[n] = {}
            for k, v in sd["state"][n].items():
                a = self._normalize_state_leaf(v, name=n,
                                               src_world=src_world)
                if k == "step":  # host counter (`optim.rules`)
                    state[n][k] = torch.tensor(int(a), dtype=torch.int32)
                else:
                    state[n][k] = place(a, st.get(k, self.params[n]))
        self.state = self._chunk_state(state) if self.zero else state
        self._unsettled = None
        self.aux = tree_map(
            lambda a: torch.as_tensor(np.array(a)).to(self.device),
            sd["aux"])
        if self.error_feedback:
            self.extras["ef"] = OrderedDict(
                (n, torch.as_tensor(np.array(self._ef_rows(n, sd.get("ef"))))
                 .to(self.device))
                for n in self.params)
        if self.ema_decay is not None:
            saved = sd.get("ema") or {}
            # Trained without EMA: restart the average from the params.
            self.extras["ema"] = OrderedDict(
                (n, place(saved.get(n, sd["params"][n]), p))
                for n, p in self.params.items())

    def rescale_lr(self, scale: float) -> None:
        """Multiply the learning rate by ``scale`` (wrapping a schedule if
        lr is one) — the rollback guardrail's lr backoff.  A wrapped
        schedule checkpoints as the schedule marker."""
        if not scale > 0:
            raise ValueError(f"lr scale must be positive, got {scale}")
        lr = self.hyper["lr"]
        self.hyper["lr"] = ((lambda step, _lr=lr: float(
            np.float32(scale) * np.float32(_lr(step))))
            if callable(lr) else scale * lr)

    # -- conveniences --------------------------------------------------------

    @property
    def ef_state(self):
        """The EF residual of every rank (``[world, ...]`` leaves, an
        all-gather: every rank must read it), or None."""
        if not self.error_feedback:
            return None
        return collectives.allgather_tree_bucketed(
            OrderedDict((n, v[0]) for n, v in self.extras["ef"].items()),
            self.group, bucket_bytes=self.bucket_bytes)

    @property
    def ema_params(self):
        """The EMA-averaged weights (evaluation-quality), or None."""
        return self.extras.get("ema")

    def named_parameters(self):
        return list(self.params.items())

    def print_summary(self) -> None:
        """Mean and max of each step metric over the run so far."""
        print_summary(self.timings)


class PS(MPI_PS):
    """The JAX package's alias of `MPI_PS`."""


class SGD(MPI_PS):
    """SGD variant — the reference's update math (momentum buffer
    first-step asymmetry, nesterov, weight decay)."""

    def __init__(self, named_params, **kwargs):
        kwargs["optim"] = "sgd"
        super().__init__(named_params, **kwargs)


class Adam(MPI_PS):
    """Adam variant — the reference's update math (old-torch eps
    placement, bias-corrected step size, amsgrad)."""

    def __init__(self, named_params, **kwargs):
        kwargs["optim"] = "adam"
        super().__init__(named_params, **kwargs)


class AdamW(MPI_PS):
    """AdamW variant — decoupled weight decay (torch.optim.AdamW math)."""

    def __init__(self, named_params, **kwargs):
        kwargs["optim"] = "adamw"
        super().__init__(named_params, **kwargs)
