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

Ported: the ``post``, ``bucketed`` and ``overlap`` sync modes (the
overlap engine, `parallel.overlap`, issues each bucket's exchange inside
backward; ``fused_encode`` quantizes a blockq bucket as one tensor), the
``identity``, ``bf16`` and ``blockq`` codecs, ``decompose_allreduce``,
``clip_norm``, ``skip_nonfinite`` and ``profile``.  Every other option of
the JAX constructor raises `NotImplementedError` when set to anything but
its default.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable

import torch
import torch.distributed as dist

from .errors import NotCompiledError
from .ops.codecs import Codec, IdentityCodec, get_codec
from .optim.rules import RULES
from .optim.schedules import resolve_hyper
from .parallel import collectives, overlap
from .parallel.mesh import make_ps_group, rank, resolve_device, world_size
from .utils.bytes import bytes_of
from .utils.flatten import (tree_flatten, tree_leaves, tree_map,
                            tree_unflatten)
from .utils.timing import STEP_METRIC_KEYS, record_overlap_schedule

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

# Options of the JAX MPI_PS that this package does not port yet, with the
# defaults under which they are inert.
_NOT_PORTED = {
    "zero": False, "error_feedback": False, "ema_decay": None,
    "consensus_every": 0, "consensus_policy": "abort",
    "mesh": None, "axis": "ps", "batch_spec": None, "cuda": False,
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
                 code: Codec | str | None = None, device="cuda", group=None,
                 profile: bool = False, skip_nonfinite: bool = False,
                 clip_norm: float | None = None,
                 bucket_mb: float | None =
                 collectives.DEFAULT_BUCKET_BYTES / (1 << 20),
                 decompose_allreduce: bool = False,
                 sync_mode: str | None = None,
                 overlap_reducer: str = "rs_ag",
                 fused_encode: bool = False,
                 names=(), use_mpi: bool = True, **kwargs):
        del names, use_mpi  # accepted for API parity with the reference
        for key, default in _NOT_PORTED.items():
            if key in kwargs and kwargs.pop(key) != default:
                raise NotImplementedError(
                    f"{key}= is not ported to the PyTorch package yet "
                    f"(only its default {default!r} is accepted)")
        self.device = resolve_device(device)
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
        if (sync_mode == "overlap" and skip_nonfinite
                and not isinstance(self.code, IdentityCodec)):
            raise ValueError(
                "sync_mode='overlap' + skip_nonfinite needs the "
                "identity codec: the finiteness consensus then runs on "
                "the summed gradient (NaN/inf propagates through the "
                "sum), whereas a lossy codec could launder a NaN "
                "before any post-sync check; use sync_mode='bucketed', "
                "which checks the raw per-rank gradients pre-encode")
        # Skip-on-NaN: if any rank's gradient holds a non-finite value, every
        # rank keeps its params, state and aux and reports
        # ``nonfinite_skip=1``.  Global-norm clipping of the summed gradient
        # (what the update rules consume), identical on every rank.
        if clip_norm is not None and not clip_norm > 0:
            # `not >` also rejects NaN.
            raise ValueError(f"clip_norm must be positive, got {clip_norm}")
        self.clip_norm = clip_norm
        self.skip_nonfinite = skip_nonfinite

        def place(x):
            return torch.as_tensor(x).detach().to(self.device, copy=True)

        self.params, self.state, self.hyper, self._update_fn = init_ps_core(
            named_params, optim, kwargs, place)
        self.group = group if group is not None else make_ps_group(
            self.device)
        self.world_size = world_size(self.group)
        self.rank = rank(self.group)
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
                "world": self.world_size, "zero": False})
        self._bucket_sync = None
        self._count_fused_sync = False
        # The sync trainer's failure-path counters, with the JAX package's
        # keys; only ``fused_sync_encodes`` counts here (steps whose sync
        # ran the fused per-bucket encode).
        self.fault_stats: dict = {
            "sdc_checks": 0, "sdc_mismatches": 0, "sdc_rebroadcasts": 0,
            "sdc_first_leaf": None, "sdc_events": [],
            "fused_sync_encodes": 0, "rollbacks": []}
        self.timings: list[dict[str, float]] = []
        self.steps_completed = 0
        self.aux = OrderedDict()  # model aux state (BatchNorm statistics)
        self._has_aux = False
        self._loss_fn = None
        self._warm = False
        # A skip_nonfinite step's consensus on its way to the host: the
        # rules' step counters (host tensors) are settled from it before
        # they are next read (`_settle_step_counters`).
        self._unsettled = None

    # -- step construction ---------------------------------------------------

    def compile_step(self, loss_fn: Callable, *, has_aux: bool = False,
                     aux=None, accum_steps: int = 1,
                     remat: bool = False) -> None:
        """Bind the loss function.

        ``has_aux=True`` means ``loss_fn(params, aux, batch) -> (loss,
        new_aux)`` — for models carrying non-trained state (BatchNorm
        statistics), which the step averages across ranks and threads
        through.  Otherwise ``loss_fn(params, batch) -> loss``.  ``params``
        is an ordered dict of tensors that require grad.  PyTorch runs
        eagerly, so nothing is traced here; under ``sync_mode="overlap"``
        the bucket sync is built here."""
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        if accum_steps > 1 and self.sync_mode == "overlap":
            raise ValueError(
                "sync_mode='overlap' does not compose with accum_steps > 1 "
                "(each microbatch's backward would re-run the cross-rank "
                "exchange); use sync_mode='bucketed' with accumulation")
        if accum_steps > 1 or remat:
            raise NotImplementedError(
                "accum_steps > 1 and remat=True are not ported to the "
                "PyTorch package yet")
        if self.sync_mode == "overlap":
            self._bucket_sync = overlap.make_bucket_sync_fn(
                group=self.group, world=self.world_size,
                codec=(None if isinstance(self.code, IdentityCodec)
                       else self.code),
                reducer=self.overlap_reducer, fused_encode=self.fused_encode)
            # Counted once per step from here on (`fault_stats`).
            self._count_fused_sync = self.fused_encode
        self._loss_fn = loss_fn
        self._has_aux = has_aux
        self._warm = False
        if aux is not None:
            self.aux = tree_map(
                lambda x: torch.as_tensor(x).detach().to(self.device,
                                                         copy=True), aux)

    def _grads_and_aux(self, batch):
        """Loss and aux averaged across ranks, and the gradients: each
        rank's own (the cross-rank sum happens later, explicitly), or under
        ``sync_mode="overlap"`` already summed — each bucket's exchange
        issued inside backward, waited for and decoded after it."""
        leaves = OrderedDict((n, p.detach().requires_grad_())
                             for n, p in self.params.items())
        hooks = (overlap.BucketHooks(leaves, self.overlap_plan,
                                     self._bucket_sync)
                 if self._bucket_sync is not None else None)
        if self._has_aux:
            loss, new_aux = self._loss_fn(leaves, self.aux, batch)
        else:
            loss, new_aux = self._loss_fn(leaves, batch), self.aux
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True,
                                    materialize_grads=hooks is None)
        with torch.no_grad():
            grads = (hooks.finish() if hooks is not None
                     else OrderedDict(zip(leaves, grads)))
            synced = collectives.pmean_tree(
                {"aux": new_aux, "loss": loss.detach()}, self.group,
                bucket_bytes=self.bucket_bytes)
        return synced["loss"], grads, synced["aux"]

    def _encode_all(self, grads):
        return OrderedDict((n, self.code.encode(g)) for n, g in grads.items())

    def _sync_codes(self, codes):
        """Cross-rank gradient sum of a step's codes: the identity codec is
        a bucketed all-reduce (or reduce-scatter + all-gather); other
        codecs all-gather the codes (bucketed) and decode-sum all the
        parameters at once (one grouped kernel launch for the ported
        codecs)."""
        if isinstance(self.code, IdentityCodec):
            return collectives.psum_tree_bucketed(
                codes, self.group, bucket_bytes=self.bucket_bytes,
                decompose=self.decompose_allreduce)
        gathered = collectives.allgather_tree_bucketed(
            codes, self.group, bucket_bytes=self.bucket_bytes)
        metas = OrderedDict((n, (p.shape, p.dtype))
                            for n, p in self.params.items())
        return self.code.decode_sum_leaves(gathered, metas)

    def _summed_grads(self, grads):
        if self.sync_mode == "overlap":
            return grads  # summed inside backward
        return self._sync_codes(self._encode_all(grads))

    def _all_finite(self, grads) -> torch.Tensor:
        """0-d bool on the device: no rank's gradient holds a NaN or inf
        (a cross-rank sum of the non-finite counts)."""
        bad = torch.stack([torch.isfinite(g).logical_not().sum()
                           for g in grads.values()]).sum().to(torch.float32)
        dist.all_reduce(bad, op=dist.ReduceOp.SUM, group=self.group)
        return bad == 0

    def _clip_tree(self, d_ps):
        """Global-norm clip of the summed gradient, in float32:
        ``g * min(1, clip_norm / (|d_ps| + 1e-6))``."""
        sq = sum(torch.sum(torch.square(g.to(torch.float32)))
                 for g in d_ps.values())
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

    def _apply_updates(self, d_ps):
        self._settle_step_counters()
        for n, p in self.params.items():
            st = self.state[n]
            self.params[n], self.state[n] = self._update_fn(
                p, d_ps[n], st, **resolve_hyper(self.hyper, st["step"]))

    def _keep_unless(self, ok, params, state, aux):
        """After a skip_nonfinite step's update: every param, state tensor
        and aux tensor takes its new value where ``ok`` (a device flag),
        else keeps the old one — no host sync.  The rules' step counters
        live on the host, so their increment is settled when they are next
        read (`_settle_step_counters`)."""
        def keep(new, old):
            return torch.where(ok, new, old)

        for n in self.params:
            self.params[n] = keep(self.params[n], params[n])
            self.state[n] = {k: v if k == "step" else keep(v, state[n][k])
                             for k, v in self.state[n].items()}
        new_aux, treedef = tree_flatten(self.aux)
        self.aux = tree_unflatten(treedef, [
            keep(a, b) for a, b in zip(new_aux, tree_leaves(aux))])
        host = ok.to("cpu", non_blocking=True)
        event = None
        if ok.is_cuda:
            event = torch.cuda.Event()
            event.record()
        self._unsettled = (host, event)

    # -- the step ------------------------------------------------------------

    def _shard_batch(self, batch):
        """This rank's contiguous slice of the global batch's leading dim
        (the JAX step's ``P('ps')`` sharding), on this rank's device."""
        world, me = self.world_size, self.rank

        def shard(x):
            x = torch.as_tensor(x)
            if x.shape[0] % world:
                raise ValueError(f"batch leading dim {x.shape[0]} is not "
                                 f"divisible by world size {world}")
            per = x.shape[0] // world
            return x[me * per:(me + 1) * per].to(self.device)

        return tree_map(shard, batch)

    def _static_byte_metrics(self) -> dict[str, float]:
        msg = sum(bytes_of(p) for p in self.params.values())
        packaged = sum(self.code.wire_bytes(p.shape, p.dtype)
                       for p in self.params.values())
        return {"msg_bytes": float(msg), "packaged_bytes": float(packaged)}

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
        (`_profiled_step`)."""
        if loss_fn is not None and loss_fn is not self._loss_fn:
            self.compile_step(loss_fn, has_aux=self._has_aux)
        if self._loss_fn is None:
            raise NotCompiledError("call compile_step(loss_fn) before step()")
        if batch is None:
            raise ValueError("step() needs a batch")

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
            self.timings.append(data)
            return loss, data

        start = time.perf_counter()
        loss, grads, new_aux = self._grads_and_aux(batch)
        with torch.no_grad():
            ok = self._all_finite(grads) if self.skip_nonfinite else None
            d_ps = self._summed_grads(grads)
            if self.clip_norm is not None:
                d_ps = self._clip_tree(d_ps)
            old = (dict(self.params), dict(self.state), self.aux)
            self._apply_updates(d_ps)
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
        self.timings.append(data)
        return loss, data

    def _sync_device(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _profiled_step(self, batch, data):
        """The step as timed phases, each run to a device synchronize: grad
        (forward, backward, the loss and aux averages and, with
        skip_nonfinite, the consensus, read on the host), encode, sync
        (exchange and decode, then clip) and update; the JAX package's
        phase keys.  A skipped step runs no later phase.  Under
        ``sync_mode="overlap"`` the exchange runs inside backward, so
        ``backward_time`` includes it and there is no encode phase."""
        identity = isinstance(self.code, IdentityCodec)
        over = self.sync_mode == "overlap"
        t0 = time.perf_counter()
        loss, grads, new_aux = self._grads_and_aux(batch)
        with torch.no_grad():
            ok = self._all_finite(grads) if self.skip_nonfinite else None
        self._sync_device()
        data["backward_time"] = time.perf_counter() - t0
        if ok is not None and not bool(ok):
            data["nonfinite_skip"] = 1.0
            return loss
        self.aux = new_aux
        data["nonfinite_skip"] = 0.0

        with torch.no_grad():
            t0 = time.perf_counter()
            codes = grads if over or identity else self._encode_all(grads)
            self._sync_device()
            data["code_wait"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            d_ps = grads if over else self._sync_codes(codes)
            if self.clip_norm is not None:
                d_ps = self._clip_tree(d_ps)
            data["isend_time"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            self._sync_device()
            data["comm_wait"] = time.perf_counter() - t0
            # The decode is part of the sync phase; report it there.
            data["decode_time"] = data["comm_wait"] if not identity else 0.0

            t0 = time.perf_counter()
            self._apply_updates(d_ps)
            self._sync_device()
            data["optim_step_time"] = time.perf_counter() - t0
        return loss


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
