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

Ported in this slice: the ``post`` and ``bucketed`` sync modes and the
``identity``, ``bf16`` and ``blockq`` codecs.  Every other option of the
JAX constructor raises `NotImplementedError` when set to anything but its
default.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable

import torch

from .errors import NotCompiledError
from .ops.codecs import Codec, IdentityCodec, get_codec
from .optim.rules import RULES
from .optim.schedules import resolve_hyper
from .parallel import collectives
from .parallel.mesh import make_ps_group, rank, resolve_device, world_size
from .utils.bytes import bytes_of
from .utils.flatten import tree_map
from .utils.timing import STEP_METRIC_KEYS

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
    "zero": False, "skip_nonfinite": False, "clip_norm": None,
    "error_feedback": False, "ema_decay": None, "profile": False,
    "fused_encode": False, "consensus_every": 0, "consensus_policy": "abort",
    "decompose_allreduce": False, "overlap_reducer": "rs_ag",
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
                 bucket_mb: float | None =
                 collectives.DEFAULT_BUCKET_BYTES / (1 << 20),
                 sync_mode: str | None = None, names=(), use_mpi: bool = True,
                 **kwargs):
        del names, use_mpi  # accepted for API parity with the reference
        for key, default in _NOT_PORTED.items():
            if key in kwargs and kwargs.pop(key) != default:
                raise NotImplementedError(
                    f"{key}= is not ported to the PyTorch package yet "
                    f"(only its default {default!r} is accepted)")
        self.device = resolve_device(device)
        self.optim = optim
        self.code = get_codec(code)
        if bucket_mb is not None and bucket_mb < 0:
            raise ValueError(f"bucket_mb must be >= 0, got {bucket_mb}")
        self.bucket_bytes = (int(bucket_mb * (1 << 20))
                             if bucket_mb else None)
        # WHEN the cross-rank gradient sum happens:
        #   "post"     — after backward, one collective per parameter;
        #   "bucketed" — after backward, dtype-bucketed flat transfers
        #                (the default whenever bucket_mb is set).
        if sync_mode is None:
            sync_mode = "bucketed" if self.bucket_bytes else "post"
        if sync_mode == "overlap":
            raise NotImplementedError(
                "sync_mode='overlap' is not ported to the PyTorch package yet")
        if sync_mode not in ("post", "bucketed"):
            raise ValueError(f"sync_mode must be one of ('post', 'bucketed',"
                             f" 'overlap'), got {sync_mode!r}")
        if sync_mode == "post":
            self.bucket_bytes = None  # per-parameter collectives, explicitly
        self.sync_mode = sync_mode

        def place(x):
            return torch.as_tensor(x).detach().to(self.device, copy=True)

        self.params, self.state, self.hyper, self._update_fn = init_ps_core(
            named_params, optim, kwargs, place)
        self.group = group if group is not None else make_ps_group(
            self.device)
        self.world_size = world_size(self.group)
        self.rank = rank(self.group)
        self.timings: list[dict[str, float]] = []
        self.steps_completed = 0
        self.aux = OrderedDict()  # model aux state (BatchNorm statistics)
        self._has_aux = False
        self._loss_fn = None
        self._warm = False

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
        eagerly, so nothing is traced here."""
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        if accum_steps > 1 or remat:
            raise NotImplementedError(
                "accum_steps > 1 and remat=True are not ported to the "
                "PyTorch package yet")
        self._loss_fn = loss_fn
        self._has_aux = has_aux
        self._warm = False
        if aux is not None:
            self.aux = tree_map(
                lambda x: torch.as_tensor(x).detach().to(self.device,
                                                         copy=True), aux)

    def _grads_and_aux(self, batch):
        """Per-rank loss, gradients and new aux — each rank grads its own
        batch shard; the cross-rank sum happens later, explicitly."""
        leaves = OrderedDict((n, p.detach().requires_grad_())
                             for n, p in self.params.items())
        if self._has_aux:
            loss, new_aux = self._loss_fn(leaves, self.aux, batch)
        else:
            loss, new_aux = self._loss_fn(leaves, batch), self.aux
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), OrderedDict(zip(leaves, grads)), new_aux

    def _summed_grads(self, grads):
        """Cross-rank gradient sum: the identity codec is a bucketed
        all-reduce; other codecs encode, all-gather the codes (bucketed)
        and decode-sum all the parameters at once (one grouped kernel
        launch for the ported codecs)."""
        if isinstance(self.code, IdentityCodec):
            return collectives.psum_tree_bucketed(
                grads, self.group, bucket_bytes=self.bucket_bytes)
        codes = OrderedDict((n, self.code.encode(g)) for n, g in grads.items())
        gathered = collectives.allgather_tree_bucketed(
            codes, self.group, bucket_bytes=self.bucket_bytes)
        metas = OrderedDict((n, (g.shape, g.dtype)) for n, g in grads.items())
        return self.code.decode_sum_leaves(gathered, metas)

    def _apply_updates(self, d_ps):
        for n, p in self.params.items():
            st = self.state[n]
            self.params[n], self.state[n] = self._update_fn(
                p, d_ps[n], st, **resolve_hyper(self.hyper, st["step"]))

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
        the loss as a 0-d tensor and ``comm_wait`` 0.  ``closure`` is
        called and its loss discarded, as the JAX step does."""
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

        start = time.perf_counter()
        loss, grads, new_aux = self._grads_and_aux(batch)
        with torch.no_grad():
            d_ps = self._summed_grads(grads)
            self._apply_updates(d_ps)
            synced = collectives.pmean_tree(
                {"aux": new_aux, "loss": loss}, self.group,
                bucket_bytes=self.bucket_bytes)
        self.aux, loss = synced["aux"], synced["loss"]
        dispatch = time.perf_counter() - start
        if not self._warm:
            # The first step pays one-time set-up (kernel build and load,
            # cuDNN algorithm search): keep it out of isend_time.
            data["iallgather_prepare_time"] = dispatch
            self._warm = True
        else:
            data["isend_time"] = dispatch
        self.steps_completed += 1
        if block:
            start = time.perf_counter()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            data["comm_wait"] = time.perf_counter() - start
            data["nonfinite_skip"] = 0.0
            loss = float(loss)
        self.timings.append(data)
        return loss, data


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
