"""World-N runs of the PyTorch port for the CPU tests — the ``mpirun -n N``
analogue.

`run_world` spawns ``world`` processes with ``torch.multiprocessing``
(``spawn``), joins them into one gloo group through a ``file://`` store in
the test's ``tmp_path``, runs one of the functions below on every rank and
returns each rank's result.  Each process uses one thread.  This module
imports no JAX, so the children start quickly.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch
import torch.multiprocessing as mp


def _entry(rank, fn_name, world, init_file, out_dir, args):
    import torch.distributed as dist

    from pytorch_ps_mpi_tpu_torch import make_ps_group

    torch.set_num_threads(1)
    make_ps_group("cpu", rank=rank, world_size=world, init_file=init_file)
    if ":" in fn_name:  # "module:function", a module of tests/
        import importlib

        module, name = fn_name.split(":")
        fn = getattr(importlib.import_module(module), name)
    else:
        fn = globals()[fn_name]
    try:
        result = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_world(fn_name: str, world: int, tmp_path, *args,
              timeout: float = 120.0):
    """Run ``fn_name(rank, world, *args)`` on ``world`` spawned ranks and
    return the list of their results (rank order).  ``fn_name`` names a
    function of this module, or ``"module:function"`` one of another
    module of ``tests/`` (which must import no JAX)."""
    out_dir = str(tmp_path)
    init_file = os.path.join(out_dir, "store")
    ctx = mp.start_processes(_entry, nprocs=world, join=False,
                             start_method="spawn",
                             args=(fn_name, world, init_file, out_dir, args))
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):  # raises if a rank failed
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn_name} did not finish in {timeout}s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        assert not any(p.is_alive() for p in ctx.processes)
    results = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


# ---------------------------------------------------------------------------
# Rank functions
# ---------------------------------------------------------------------------


def rank_tree(rank, shapes):
    """Rank ``rank``'s tree of leaves ``(name, shape, dtype)``, drawn from
    a numpy seed of the rank."""
    from collections import OrderedDict

    rng = np.random.RandomState(rank)
    return OrderedDict(
        (n, torch.from_numpy(np.asarray(rng.randn(*s) * 100, np.float32))
         .to(getattr(torch, dt)))
        for n, s, dt in shapes)


def collectives_case(rank, world, shapes, bucket_bytes):
    """Bucketed (or per-leaf) psum, pmean and allgather of `rank_tree`
    (the sums over its float32 leaves); returns the results as numpy."""
    from pytorch_ps_mpi_tpu_torch.parallel import collectives as C

    def f32():
        return {n: t for n, t in rank_tree(rank, shapes).items()
                if t.dtype == torch.float32}

    summed = C.psum_tree_bucketed(f32(), bucket_bytes=bucket_bytes)
    gathered = C.allgather_tree_bucketed(rank_tree(rank, shapes),
                                         bucket_bytes=bucket_bytes)
    means = C.pmean_tree(f32(), bucket_bytes=bucket_bytes)

    def np_(t):
        return {n: v.to(torch.float32).numpy() for n, v in t.items()}

    return {"psum": np_(summed), "allgather": np_(gathered),
            "pmean": np_(means)}


def decomposed_case(rank, world, shapes):
    """`psum_tree_bucketed(decompose=True)` of `rank_tree`'s float32 leaves,
    per leaf and in 4,096-byte buckets, and the leaves it was given
    afterwards (a reduce-scatter + all-gather writes no leaf)."""
    from pytorch_ps_mpi_tpu_torch.parallel import collectives as C

    out = {}
    for bucket_bytes in (None, 4096):
        tree = {n: t for n, t in rank_tree(rank, shapes).items()
                if t.dtype == torch.float32}
        summed = C.psum_tree_bucketed(tree, bucket_bytes=bucket_bytes,
                                      decompose=True)
        out[bucket_bytes] = {"psum": {n: v.numpy() for n, v in summed.items()},
                             "input": {n: v.numpy() for n, v in tree.items()}}
    return out


def icollectives_case(rank, world, payloads):
    """The nonblocking collectives of `parallel.collectives` on this
    rank's payload tree (``payloads[rank]``, numpy); each op's result as
    numpy (None where the rank holds none) and its timings' keys."""
    from pytorch_ps_mpi_tpu_torch.parallel import collectives as C
    from pytorch_ps_mpi_tpu_torch.utils.flatten import tree_map

    mine = tree_map(torch.from_numpy, payloads[rank])
    a2a = {"x": torch.from_numpy(payloads[rank]["a2a"])}
    mine = {k: v for k, v in mine.items() if k != "a2a"}
    ops = {
        "iallgather": lambda: C.iallgather(mine),
        "igather": lambda: C.igather(mine, root=1),
        "igather_root_only": lambda: C.igather(mine, root=1,
                                               root_only=True),
        "ibroadcast": lambda: C.ibroadcast(mine, root=1),
        "ialltoall": lambda: C.ialltoall(a2a),
        "ireduce": lambda: C.ireduce({"w": mine["w"]}),
    }
    out = {}
    for name, post in ops.items():
        pending = post()
        first = pending.wait()
        pending.wait()  # a second wait records nothing new
        out[name] = {
            "result": None if first is None else tree_map(
                lambda t: t.numpy().copy(), first),
            "timings": sorted(pending.timings),
            "msg_bytes": pending.timings["msg_bytes"]}
    out["input_after"] = tree_map(lambda t: t.numpy().copy(), mine)
    return out


def ps_trajectory(rank, world, kind, named, aux, batches, code, lr,
                  momentum):
    """A few SGD steps of the port's MPI_PS on ``kind`` ('resnet11': the
    ResNet((1, 1)) of the tests, or 'mlp'), from the given params and aux.
    Returns the losses, metrics and final params/aux as numpy."""
    from pytorch_ps_mpi_tpu_torch import SGD
    from pytorch_ps_mpi_tpu_torch import models

    opt = SGD(list(named.items()), lr=lr, momentum=momentum, code=code,
              device="cpu")
    if kind == "mlp":
        opt.compile_step(models.mlp_loss_fn)
    else:
        model = models.ResNet((1, 1), num_classes=10)
        loss_fn, has_aux = models.make_classifier_loss(model)
        opt.compile_step(loss_fn, has_aux=has_aux, aux=aux)
    losses, metrics = [], []
    for b in batches:
        loss, m = opt.step(b)
        losses.append(loss)
        metrics.append(m)
    return {"losses": losses, "metrics": metrics,
            "params": {n: p.numpy() for n, p in opt.params.items()},
            "aux": {n: a.numpy() for n, a in opt.aux.items()}}


def scaled_bucket(rank, shapes, seed):
    """A bucket of float32 leaves ``g{i}`` of ``shapes``, drawn from a numpy
    seed and scaled by ``rank + 1`` — the JAX overlap tests' rank-distinct
    cotangents."""
    from collections import OrderedDict

    rng = np.random.RandomState(seed)
    return OrderedDict(
        (f"g{i}", torch.from_numpy(rng.randn(*s).astype(np.float32))
         * (rank + 1)) for i, s in enumerate(shapes))


def overlap_sync_case(rank, world, buckets):
    """The overlap engine's bucket syncs on `scaled_bucket` cotangents: the
    identity sync with both reducers, the fused blockq sync (8- and 16-bit
    codes) and the per-leaf codec sync (blockq, bf16), for each ``(shapes,
    seed)`` of ``buckets``; results as numpy."""
    from pytorch_ps_mpi_tpu_torch.ops.codecs import (BlockQuantizeCodec,
                                                     get_codec)
    from pytorch_ps_mpi_tpu_torch.parallel import overlap as OV

    out = {}
    for key, (shapes, seed) in buckets.items():
        cot = scaled_bucket(rank, shapes, seed)
        res = {r: OV._sync_identity(cot, None, world, r)
               for r in ("rs_ag", "psum")}
        for bits in (8, 16):
            res[f"fused{bits}"] = OV._sync_blockq_fused(
                cot, None, BlockQuantizeCodec(bits=bits))
        for code in ("blockq", "bf16"):
            res[f"codec_{code}"] = OV._sync_codec(cot, None, get_codec(code))
        out[key] = {k: {n: v.numpy() for n, v in d.items()}
                    for k, d in res.items()}
    return out


def _mlp_with_unused(dims):
    """MLP params of ``dims`` as tensors, plus two leaves outside the
    loss: ``unused`` (float32, packed into a bucket with used leaves) and
    ``unused_bf16`` (a bucket of its own)."""
    from collections import OrderedDict

    from pytorch_ps_mpi_tpu_torch.models import init_mlp

    params = OrderedDict((n, torch.from_numpy(p)) for n, p in
                         init_mlp(np.random.RandomState(0), dims).items())
    params["unused"] = torch.ones(3)
    params["unused_bf16"] = torch.ones(5, dtype=torch.bfloat16)
    return params


def overlap_hooks_case(rank, world, batch, bucket_bytes):
    """`BucketHooks` on the MLP of `_mlp_with_unused`: how many buckets had
    started when the first layer's activation gradient was computed, the
    summed gradients against an all-reduce of the raw ones, `wrap_loss`'s
    gradients against the same, and an overlap SGD step over the params
    (the unused ones must come back unchanged)."""
    from collections import OrderedDict

    import torch.distributed as dist
    import torch.nn.functional as F

    from pytorch_ps_mpi_tpu_torch import SGD
    from pytorch_ps_mpi_tpu_torch.models import mlp_loss_fn
    from pytorch_ps_mpi_tpu_torch.parallel import overlap as OV

    params = _mlp_with_unused((16, 32, 32, 4))
    per = batch["x"].shape[0] // world
    mine = {k: torch.from_numpy(v[rank * per:(rank + 1) * per])
            for k, v in batch.items()}
    leaves = OrderedDict((n, p.clone().requires_grad_())
                         for n, p in params.items())
    plan = OV.plan_overlap(leaves, bucket_bytes, world=world, record=False)
    sync = OV.make_bucket_sync_fn(group=None, world=world)
    hooks = OV.BucketHooks(leaves, plan, sync)
    started = []

    def loss_fn(p, b):
        h = b["x"] @ p["dense0/kernel"] + p["dense0/bias"]
        h.register_hook(lambda g: started.append(len(hooks.pending)))
        for i in (1, 2):
            h = F.relu(h) @ p[f"dense{i}/kernel"] + p[f"dense{i}/bias"]
        logp = F.log_softmax(h, dim=-1)
        return -logp.gather(-1, b["y"].long()[:, None]).mean()

    raw = torch.autograd.grad(loss_fn(leaves, mine), list(leaves.values()),
                              allow_unused=True)
    summed = hooks.finish()
    ref = OrderedDict()
    for (n, x), g in zip(leaves.items(), raw):
        g = torch.zeros_like(x) if g is None else g.clone()
        dist.all_reduce(g)
        ref[n] = g
    wrapped_leaves = OrderedDict((n, p.clone().requires_grad_())
                                 for n, p in params.items())
    wrapped = OV.wrap_loss(mlp_loss_fn, plan, sync)
    # A bucket none of whose leaves reach the loss never runs its
    # backward: its gradient is materialized as zeros.
    via_wrap = torch.autograd.grad(wrapped(wrapped_leaves, mine),
                                   list(wrapped_leaves.values()),
                                   allow_unused=True, materialize_grads=True)

    opt = SGD(list(params.items()), lr=0.1, momentum=0.9, device="cpu",
              sync_mode="overlap", bucket_mb=bucket_bytes / (1 << 20))
    opt.compile_step(mlp_loss_fn)
    opt.step(batch)

    def np_(t):
        return t.to(torch.float32).numpy()

    return {"started": started, "buckets": plan.buckets,
            "summed": {n: np_(g) for n, g in summed.items()},
            "ref": {n: np_(g) for n, g in ref.items()},
            "wrap": {n: np_(g) for n, g in zip(params, via_wrap)},
            "stepped": {n: np_(p) for n, p in opt.params.items()},
            "params": {n: np_(p) for n, p in params.items()}}


def overlap_trajectories(rank, world, named, variants, batches):
    """A few steps of the port's MPI_PS on the MLP for each variant
    ``name -> (optimizer, kwargs, batch list key)``; returns each run's
    losses, metrics, fault_stats and final params as numpy."""
    from pytorch_ps_mpi_tpu_torch import SGD, Adam
    from pytorch_ps_mpi_tpu_torch.models import mlp_loss_fn

    out = {}
    for name, (optim, kw, key) in variants.items():
        cls = {"sgd": SGD, "adam": Adam}[optim]
        opt = cls(list(named.items()), device="cpu", **kw)
        opt.compile_step(mlp_loss_fn)
        losses, metrics = [], []
        for b in batches[key]:
            loss, m = opt.step(b)
            losses.append(loss)
            metrics.append(m)
        out[name] = {"losses": losses, "metrics": metrics,
                     "fault_stats": dict(opt.fault_stats),
                     "params": {n: p.numpy() for n, p in opt.params.items()}}
    return out


# ---------------------------------------------------------------------------
# The step's features: one spec, several runs a spawn
# ---------------------------------------------------------------------------


def build_codec(module, spec):
    """A codec of ``module`` (either package's ``ops.codecs``) from a spec:
    None, a name, or ``(class name, kwargs)``."""
    if spec is None or isinstance(spec, str):
        return module.get_codec(spec)
    cls, kw = spec
    return getattr(module, cls)(**kw)


def build_schedule(module, spec):
    """An lr schedule of ``module`` (either package's
    ``optim.schedules``) from ``(name, args, kwargs)``; a float passes."""
    if not isinstance(spec, tuple):
        return spec
    name, args, kw = spec
    return getattr(module, name)(*args, **kw)


def port_optimizer(spec, device="cpu"):
    """The port's optimizer for a run spec (see `ps_runs`), compiled."""
    from pytorch_ps_mpi_tpu_torch import SGD, Adam, AdamW, models
    from pytorch_ps_mpi_tpu_torch.ops import codecs
    from pytorch_ps_mpi_tpu_torch.optim import schedules

    cls = {"sgd": SGD, "adam": Adam, "adamw": AdamW}[spec.get("optim", "sgd")]
    hyper = dict(spec.get("hyper", dict(lr=0.1, momentum=0.9)))
    hyper["lr"] = build_schedule(schedules, hyper["lr"])
    kw = dict(spec.get("kwargs", {}))
    kw["code"] = build_codec(codecs, kw.get("code"))
    opt = cls(list(spec["named"].items()), device=device, **hyper, **kw)
    if spec["kind"] == "mlp":
        opt.compile_step(models.mlp_loss_fn, **spec.get("compile", {}))
    else:
        model = models.ResNet((1, 1), num_classes=10)
        loss_fn, has_aux = models.make_classifier_loss(model)
        opt.compile_step(loss_fn, has_aux=has_aux, aux=spec.get("aux"),
                         **spec.get("compile", {}))
    return opt


def _flip_bit(opt, name):
    """Flip the top mantissa bit of element 0 of parameter ``name`` on
    this rank only (silent data corruption of one replica)."""
    p = opt.params[name].clone()
    bits = p.view(-1).view(torch.int32)
    bits[0] = bits[0] ^ (1 << 22)
    opt.params[name] = p


def run_spec(spec, rank=0, device="cpu"):
    """One run of a spec on this process's group: optionally load
    ``spec["load"]`` (a state dict), take ``len(batches)`` steps, with
    ``spec["save_after"]`` steps' state dict kept, ``spec["corrupt"] =
    (step, rank, name)`` flipping a bit of one replica after that step
    and ``spec["check"]`` running `check_consensus` after the last step
    (an `SDCDetectedError` is recorded, not raised); ``raw_shards`` is
    passed to the kept state dict.  Returns numpy."""
    from pytorch_ps_mpi_tpu_torch import SDCDetectedError

    opt = port_optimizer(spec, device)
    if spec.get("load") is not None:
        opt.load_state_dict(spec["load"])
    out = {"losses": [], "metrics": [], "saved": None, "sdc": None}
    for i, b in enumerate(spec["batches"]):
        loss, m = opt.step(b)
        out["losses"].append(loss)
        out["metrics"].append(m)
        if spec.get("save_after") == i + 1:
            out["saved"] = opt.state_dict(
                raw_shards=spec.get("raw_shards", False))
        corrupt = spec.get("corrupt")
        if corrupt is not None and corrupt[0] == i + 1 and corrupt[1] == rank:
            _flip_bit(opt, corrupt[2])
    if spec.get("check"):
        try:
            out["check"] = opt.check_consensus()
        except SDCDetectedError as e:
            out["sdc"] = str(e)
    out["state_dict"] = opt.state_dict()
    out["fault_stats"] = dict(opt.fault_stats)
    ef = opt.ef_state
    out["ef"] = (None if ef is None else
                 {n: v.float().numpy() for n, v in ef.items()})
    return out


def ps_runs(rank, world, specs):
    """`run_spec` for each spec of ``specs`` (name -> spec), in order."""
    return {name: run_spec(spec, rank) for name, spec in specs.items()}


def cli_runs(rank, world, runs):
    """The port's training CLI in-process on this rank, once per argv of
    ``runs`` (name -> argv), in order; a run that exits records its exit
    code.  Returns, per run, the final params (numpy), the fault stats'
    SDC counters and rollbacks, and the exit code (None for a finished
    run)."""
    from pytorch_ps_mpi_tpu_torch import train

    out = {}
    for name, argv in runs.items():
        try:
            opt = train.main(list(argv))
        except SystemExit as e:
            out[name] = {"exit": e.code}
            continue
        fs = opt.fault_stats
        out[name] = {
            "exit": None,
            "params": {n: p.float().numpy() for n, p in opt.params.items()},
            "fault_stats": {k: fs[k] for k in (
                "sdc_checks", "sdc_mismatches", "sdc_rebroadcasts",
                "sdc_first_leaf", "sdc_events", "rollbacks")}}
    return out
