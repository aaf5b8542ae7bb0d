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
    try:
        result = globals()[fn_name](rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_world(fn_name: str, world: int, tmp_path, *args,
              timeout: float = 120.0):
    """Run ``fn_name(rank, world, *args)`` on ``world`` spawned ranks and
    return the list of their results (rank order)."""
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
