"""The system under test: the port's public sync step, built for a cell.

``SGD(named_params, lr, momentum, code=...)``, ``compile_step(loss_fn)``
and ``step(global_batch, block=False)``: `MPI_PS.step` with the traffic's
codec and sync mode, as a user of the port's API gets it.  The model and
its loss are the family's (``families/<model>.py``), built from the port's
``models`` package on the ``meta`` device (the weights are the
benchmark's, from the seed).  This module and the families are the only
ones of the benchmark that import the port.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from . import spec


def build_model(config: dict):
    """The port's module for ``config``, with no storage: ``(module,
    parameter shapes, buffer shapes)``."""
    family = spec.family(config["model"])
    dtype = getattr(torch, config["compute_dtype"])
    with torch.device("meta"):
        module = family.build(config, dtype)
    shapes = OrderedDict((n, tuple(p.shape))
                         for n, p in module.named_parameters())
    buffers = OrderedDict((n, tuple(b.shape))
                          for n, b in module.named_buffers())
    return module, shapes, buffers


def make_optimizer(module, config: dict, traffic: dict, named, aux, device,
                   group):
    """The port's optimizer over ``named`` with the family's loss bound."""
    from pytorch_ps_mpi_tpu_torch import SGD

    opt = SGD(list(named.items()), lr=traffic["lr"],
              momentum=traffic["momentum"], code=traffic["code"],
              sync_mode=traffic["sync_mode"],
              bucket_mb=traffic["bucket_mb"], device=device, group=group)
    if getattr(opt.code, "bits", traffic["bits"]) != traffic["bits"]:
        raise ValueError(f"the {traffic['code']} codec codes in "
                         f"{opt.code.bits} bits, the traffic asks for "
                         f"{traffic['bits']}")
    spec.family(config["model"]).bind_loss(opt, module, aux)
    return opt


def join(device, rank: int, world: int, init_file: "str | None"):
    """The PS process group of ``world`` ranks (NCCL on cards)."""
    from pytorch_ps_mpi_tpu_torch import make_ps_group

    return make_ps_group(device, rank=rank, world_size=world,
                         init_file=init_file)
