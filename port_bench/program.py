"""The system under test: the port's public sync step, built for a cell.

``SGD(named_params, lr, momentum, code=...)``, ``compile_step(loss_fn)``
and ``step(global_batch, block=False)``: `MPI_PS.step` with the traffic's
codec and sync mode, as a user of the port's API gets it.  The models come
from the port's ``models`` package, built on the ``meta`` device (the
weights are the benchmark's, from the seed); the loss functions are the
port's own.  This is the only module of the benchmark that imports the
port.
"""

from __future__ import annotations

import functools
from collections import OrderedDict

import torch


def build_model(config: dict):
    """The port's module for ``config``, with no storage: ``(module,
    parameter shapes, buffer shapes)``."""
    from pytorch_ps_mpi_tpu_torch import flash_attention
    from pytorch_ps_mpi_tpu_torch.models import TransformerLM, resnet18

    dtype = getattr(torch, config["compute_dtype"])
    with torch.device("meta"):
        if config["model"] == "lm":
            module = TransformerLM(
                config["vocab_size"], d_model=config["d_model"],
                n_heads=config["n_heads"], n_layers=config["n_layers"],
                d_ff=config["d_ff"], max_len=config["max_len"], dtype=dtype,
                attn=functools.partial(flash_attention, causal=True))
        elif config["model"] == "resnet18":
            module = resnet18(num_classes=config["num_classes"],
                              small_inputs=config["small_inputs"],
                              dtype=dtype)
        else:
            raise ValueError(f"no model {config['model']!r} in the port")
    shapes = OrderedDict((n, tuple(p.shape))
                         for n, p in module.named_parameters())
    buffers = OrderedDict((n, tuple(b.shape))
                          for n, b in module.named_buffers())
    return module, shapes, buffers


def make_optimizer(module, config: dict, traffic: dict, named, aux, device,
                   group):
    """The port's optimizer over ``named`` with its loss bound."""
    from pytorch_ps_mpi_tpu_torch import SGD
    from pytorch_ps_mpi_tpu_torch.models import (make_classifier_loss,
                                                 make_lm_loss)

    opt = SGD(list(named.items()), lr=traffic["lr"],
              momentum=traffic["momentum"], code=traffic["code"],
              sync_mode=traffic["sync_mode"],
              bucket_mb=traffic["bucket_mb"], device=device, group=group)
    if getattr(opt.code, "bits", traffic["bits"]) != traffic["bits"]:
        raise ValueError(f"the {traffic['code']} codec codes in "
                         f"{opt.code.bits} bits, the traffic asks for "
                         f"{traffic['bits']}")
    if config["model"] == "lm":
        opt.compile_step(make_lm_loss(module))
    else:
        loss_fn, has_aux = make_classifier_loss(module, has_aux=True)
        opt.compile_step(loss_fn, has_aux=has_aux, aux=aux)
    return opt


def join(device, rank: int, world: int, init_file: "str | None"):
    """The PS process group of ``world`` ranks (NCCL on cards)."""
    from pytorch_ps_mpi_tpu_torch import make_ps_group

    return make_ps_group(device, rank=rank, world_size=world,
                         init_file=init_file)

