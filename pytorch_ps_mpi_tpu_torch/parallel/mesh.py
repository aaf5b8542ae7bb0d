"""Process groups — the port's stand-in for the JAX device mesh.

Counterpart of `pytorch_ps_mpi_tpu/parallel/mesh.py`.  The JAX package's
world is a `jax.sharding.Mesh` with one ``'ps'`` axis; here it is a
``torch.distributed`` process group with one rank per device: NCCL on the
card, gloo on the CPU.  Rendezvous goes through a ``file://`` store, so
parallel test runs never compete for a TCP port; `join_world` joins the
group ``torchrun`` describes in the environment instead (the training
CLI's world), or makes a world of one.
"""

from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist

from ..errors import PSRuntimeError


def resolve_device(device) -> torch.device:
    """``device`` as a `torch.device`; a CUDA device with no card visible
    raises instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise PSRuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "visible; pass device='cpu' to run on the CPU")
    return dev


def record_event(device: torch.device):
    """An event recorded on ``device``'s current stream (None off the
    card)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def make_ps_group(device="cuda", *, rank: int = 0, world_size: int = 1,
                  init_file: str | None = None):
    """Join (or create) the PS process group — the ``mpirun -n N``
    analogue.  Every rank calls it with the same ``init_file`` and
    ``world_size``; NCCL is used for CUDA devices (rank ``r`` drives card
    ``r`` unless ``device`` names one), gloo for the CPU.  With
    ``init_file=None`` a fresh store file is made, which only a world of
    one can share.  Returns the default group; if one exists already, it
    is returned as it is."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return dist.group.WORLD
    if init_file is None:
        if world_size != 1:
            raise ValueError("a world of more than one rank needs a shared "
                             "init_file")
        init_file = os.path.join(tempfile.mkdtemp(prefix="ps_group_"),
                                 "store")
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None else rank)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world_size)
    return dist.group.WORLD


def join_world(device="cuda"):
    """The training CLI's world — the port's counterpart of "the mesh is
    the world".  Under ``torchrun`` (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``/``MASTER_PORT`` and ``LOCAL_RANK`` set) every process
    joins that group: NCCL with rank ``r`` on card ``LOCAL_RANK``, or gloo
    on the CPU.  Without them it is a world of one (`make_ps_group`).  An
    existing default group is returned as it is."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return dist.group.WORLD
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return make_ps_group(dev)
    rank_, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank_))
        torch.cuda.set_device(dev.index if dev.index is not None else local)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://", rank=rank_,
                            world_size=world)
    return dist.group.WORLD


def world_size(group=None) -> int:
    return dist.get_world_size(group)


def rank(group=None) -> int:
    return dist.get_rank(group)
