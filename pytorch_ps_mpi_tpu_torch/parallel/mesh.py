"""Process groups and the named mesh — the port's stand-in for the JAX
device mesh.

Counterpart of `pytorch_ps_mpi_tpu/parallel/mesh.py`.  The JAX package's
world is a `jax.sharding.Mesh` of devices with named axes, and a step runs
inside ``shard_map``, where ``lax.axis_index``/``lax.psum`` name an axis.
Here each process is one device, so one coordinate of the mesh: `Mesh`
lays the world's ranks out row-major over the axes (as ``jax.make_mesh``
lays out ``devices[:n]``, so the same global rank holds the same
coordinate in both packages) and makes one ``torch.distributed`` process
group for every axis and every tuple of axes, in the mesh's order: NCCL on
the card, gloo on the CPU.  A tuple of axes is one group, ranked row-major
over the tuple.

``with mesh:`` makes a mesh current, the port's
``shard_map``: `axis_index`, `axis_size` and `axis_group` resolve an axis
name against it, and raise, as JAX does for an unbound axis, when no mesh
is current or it has no such axis — a path never runs dense because an
axis it names is missing.  `MPI_PS` makes its mesh current around the
loss and its backward.

Rendezvous goes through a ``file://`` store, so parallel test runs never
compete for a TCP port; `join_world` joins the group ``torchrun``
describes in the environment instead (the training CLI's world), or makes
a world of one.  The mesh constructors take the world that is joined, or
make it for a world of one.

``torch.distributed.device_mesh.DeviceMesh`` is not used: it has no
public group for a tuple of dimensions (the data axes ``("ps", "ep")``
and the extra axes ``("sp", "tp")`` each need one), and the port needs
nothing else of it.
"""

from __future__ import annotations

import itertools
import math
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..errors import PSRuntimeError

# Canonical axis name for the data-parallel PS "world" axis.
PS_AXIS = "ps"
DCN_AXIS = "dcn"


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


def rank(group=None) -> int:
    return dist.get_rank(group)


# ---------------------------------------------------------------------------
# The named mesh
# ---------------------------------------------------------------------------


def as_axes(axis) -> tuple:
    """An axis name or a tuple of them, as a tuple."""
    return (axis,) if isinstance(axis, str) else tuple(axis)


class Mesh:
    """A named mesh over ranks of the world: ``shape`` maps each axis name
    (in order) to its size, and ``ranks[i]`` holds the row-major
    coordinate ``i``.  Every rank of the world must build it (the groups
    are made collectively); a rank outside ``ranks`` holds no coordinate.

    ``device`` is this rank's device; its type picks the groups' backend
    (NCCL for ``cuda``, gloo for ``cpu``)."""

    def __init__(self, axis_names, sizes, ranks, device):
        self.axis_names = tuple(axis_names)
        sizes = tuple(int(s) for s in sizes)
        self.shape = dict(zip(self.axis_names, sizes))
        self.size = math.prod(sizes)
        self.ranks = list(ranks)
        if len(self.ranks) != self.size:
            raise ValueError(f"a mesh of shape {self.shape} needs "
                             f"{self.size} ranks, got {len(self.ranks)}")
        if any(b <= a for a, b in zip(self.ranks, self.ranks[1:])):
            raise ValueError(f"mesh ranks must increase, got {self.ranks}")
        self.device = resolve_device(device)
        self.platform = "gpu" if self.device.type == "cuda" else "cpu"
        backend = "nccl" if self.device.type == "cuda" else "gloo"
        me = dist.get_rank()
        self.coords = None
        if me in self.ranks:
            coord = np.unravel_index(self.ranks.index(me), sizes)
            self.coords = dict(zip(self.axis_names, map(int, coord)))
        # One group for every non-empty subset of the axes, in the mesh's
        # order: the ranks that share the coordinates of the other axes,
        # row-major over the subset (a row of the grid with the subset's
        # axes moved last).  `new_group` is collective over the world, so
        # every rank makes every group, in the same order.
        self._groups = {}
        grid = np.asarray(self.ranks).reshape(sizes)
        n = len(sizes)
        for k in range(1, n + 1):
            for subset in itertools.combinations(range(n), k):
                others = [a for a in range(n) if a not in subset]
                rows = np.transpose(grid, others + list(subset)).reshape(
                    -1, math.prod(sizes[a] for a in subset))
                for row in rows.tolist():
                    group = dist.new_group(row, backend=backend)
                    if me in row:
                        key = tuple(self.axis_names[a] for a in subset)
                        self._groups[key] = group

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, ranks={self.ranks}, "
                f"platform={self.platform!r})")

    # -- one axis or a tuple of axes ------------------------------------------

    def _key(self, axis) -> tuple:
        axes = as_axes(axis)
        for a in axes:
            if a not in self.axis_names:
                raise NameError(f"unbound axis name: {a} (the mesh's axes "
                                f"are {self.axis_names})")
        order = [self.axis_names.index(a) for a in axes]
        if order != sorted(set(order)):
            raise ValueError(f"axes {axes} must name distinct axes in the "
                             f"mesh's order {self.axis_names}")
        if self.coords is None:
            raise PSRuntimeError(f"rank {dist.get_rank()} holds no "
                                 f"coordinate of {self!r}")
        return axes

    def axis_size(self, axis) -> int:
        """The number of ranks along ``axis`` (a name or a tuple)."""
        return math.prod(self.shape[a] for a in self._key(axis))

    def axis_index(self, axis) -> int:
        """This rank's index along ``axis``: row-major over a tuple."""
        idx = 0
        for a in self._key(axis):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axis):
        """The process group of ``axis`` that holds this rank; its group
        ranks equal `axis_index`."""
        return self._groups[self._key(axis)]

    # -- the current mesh ------------------------------------------------------

    def __enter__(self):
        _CURRENT.append(self)
        return self

    def __exit__(self, *exc):
        _CURRENT.pop()


# The current meshes, innermost last.  Process-wide, not per thread: the
# autograd engine runs a CUDA backward (and a remat's recomputation, which
# resolves axes again) on threads of its own.
_CURRENT: list = []


def current_mesh() -> "Mesh | None":
    return _CURRENT[-1] if _CURRENT else None


def _current(axis) -> Mesh:
    mesh = current_mesh()
    if mesh is None:
        raise NameError(f"unbound axis name: {axis} (no mesh is current: "
                        f"run under `with mesh:` or MPI_PS(mesh=...))")
    return mesh


def axis_index(axis) -> int:
    """``lax.axis_index``: this rank's index along ``axis`` of the current
    mesh."""
    return _current(axis).axis_index(axis)


def axis_size(axis) -> int:
    """``lax.axis_size`` over the current mesh."""
    return _current(axis).axis_size(axis)


def axis_group(axis):
    """The current mesh's process group of ``axis`` (a name or a tuple);
    a process group passes as it is (None: the default group)."""
    if axis is None or not isinstance(axis, (str, tuple, list)):
        return axis
    return _current(axis).group(axis)


# ---------------------------------------------------------------------------
# The JAX package's mesh constructors, over the joined world
# ---------------------------------------------------------------------------


def _world(devices, device):
    """``(ranks, device)``: the ranks a mesh constructor lays out (``devices``, or
    the whole world) and this rank's device.  ``device=None`` follows the
    joined world's backend (NCCL: the card; gloo: the CPU), or the card
    when no world is joined, which is then made for one process."""
    if device is None:
        if dist.is_initialized():
            device = ("cuda" if dist.get_backend() == "nccl" else "cpu")
        else:
            device = "cuda"
    device = resolve_device(device)
    join_world(device)
    if devices is None:
        devices = list(range(dist.get_world_size()))
    return list(devices), device


def make_ps_mesh(n_devices: int | None = None, *, axis: str = PS_AXIS,
                 devices=None, device=None) -> Mesh:
    """A 1-D mesh over ``n_devices`` ranks with a single PS axis — the
    ``mpirun -n N`` analogue.  Defaults to the whole world.  ``devices``
    are global ranks (default: the world's)."""
    devices, device = _world(devices, device)
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(
            f"requested {n_devices} devices but only {len(devices)} visible")
    return Mesh((axis,), (n_devices,), devices[:n_devices], device)


def _make_dp_x_mesh(axis2: str, dp: int | None, k: int, devices,
                    device) -> Mesh:
    """Shared constructor of the 2-D ``(ps, <axis2>)`` meshes: validate the
    inner degree, default ``dp`` to whatever fills the world, and
    range-check the product."""
    devices, device = _world(devices, device)
    if k < 1:
        raise ValueError(f"{axis2} must be >= 1, got {k}")
    if dp is None:
        dp = len(devices) // k
    n = dp * k
    if n > len(devices) or n < 1:
        raise ValueError(
            f"dp*{axis2} = {dp}*{k} = {n} needs {n} devices, "
            f"have {len(devices)}")
    return Mesh((PS_AXIS, axis2), (dp, k), devices[:n], device)


def make_dp_sp_mesh(dp: int | None = None, sp: int = 1, *, devices=None,
                    device=None) -> Mesh:
    """2-D ``(ps, sp)`` mesh: data × sequence parallelism (ring or Ulysses
    attention over ``sp``; pass ``batch_spec=("ps", "sp")`` to `MPI_PS`).
    ``dp`` defaults to ``world // sp``."""
    return _make_dp_x_mesh("sp", dp, sp, devices, device)


def make_dp_tp_mesh(dp: int | None = None, tp: int = 1, *, devices=None,
                    device=None) -> Mesh:
    """2-D ``(ps, tp)`` mesh: data × tensor parallelism.  Gradients sum
    over ``ps`` only (the `MPI_PS` defaults); tp is an extra, averaged
    axis."""
    return _make_dp_x_mesh("tp", dp, tp, devices, device)


def make_dp_ep_mesh(dp: int | None = None, ep: int = 1, *, devices=None,
                    device=None) -> Mesh:
    """2-D ``(ps, ep)`` mesh: data × expert parallelism.  Both axes are
    data axes: pass ``axis=("ps", "ep")`` and ``batch_spec=(("ps",
    "ep"),)`` to `MPI_PS`."""
    return _make_dp_x_mesh("ep", dp, ep, devices, device)


def make_dp_pp_mesh(dp: int | None = None, pp: int = 1, *, devices=None,
                    device=None) -> Mesh:
    """2-D ``(ps, pp)`` mesh: data × pipeline parallelism (a model axis:
    gradients sum over ``ps`` only)."""
    return _make_dp_x_mesh("pp", dp, pp, devices, device)


def make_dp_sp_tp_mesh(dp: int, sp: int, tp: int, *, devices=None,
                       device=None) -> Mesh:
    """3-D ``(ps, sp, tp)`` mesh: batch over (ps, sp), heads/MLP over tp;
    gradient sum over ps, mean over sp and tp."""
    devices, device = _world(devices, device)
    n = dp * sp * tp
    if n > len(devices) or min(dp, sp, tp) < 1:
        raise ValueError(
            f"dp*sp*tp = {dp}*{sp}*{tp} = {n} needs {n} devices, "
            f"have {len(devices)}")
    return Mesh((PS_AXIS, "sp", "tp"), (dp, sp, tp), devices[:n], device)


def make_dp_pp_tp_mesh(dp: int, pp: int, tp: int, *, devices=None,
                       device=None) -> Mesh:
    """3-D ``(ps, pp, tp)`` mesh: batch over ps, depth over the pp ring,
    heads/MLP over tp."""
    devices, device = _world(devices, device)
    n = dp * pp * tp
    if n > len(devices) or min(dp, pp, tp) < 1:
        raise ValueError(
            f"dp*pp*tp = {dp}*{pp}*{tp} needs at least "
            f"{max(n, pp * tp)} devices, have {len(devices)}")
    return Mesh((PS_AXIS, "pp", "tp"), (dp, pp, tp), devices[:n], device)


def make_hybrid_mesh(slices: int | None = None, *, axis: str = PS_AXIS,
                     devices=None, device=None) -> Mesh:
    """2-D ``(dcn, ps)`` mesh for multi-host data parallelism: the inner
    ``ps`` axis spans the ranks of one host, the outer ``dcn`` axis spans
    hosts.  Pass ``axis=("dcn", "ps")`` to `MPI_PS` so the gradient sum
    covers both.  ``slices`` defaults to the number of hosts ``torchrun``
    launched (``WORLD_SIZE / LOCAL_WORLD_SIZE``), else 1."""
    devices, device = _world(devices, device)
    if slices is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", 0) or 0)
        slices = max(1, dist.get_world_size() // local) if local else 1
    n = len(devices)
    if n % slices != 0:
        raise ValueError(f"{n} devices do not split into {slices} slices")
    return Mesh((DCN_AXIS, axis), (slices, n // slices), devices, device)


def describe_mesh(mesh: Mesh) -> dict:
    """JSON-able topology fingerprint: axis names, per-axis sizes, device
    count and platform (``"gpu"`` or ``"cpu"``) — recorded into checkpoint
    metadata as the SOURCE topology for elastic N→M resume."""
    return {"axis_names": list(mesh.axis_names),
            "shape": {a: int(mesh.shape[a]) for a in mesh.axis_names},
            "n_devices": int(mesh.size),
            "platform": mesh.platform}


def world_size(mesh=None, axis: str = PS_AXIS) -> int:
    """The number of PS ranks — ``comm.Get_size()``: ``mesh.shape[axis]``
    of a `Mesh`, or the size of a process group (None: the default)."""
    if isinstance(mesh, Mesh):
        return mesh.shape[axis]
    return dist.get_world_size(mesh)
