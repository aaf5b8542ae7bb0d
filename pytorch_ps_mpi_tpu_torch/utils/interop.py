"""Weights, statistics and optimizer state across from the JAX package.

Counterpart of `pytorch_ps_mpi_tpu/utils/interop.py`, in the other
direction: `params_from_jax` turns the flat flax names and arrays that the
JAX package's ``build_model`` gives into the port's ``named_parameters()``
and BatchNorm buffers, undoing its layout rules:

* flax conv kernels ``HWIO`` -> torch ``OIHW``;
* flax ``Dense`` kernels ``(in, out)`` -> torch ``(out, in)``;
* ``kernel``, BatchNorm/LayerNorm ``scale`` and ``Embed``'s
  ``embedding`` -> ``weight`` (an embedding table keeps ``(num, features)``);
* ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``;
* the MoE layer's ``router``, ``w1``, ``b1``, ``w2`` and ``b2`` keep their
  names and expert-major layouts.

It serves flax module trees (the ResNets and the transformer LM).  The
MLP's plain dict keeps ``(in, out)`` in both packages and crosses
unchanged.

`jax_order` gives, per port leaf, the permutation back to flax's layout:
a codec whose wire depends on element order (blockq's tiles, topk's
indices) encodes the gradient in that order, so the wire equals the JAX
package's.  `state_from_jax` and `state_to_jax` carry a whole
``MPI_PS.state_dict()`` across, in either direction.
"""

from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np
import torch

from .flatten import SEP, named_params

_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
         "bias": "bias", "mean": "running_mean", "var": "running_var"}
# The MoE layer's raw parameters keep their flax names and expert-major
# layouts in both packages.
_MOE_LEAVES = ("router", "w1", "b1", "w2", "b2")
_LEAF.update({n: n for n in _MOE_LEAVES})

# The port's names of the flax kernels, by rank: conv kernels of the
# ResNets, the ResNets' Dense head and the LM's PDense kernels.  Embedding
# tables, norms and biases keep one layout in both packages.
_CONV = re.compile(r"(^|\.)Conv_\d+\.weight$")
_DENSE = re.compile(
    r"((^|\.)Dense_\d+|^block_\d+\.(qkv|out|fc1|fc2)|^lm_head)\.weight$")
_CONV_ORDER = (2, 3, 1, 0)  # OIHW -> HWIO


def _torch_name(flax_name: str) -> str:
    *path, leaf = flax_name.split(SEP)
    return ".".join([*path, _LEAF[leaf]])


def _flax_name(torch_name: str, kind: str) -> str:
    """Inverse of `_torch_name`; ``kind`` says which flax leaf a
    ``weight`` was (``kernel``, ``scale`` or ``embedding``)."""
    *path, leaf = torch_name.split(".")
    flax_leaf = {"weight": kind, "bias": "bias", "running_mean": "mean",
                 "running_var": "var",
                 **{n: n for n in _MOE_LEAVES}}[leaf]
    return SEP.join([*path, flax_leaf])


def flax_name(name: str, shape) -> str:
    """The flax name of the port's leaf ``name`` of ``shape``: a
    ``weight`` is a flax ``scale`` when 1-D, an ``embedding`` in a module
    named ``*embed``, a ``kernel`` otherwise — the repo models' rule."""
    module = name.rsplit(".", 2)[-2] if "." in name else name
    kind = ("scale" if len(shape) == 1 else
            "embedding" if module.endswith("embed") else "kernel")
    return _flax_name(name, kind)


def jax_tree_order(named) -> "OrderedDict":
    """``named`` (the port's name -> tensor) in the order the JAX package
    gives the same model's leaves: a flax-tree model's (``.``-separated
    module names) sorted by flax name, as JAX flattens a flax dict; a
    plain dict's (the MLP's) kept as it is.  A fleet's plan hashes its
    names in this order."""
    items = list(named.items())
    if not items or not all("." in n for n, _ in items):
        return OrderedDict(items)
    return OrderedDict(sorted(
        items, key=lambda kv: flax_name(kv[0], tuple(kv[1].shape))))


def _to_torch_layout(name: str, a: np.ndarray) -> np.ndarray:
    if name.endswith(f"{SEP}kernel"):
        if a.ndim == 4:
            return a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        if a.ndim == 2:
            return a.T                      # (in, out) -> (out, in)
    return a


def jax_order(name: str, shape) -> "tuple[int, ...] | None":
    """The permutation that takes the port's leaf ``name`` of ``shape`` to
    its flax layout (``x.permute(order)``), or None where the layouts
    agree: ``(2, 3, 1, 0)`` for a conv kernel, ``(1, 0)`` for a Dense or
    PDense kernel of the flax-tree models.  The inverse of
    `_to_torch_layout`, keyed by the port's names; a name the repo's
    models do not give (a user's own model, the MLP's plain dict) gets
    None."""
    rank = len(shape)
    if rank == 4 and _CONV.search(name):
        return _CONV_ORDER
    if rank == 2 and _DENSE.search(name):
        return (1, 0)
    return None


def invert(order) -> "tuple[int, ...]":
    """The inverse of a permutation: ``x.permute(order).permute(
    invert(order))`` is ``x``."""
    inv = [0] * len(order)
    for i, o in enumerate(order):
        inv[o] = i
    return tuple(inv)


def to_jax_order(x: torch.Tensor, order) -> torch.Tensor:
    """``x`` in the element order of ``order`` (a `jax_order` result, None
    for none): a permuted view, no copy."""
    return x if order is None else x.permute(order)


def from_jax_order(x: torch.Tensor, order) -> torch.Tensor:
    """Inverse of `to_jax_order`: the port's layout as a view, no copy."""
    return x if order is None else x.permute(invert(order))


def params_from_jax(named_np, aux_np=None):
    """``(params, aux)`` for the port from flax flat ``named_np`` (name ->
    array, ``/``-separated) and its ``batch_stats`` tree ``aux_np`` (nested
    or flat).  Returns two ordered dicts of contiguous CPU tensors."""
    params = OrderedDict(
        (_torch_name(n), torch.from_numpy(np.array(
            _to_torch_layout(n, np.asarray(a)))))
        for n, a in named_np.items())
    aux = OrderedDict(
        (_torch_name(n), torch.from_numpy(np.array(a)))
        for n, a in named_params(aux_np or {}).items())
    return params, aux


# ---------------------------------------------------------------------------
# Optimizer state, both ways
# ---------------------------------------------------------------------------


def _relayout(name: str, shape, a, order, lead: int):
    """One state leaf of parameter ``name`` (of ``shape``) with its
    parameter dims permuted by ``order`` (None: kept); the first ``lead``
    dims (the EF residual's world) stay.  A scalar passes; a leaf of
    another shape — a raw ZeRO shard, in one package's flat order — is
    refused."""
    a = np.asarray(a)
    if a.ndim == 0:
        return a
    if a.shape[lead:] != tuple(shape):
        raise ValueError(
            f"state leaf of {name!r} has shape {a.shape}, not the "
            f"parameter's {tuple(shape)}: a raw ZeRO shard cannot cross "
            f"packages (save it with state_dict(raw_shards=False))")
    if order is None:
        return np.array(a)
    return np.ascontiguousarray(
        a.transpose(*range(lead), *(lead + p for p in order)))


def _map_state(sd: dict, names: dict, orders: dict) -> dict:
    """``sd`` with every per-parameter tree renamed through ``names``
    (source name -> destination name) and each array's parameter dims
    permuted by ``orders[source name]``."""
    shapes = {n: np.shape(a) for n, a in sd["params"].items()}

    def leaf(n, a, lead=0):
        return _relayout(n, shapes[n], a, orders[n], lead)

    out = {k: v for k, v in sd.items()
           if k not in ("params", "state", "aux", "ef", "ema")}
    out["params"] = OrderedDict((names[n], leaf(n, a))
                                for n, a in sd["params"].items())
    out["state"] = OrderedDict(
        (names[n], {k: leaf(n, v) for k, v in st.items()})
        for n, st in sd["state"].items())
    out["ef"] = (None if sd.get("ef") is None else OrderedDict(
        (names[n], leaf(n, a, 1)) for n, a in sd["ef"].items()))
    out["ema"] = (None if sd.get("ema") is None else OrderedDict(
        (names[n], leaf(n, a)) for n, a in sd["ema"].items()))
    return out


def state_from_jax(sd: dict) -> dict:
    """A JAX ``MPI_PS.state_dict()`` of a flax-tree model (the ResNets, the
    LM) as the port's: params, per-parameter optimizer state, the EF
    residual ``[world, ...]`` and the EMA weights in the port's names and
    layouts, the BatchNorm statistics as the port's flat buffers;
    ``optim``, ``hyper`` and ``topology`` as they are.  (The MLP's plain
    dict has one layout in both packages: its state crosses as it is.)"""
    orders = {}
    for n, a in sd["params"].items():
        tshape = _to_torch_layout(n, np.empty(np.shape(a), np.uint8)).shape
        order = jax_order(_torch_name(n), tshape)
        orders[n] = None if order is None else invert(order)
    out = _map_state(sd, {n: _torch_name(n) for n in sd["params"]}, orders)
    out["aux"] = OrderedDict(
        (_torch_name(n), np.array(a))
        for n, a in named_params(sd.get("aux") or {}).items())
    return out


def state_to_jax(sd: dict) -> dict:
    """The port's ``MPI_PS.state_dict()`` of a flax-tree model as the JAX
    package's (the inverse of `state_from_jax`); the BatchNorm statistics
    become flax's nested ``batch_stats`` tree; names map by `flax_name`."""
    names = {n: flax_name(n, np.shape(a)) for n, a in sd["params"].items()}
    orders = {n: jax_order(n, np.shape(a)) for n, a in sd["params"].items()}
    out = _map_state(sd, names, orders)
    aux: dict = {}
    for n, a in (sd.get("aux") or {}).items():
        *path, leaf = _flax_name(n, "scale").split(SEP)
        node = aux
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.array(a)
    out["aux"] = aux
    return out
