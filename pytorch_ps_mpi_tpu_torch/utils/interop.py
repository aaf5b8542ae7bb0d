"""Weights and statistics across from the JAX package.

Counterpart of `pytorch_ps_mpi_tpu/utils/interop.py`, in the other
direction: `params_from_jax` turns the flat flax names and arrays that the
JAX package's ``build_model`` gives into the port's ``named_parameters()``
and BatchNorm buffers, undoing its layout rules:

* flax conv kernels ``HWIO`` -> torch ``OIHW``;
* flax ``Dense`` kernels ``(in, out)`` -> torch ``(out, in)``;
* ``kernel``, BatchNorm/LayerNorm ``scale`` and ``Embed``'s
  ``embedding`` -> ``weight`` (an embedding table keeps ``(num, features)``);
* ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``.

It serves flax module trees (the ResNets and the transformer LM).  The
MLP's plain dict keeps ``(in, out)`` in both packages and crosses
unchanged.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from .flatten import SEP, named_params

_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
         "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _torch_name(flax_name: str) -> str:
    *path, leaf = flax_name.split(SEP)
    return ".".join([*path, _LEAF[leaf]])


def _to_torch_layout(name: str, a: np.ndarray) -> np.ndarray:
    if name.endswith(f"{SEP}kernel"):
        if a.ndim == 4:
            return a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        if a.ndim == 2:
            return a.T                      # (in, out) -> (out, in)
    return a


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
