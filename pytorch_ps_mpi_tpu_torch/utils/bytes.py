"""Payload byte accounting, and the host copy of a tensor.

Counterpart of `pytorch_ps_mpi_tpu/utils/bytes.py`: sums
``numel * element_size`` over every tensor leaf of a nested
dict/list/tuple.  `host_numpy` is how a tensor becomes a host array for
`MPI_PS.state_dict` and the checkpoint files.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .flatten import tree_leaves


def bytes_of(obj: Any) -> int:
    """Total payload bytes of a tree of tensors (correct for N-D tensors)."""
    return sum(int(t.numel()) * t.element_size() for t in tree_leaves(obj))


def host_numpy(x: torch.Tensor) -> np.ndarray:
    """A host numpy copy of ``x`` (bfloat16 widened to float32)."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        x = x.to(torch.float32)
    return x.numpy().copy()
