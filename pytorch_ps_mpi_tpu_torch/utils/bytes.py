"""Payload byte accounting.

Counterpart of `pytorch_ps_mpi_tpu/utils/bytes.py`: sums
``numel * element_size`` over every tensor leaf of a nested
dict/list/tuple.
"""

from __future__ import annotations

from typing import Any

from .flatten import tree_leaves


def bytes_of(obj: Any) -> int:
    """Total payload bytes of a tree of tensors (correct for N-D tensors)."""
    return sum(int(t.numel()) * t.element_size() for t in tree_leaves(obj))
