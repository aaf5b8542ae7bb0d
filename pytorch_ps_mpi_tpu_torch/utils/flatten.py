"""Trees of tensors: flattening in JAX's leaf order, and named parameters.

Counterpart of `pytorch_ps_mpi_tpu/utils/flatten.py`.  The collectives
bucket the leaves of a tree in flattening order, so that order is part of
the bucket plan: it follows ``jax.tree.flatten`` — an ``OrderedDict`` in
insertion order, any other ``dict`` in sorted key order, lists and tuples
in order, and everything else a leaf.  Then a bucket plan of the port
equals the JAX package's plan for the same tree.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any

SEP = "/"


def _children(node):
    if isinstance(node, OrderedDict):
        keys = list(node)
        return ("odict", keys), [node[k] for k in keys]
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", keys), [node[k] for k in keys]
    if isinstance(node, (list, tuple)):
        return (type(node), len(node)), list(node)
    return None, None


def tree_flatten(tree) -> "tuple[list[Any], Any]":
    """``(leaves, treedef)``; `tree_unflatten` inverts it."""
    leaves: list[Any] = []

    def rec(node):
        kind, kids = _children(node)
        if kind is None:
            leaves.append(node)
            return None
        return kind, [rec(k) for k in kids]

    return leaves, rec(tree)


def tree_unflatten(treedef, leaves):
    it = iter(leaves)

    def rec(td):
        if td is None:
            return next(it)
        (tag, meta), kids = td
        vals = [rec(k) for k in kids]
        if tag == "odict":
            return OrderedDict(zip(meta, vals))
        if tag == "dict":
            return dict(zip(meta, vals))
        return tag(vals)

    return rec(treedef)


def tree_leaves(tree) -> "list[Any]":
    return tree_flatten(tree)[0]


def tree_map(fn, tree):
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(x) for x in leaves])


def named_params(tree) -> "OrderedDict[str, Any]":
    """Flatten a nested dict to ``(path/to/leaf, leaf)`` pairs."""
    out: "OrderedDict[str, Any]" = OrderedDict()

    def rec(prefix, node):
        kind, kids = _children(node)
        if kind is None or kind[0] not in ("odict", "dict"):
            out[prefix] = node
            return
        for k, v in zip(kind[1], kids):
            rec(f"{prefix}{SEP}{k}" if prefix else str(k), v)

    rec("", tree)
    return out
