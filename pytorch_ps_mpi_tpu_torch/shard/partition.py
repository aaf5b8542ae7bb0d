"""Leaf→shard partitioning for the sharded PS fleet.

Counterpart of `pytorch_ps_mpi_tpu/shard/partition.py`, copied (that
module imports no JAX, but the port imports nothing of the JAX package):
for the same ordered ``(name, shape, dtype)`` list the plan's JSON and
digest, and the fleet manifest's JSON, are byte for byte the JAX
package's.  A leaf's bytes are ``numel() * element_size()`` for a torch
tensor (numpy has no bfloat16) and numpy's rule for an array.

The classic parameter-server scaling move (Li et al., OSDI 2014) is a
*server group*: the parameter tree is split across K shards, each shard
owning a disjoint slice.  Which leaf lands where is a deployment decision
— embeddings near their readers, biases co-located with their weights —
so assignment is **rule-driven**: an ordered list of ``(regex, shard)``
rules in the ``match_partition_rules`` style, first match wins.  Leaves
no rule claims fall to a **size-balanced greedy fallback** (largest leaf
first, onto the currently lightest shard), so a rule set is never
required: ``rules=None`` gives a pure balance split.

The output is a static `ShardPlan`: an ordered leaf→shard map plus a
content digest.  The plan is computed once on the fleet side and *agreed
at HELO time* — every shard advertises ``(shard_index, num_shards,
digest)`` in its HELO reply, workers fetch the full plan from shard 0
(the ``SPLN`` frame) and refuse any shard whose digest disagrees, so the
two sides can never silently split one gradient two different ways.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import re
from collections import OrderedDict
from typing import Any, Iterable


def _leaf_bytes(leaf) -> int:
    """Byte size of one parameter leaf: ``numel() * element_size()`` for a
    torch tensor, shape × itemsize for a numpy array (or anything
    shape/dtype duck-typed)."""
    import numpy as np
    import torch

    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    a = leaf if hasattr(leaf, "dtype") else np.asarray(leaf)
    size = 1
    for d in getattr(a, "shape", ()):
        size *= int(d)
    return size * int(np.dtype(a.dtype).itemsize)


def match_partition_rules(rules, names: "Iterable[str]",
                          num_shards: int) -> "dict[str, int | None]":
    """Apply ordered ``(regex, shard)`` rules to leaf ``names``: first
    ``re.search`` match wins; an unmatched name maps to None — the greedy
    fallback's input, not an error, so partial rule sets compose."""
    compiled = []
    for pattern, shard in rules or ():
        shard = int(shard)
        if not 0 <= shard < num_shards:
            raise ValueError(
                f"partition rule {pattern!r} -> shard {shard} is out of "
                f"range for {num_shards} shards")
        compiled.append((re.compile(pattern), shard))
    out: "dict[str, int | None]" = {}
    for name in names:
        out[name] = next((s for rx, s in compiled
                          if rx.search(name) is not None), None)
    return out


@dataclasses.dataclass
class ShardPlan:
    """The static leaf→shard assignment both sides agree on.

    ``assignment`` preserves the canonical parameter order (the order the
    model construction yields), which is also the order the router
    reassembles pulled slices into — a plan is a *total* description of
    the split, not just a lookup table.
    """

    num_shards: int
    assignment: "OrderedDict[str, int]"
    # Bytes per shard at plan-build time (observability: `describe`).
    sizes: "list[int]" = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self.num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, "
                             f"got {self.num_shards}")
        self.assignment = OrderedDict(self.assignment)
        counts = [0] * self.num_shards
        for name, shard in self.assignment.items():
            if not 0 <= shard < self.num_shards:
                raise ValueError(
                    f"leaf {name!r} assigned to shard {shard}, out of "
                    f"range for {self.num_shards} shards")
            counts[shard] += 1
        empty = [k for k, c in enumerate(counts) if c == 0]
        if empty:
            raise ValueError(
                f"shard(s) {empty} own no parameters — a PS shard with "
                f"nothing to serve is a misconfigured fleet (fewer shards "
                f"or different rules)")

    def names_for(self, shard: int) -> "list[str]":
        """This shard's leaves, in canonical (full-tree) order."""
        return [n for n, s in self.assignment.items() if s == shard]

    def shard_of(self, name: str) -> int:
        return self.assignment[name]

    def digest(self) -> int:
        """Stable u64 content digest of (num_shards, assignment) — what
        the HELO reply advertises so worker and shard can refuse a split
        disagreement before the first gradient."""
        blob = json.dumps([self.num_shards, list(self.assignment.items())],
                          separators=(",", ":")).encode()
        return int.from_bytes(hashlib.sha256(blob).digest()[:8], "big")

    def describe(self) -> "dict[str, Any]":
        per = [{"shard": k, "leaves": len(self.names_for(k)),
                "bytes": (self.sizes[k] if k < len(self.sizes) else None)}
               for k in range(self.num_shards)]
        return {"num_shards": self.num_shards,
                "digest": self.digest(), "shards": per}

    def to_json(self) -> str:
        return json.dumps({"num_shards": self.num_shards,
                           "assignment": list(self.assignment.items()),
                           "sizes": self.sizes})

    @classmethod
    def from_json(cls, s: "str | bytes") -> "ShardPlan":
        d = json.loads(s)
        return cls(num_shards=int(d["num_shards"]),
                   assignment=OrderedDict(
                       (n, int(k)) for n, k in d["assignment"]),
                   sizes=[int(b) for b in d.get("sizes", [])])


def build_shard_plan(named_params, num_shards: int,
                     rules=None) -> ShardPlan:
    """Build the fleet's `ShardPlan` for ``named_params`` (an ordered
    ``(name, leaf)`` iterable or mapping).

    Rules claim their leaves first (first-match-wins, validated in
    range); every unclaimed leaf then goes greedy size-balanced — largest
    leaf first onto the lightest shard (ties to the lowest index), ON TOP
    of the load the rules already placed, so a partial rule set still
    yields a balanced fleet.  Deterministic for a given input order.
    """
    items = list(named_params.items() if hasattr(named_params, "items")
                 else named_params)
    if not items:
        raise ValueError("cannot shard an empty parameter tree")
    if num_shards > len(items):
        raise ValueError(
            f"num_shards={num_shards} exceeds the {len(items)} parameter "
            f"leaves — some shards would own nothing")
    names = [n for n, _ in items]
    if len(set(names)) != len(names):
        raise ValueError("duplicate parameter names in the tree")
    sizes = {n: _leaf_bytes(p) for n, p in items}
    ruled = match_partition_rules(rules, names, num_shards)

    load = [0] * num_shards
    assignment: "dict[str, int]" = {}
    for name, shard in ruled.items():
        if shard is not None:
            assignment[name] = shard
            load[shard] += sizes[name]
    # Greedy fallback: largest unclaimed leaf onto the lightest shard.
    leftovers = sorted((n for n in names if n not in assignment),
                       key=lambda n: (-sizes[n], n))
    for name in leftovers:
        shard = min(range(num_shards), key=lambda k: (load[k], k))
        assignment[name] = shard
        load[shard] += sizes[name]
    ordered = OrderedDict((n, assignment[n]) for n in names)
    return ShardPlan(num_shards=num_shards, assignment=ordered,
                     sizes=load)


@dataclasses.dataclass
class FleetManifest:
    """The agreement artifact of a COORDINATED fleet checkpoint
    (``ckpt.fleet.json``): which plan the fleet ran, which cut the
    snapshot barrier agreed on, and — per shard — the checkpoint path,
    its recorded step, and a sha256 content digest of the file bytes.

    This is the fleet-level analogue of `ShardPlan`: the plan makes the
    two SIDES agree on one split before any gradient; the manifest makes
    two POINTS IN TIME agree on one cut before any restore.  A resume
    through it refuses — with a typed error, never silently — a manifest
    from a differently-split fleet, a missing or re-written shard file,
    and a skewed (mixed-epoch) checkpoint set.
    """

    plan_digest: int
    num_shards: int
    cut: int
    # [{"shard": k, "path": name, "step": s, "sha256": hex}, ...] —
    # paths are stored relative to the manifest's own directory so a
    # checkpoint directory can be moved/copied wholesale.
    shards: "list[dict]"
    format_version: int = 1

    def __post_init__(self):
        if len(self.shards) != self.num_shards:
            raise ValueError(
                f"manifest lists {len(self.shards)} shard entries for a "
                f"{self.num_shards}-shard fleet")
        seen = {int(e["shard"]) for e in self.shards}
        if seen != set(range(self.num_shards)):
            raise ValueError(
                f"manifest shard indices {sorted(seen)} are not exactly "
                f"0..{self.num_shards - 1}")

    def entry(self, shard: int) -> dict:
        return next(e for e in self.shards if int(e["shard"]) == shard)

    def skewed_entries(self) -> "list[tuple[int, int]]":
        """(shard, step) rows whose step disagrees with the cut — a
        manifest should never contain any (the barrier writes one cut),
        so a non-empty result means the file was hand-edited or
        assembled from mixed barriers."""
        return sorted((int(e["shard"]), int(e["step"]))
                      for e in self.shards if int(e["step"]) != self.cut)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1,
                          sort_keys=True)

    @classmethod
    def from_json(cls, s: "str | bytes") -> "FleetManifest":
        d = json.loads(s)
        version = d.pop("format_version", None)
        if version != 1:
            raise ValueError(
                f"unsupported fleet-manifest format version {version!r}")
        return cls(plan_digest=int(d["plan_digest"]),
                   num_shards=int(d["num_shards"]), cut=int(d["cut"]),
                   shards=list(d["shards"]))


@dataclasses.dataclass
class ShardInfo:
    """One shard's identity in the fleet, handed to `AsyncPSServer` so
    the HELO reply can advertise it (index/count/digest) and the ``SPLN``
    frame can serve the full plan to connecting routers."""

    index: int
    count: int
    plan: ShardPlan

    def __post_init__(self):
        if not 0 <= self.index < self.count:
            raise ValueError(f"shard index {self.index} out of range for "
                             f"{self.count} shards")
        if self.count != self.plan.num_shards:
            raise ValueError(
                f"shard count {self.count} disagrees with the plan's "
                f"{self.plan.num_shards}")

    @property
    def digest(self) -> int:
        return self.plan.digest()

    @property
    def plan_json(self) -> bytes:
        return self.plan.to_json().encode()
