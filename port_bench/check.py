"""The comparison that decides ``correct``.

The program's first three steps (made in set-up through the window's own
call, on three distinct batches of the pool) against the plain
reference's three steps from the same weights on the same batches:

* ``loss_gap``: the largest relative gap between a step's loss and the
  reference's;
* ``grad_gap``: over the leaves, the largest gap between the norm of the
  first gradient as the optimizer gets it (the momentum buffer after one
  step) and the reference's decoded gradient's norm, over the larger of
  that leaf's reference norm and the median leaf's (of those not 0);
* ``change_gap``: the same of each leaf's change over the three steps,
  leaving out the leaves whose reference gradient is under a thousandth of
  the median leaf's at every step (they move by round-off alone).

A number is compared where the cell's file gives it a limit; a number
that is not finite fails.
"""

from __future__ import annotations

import math
import statistics

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
QUIET = 1e-3


def moving_leaves(step_grad_norms) -> "list[str]":
    """The leaves whose reference gradient reaches a thousandth of the
    median leaf's at some step."""
    names = list(step_grad_norms[0])
    keep = set()
    for norms in step_grad_norms:
        med = statistics.median(v for v in norms.values() if v > 0)
        keep.update(n for n in names if norms[n] >= QUIET * med)
    return [n for n in names if n in keep]


def worst_gap(prog: dict, ref: dict, names) -> "tuple[float, str]":
    """``max |prog[n] - ref[n]| / max(ref[n], median ref)`` and its leaf;
    the median is over the leaves whose reference norm is not 0 (a
    zero-initialised scale leaves whole branches without a gradient at the
    first step)."""
    nonzero = [ref[n] for n in names if ref[n] > 0]
    if not nonzero:
        return math.inf, ""
    med = statistics.median(nonzero)
    worst, leaf = 0.0, ""
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med)
        if not math.isfinite(gap):
            return math.inf, n
        if gap > worst:
            worst, leaf = gap, n
    return worst, leaf


def readings(prog: dict, ref: dict) -> dict:
    """The three numbers and the leaves they come from."""
    loss_gap = max(abs(p - r) / abs(r)
                   for p, r in zip(prog["losses"], ref["losses"]))
    if not all(math.isfinite(p) for p in prog["losses"]):
        loss_gap = math.inf
    names = list(ref["grad_norms"])
    grad_gap, grad_leaf = worst_gap(prog["grad_norms"], ref["grad_norms"],
                                    names)
    moving = moving_leaves(ref["step_grad_norms"])
    change_gap, change_leaf = worst_gap(prog["change_norms"],
                                        ref["change_norms"], moving)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "grad_leaf": grad_leaf,
            "change_leaf": change_leaf,
            "left_out": len(names) - len(moving)}


def judge(read: dict, limits: dict) -> "tuple[bool, dict]":
    """``(correct, {number: [reading, limit]})`` over the numbers the cell
    gives a limit (a number that neither the control nor a fault can
    separate from sound runs has none, and is not compared): correct when
    each is finite and at most its limit."""
    out, ok = {}, True
    for key in NUMBERS:
        if key not in limits:
            continue
        value, limit = read[key], float(limits[key])
        out[key] = [value, limit]
        if not (math.isfinite(value) and value <= limit):
            ok = False
    return ok, out
