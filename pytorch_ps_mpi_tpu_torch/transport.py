"""Transport primitives of the async PS.

Counterpart of `pytorch_ps_mpi_tpu/transport.py`, copied, not imported:
so far only `Deadline`, the one time-budget type every fill and
transport timeout rides (the in-process async PS arms one per quorum
fill).  The wire transport (framing, sessions, credits) comes with the
multihost slice and extends this module under the same names.
"""

from __future__ import annotations

import time


class Deadline:
    """A monotonic time budget: ``Deadline(5.0)`` expires 5 s after
    construction; ``Deadline(None)`` never expires."""

    __slots__ = ("budget", "_t0")

    def __init__(self, budget: "float | None"):
        if budget is not None and budget < 0:
            raise ValueError(f"Deadline budget must be >= 0, got {budget}")
        self.budget = budget
        self._t0 = time.monotonic()

    def elapsed(self) -> float:
        return time.monotonic() - self._t0

    def remaining(self) -> float:
        """Seconds left (>= 0.0); ``inf`` for a budget-less deadline."""
        if self.budget is None:
            return float("inf")
        return max(0.0, self.budget - self.elapsed())

    def expired(self) -> bool:
        return self.budget is not None and self.remaining() <= 0.0

    def timeout(self, floor: float = 0.001,
                cap: "float | None" = None) -> "float | None":
        """The remaining budget as a queue/socket timeout: clamped to
        ``floor`` so a just-expired deadline still makes one bounded
        attempt (the caller checks ``expired()`` to decide what a timeout
        means), optionally capped (poll granularity).  None for a
        budget-less deadline with no cap."""
        if self.budget is None:
            return cap
        t = max(self.remaining(), floor)
        return t if cap is None else min(t, cap)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        if self.budget is None:
            return "Deadline(never)"
        return f"Deadline({self.budget}s, {self.remaining():.3f}s left)"
