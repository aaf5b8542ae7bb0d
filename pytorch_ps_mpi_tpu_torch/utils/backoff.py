"""One jittered exponential-backoff ladder for every redial in the repo.

Counterpart of `pytorch_ps_mpi_tpu/utils/backoff.py`, copied, not
imported.  The port's redial so far is the multihost worker's PS
reconnect; the router's and aggregator's come with their slices.

Three call sites used to roll their own retry loops (the worker's PS
reconnect, the `ShardRouter` link redial riding it, the `GroupWorker`
aggregator redial) — same shape, slightly different arithmetic, and any
fix (jitter bounds, cap semantics, budget accounting) had to land three
times.  `Backoff` is the one implementation:

* attempt ``k`` sleeps ``min(maximum, base * 2**k)`` scaled by a
  0.5–1.5x jitter drawn from the caller's RNG (deterministic per
  seeded stream — chaos tests replay identical ladders);
* the ladder is bounded by ``retries`` attempts AND an optional
  `transport.Deadline` budget (whichever ends it first) — the budget is
  how the redial ladder joins the unified deadline story instead of
  running its own clock.

Usage::

    for _attempt in Backoff(base=0.1, maximum=1.0, retries=5,
                            rng=rng).sleeps():
        try:
            dial()
        except TRANSPORT_ERRORS:
            continue
        break   # connected
    else:
        ...     # budget spent: the peer is gone for good
"""

from __future__ import annotations

import time


class Backoff:
    """A bounded, jittered exponential-backoff schedule."""

    def __init__(self, *, base: float = 0.1, maximum: float = 1.0,
                 retries: int = 3, rng=None, seed: int = 0,
                 deadline=None):
        if base < 0 or maximum < 0:
            raise ValueError(
                f"base/maximum must be >= 0, got {base}/{maximum}")
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        self.base = float(base)
        self.maximum = float(maximum)
        self.retries = int(retries)
        self.deadline = deadline
        if rng is None:
            import numpy as np
            rng = np.random.default_rng(np.random.SeedSequence(
                [int(seed), 0xBACC0FF]))
        self._rng = rng

    def delay(self, attempt: int) -> float:
        """Attempt ``attempt``'s jittered sleep (draws from the RNG
        stream — call once per attempt, in order, for determinism)."""
        d = min(self.maximum, self.base * (2 ** attempt))
        return d * (0.5 + float(self._rng.random()))  # jitter: 0.5-1.5x

    def delays(self):
        """The full schedule, lazily: ``retries`` jittered delays, cut
        short when the optional deadline budget runs dry."""
        for attempt in range(self.retries):
            if self.deadline is not None and self.deadline.expired():
                return
            yield self.delay(attempt)

    def sleeps(self):
        """Sleep each delay, yielding the attempt index afterwards —
        the ``for _ in backoff.sleeps(): try_dial()`` ladder every
        redial site shares."""
        for attempt, d in enumerate(self.delays()):
            time.sleep(d)
            yield attempt
