"""Divergence guardrails — the rollback-on-divergence detector.

Copied from `pytorch_ps_mpi_tpu/utils/guardrails.py` (framework-free).

The elastic trainer treats a diverging run the way it treats preemption:
a normal event with a scripted recovery.  `DivergenceGuard` watches the
per-step loss stream with two detectors:

* **Loss-spike** — a rolling median + MAD window (robust statistics: a
  single spike cannot drag the baseline the way a mean/std window's own
  contamination would).  A step whose loss exceeds
  ``median + spike_mad * max(1.4826 * MAD, rel_floor * |median|)`` is a
  spike; the MAD is floored at a fraction of the median so a near-flat
  window (MAD ~ 0, e.g. a converged plateau) doesn't flag noise.
* **Non-finite streak** — ``nonfinite_streak`` consecutive NaN/inf losses.
  One bad batch is the ``skip_nonfinite`` consensus gate's job; a STREAK
  means the parameters themselves are gone and only a rollback helps.

The guard only *decides*; the training loop owns the recovery (restore
the last good checkpoint, optionally rescale LR, resume) and records the
event in the optimizer's ``fault_stats`` — see ``train._maybe_rollback``.

Healthy losses enter the window; spiking and non-finite ones do not, so
one divergence episode cannot poison the baseline it is judged against.
After a rollback call `reset()`: the window describes a trajectory that
no longer exists.
"""

from __future__ import annotations

import math
from collections import deque


class DivergenceGuard:
    """Rolling loss-spike (median + MAD) and non-finite-streak detector.

    ``spike_mad=0`` disables the spike detector; ``nonfinite_streak=0``
    disables the streak detector.  ``observe(loss)`` returns ``None``
    (healthy), ``"spike"``, or ``"nonfinite"``; after acting on a verdict
    call `reset()`.
    """

    def __init__(self, *, window: int = 64, min_history: int = 8,
                 spike_mad: float = 10.0, nonfinite_streak: int = 3,
                 rel_floor: float = 0.05):
        if window < 2:
            raise ValueError(f"window must be >= 2, got {window}")
        if min_history < 2:
            raise ValueError(f"min_history must be >= 2, got {min_history}")
        if spike_mad < 0 or nonfinite_streak < 0 or rel_floor < 0:
            raise ValueError("spike_mad / nonfinite_streak / rel_floor "
                             "must be >= 0")
        self.window = int(window)
        self.min_history = int(min_history)
        self.spike_mad = float(spike_mad)
        self.nonfinite_streak = int(nonfinite_streak)
        self.rel_floor = float(rel_floor)
        self._hist: "deque[float]" = deque(maxlen=self.window)
        self._streak = 0
        self.disabled = False  # the loop's rollback cap flips this

    def _median(self, xs) -> float:
        s = sorted(xs)
        k = len(s) // 2
        return s[k] if len(s) % 2 else 0.5 * (s[k - 1] + s[k])

    def threshold(self) -> "float | None":
        """The current spike threshold, or None while history is short."""
        if not self.spike_mad or len(self._hist) < self.min_history:
            return None
        med = self._median(self._hist)
        mad = self._median(abs(x - med) for x in self._hist)
        scale = max(1.4826 * mad, self.rel_floor * abs(med), 1e-12)
        return med + self.spike_mad * scale

    def observe(self, loss) -> "str | None":
        """Feed one step's loss; returns the triggered detector or None."""
        if self.disabled:
            return None
        v = float(loss)
        if not math.isfinite(v):
            self._streak += 1
            if self.nonfinite_streak and self._streak >= self.nonfinite_streak:
                return "nonfinite"
            return None
        self._streak = 0
        thr = self.threshold()
        if thr is not None and v > thr:
            return "spike"
        self._hist.append(v)
        return None

    def reset(self) -> None:
        """Forget the window and streak — call after a rollback restored
        an earlier trajectory."""
        self._hist.clear()
        self._streak = 0
