"""Learning-rate schedules — callables of the step count.

Counterpart of `pytorch_ps_mpi_tpu/optim/schedules.py`, for now only the
resolution hook and the constant schedule.  A schedule is a function
``step -> lr`` passed as the ``lr`` hyper; the PS resolves it against the
optimizer state's step counter on every update, so a schedule stays
aligned with the step count it is read from.
"""

from __future__ import annotations

import numpy as np


def resolve_hyper(hyper: dict, step):
    """Resolve a callable lr against the step count — the single place
    the 'lr may be a schedule' contract is interpreted."""
    if callable(hyper.get("lr")):
        return dict(hyper, lr=hyper["lr"](step))
    return hyper


def constant(lr: float):
    """Trivial schedule — equivalent to passing the float directly (the
    value is rounded to float32, as the JAX schedules return it)."""
    value = float(np.float32(lr))

    def sched(step):
        del step
        return value
    return sched
