"""Learning-rate schedules — callables of the step count.

Counterpart of `pytorch_ps_mpi_tpu/optim/schedules.py`.  A schedule is a
function ``step -> lr`` passed as the ``lr`` hyper; the PS resolves it
against the optimizer state's step counter on every update, so a schedule
stays aligned with the step count it is read from, across a checkpoint
and a resume too.

The port's step counters live on the host (`optim.rules`), so each lr is
computed on the host in numpy float32, one operation at a time in the
JAX schedule's order — the float32 program XLA compiles into the step:

* a Python constant meets a float32 value as JAX's weak types do: rounded
  to float32 first, except where two Python numbers meet (``0.5 *
  (base_lr - final_lr)``), which stays in double until it meets a
  float32;
* XLA rewrites a division by a constant as a multiplication by its
  float32 reciprocal, so the schedules do too (``s / 250`` and ``s *
  (1/250)`` differ in the last bit), and folds a product of constants
  before it meets the step;
* numpy's float32 ``pow`` gives XLA's bits (``torch.pow`` does not), and
  XLA flushes subnormal results to zero, so the schedules do too;
* ``cos`` is numpy's float32 approximation, within 2 ulps of XLA's.

Each schedule returns a Python float holding the exact float32 value (a
numpy scalar on the left of ``*`` would turn a tensor into an array in
the update rules).
"""

from __future__ import annotations

import numpy as np

# Checkpoint marker: schedules are code, not data — `state_dict` records
# this in place of the callable, and restore keeps the restoring
# optimizer's own schedule (step counts in optimizer state carry the
# alignment).  The JAX package writes the same string, so checkpoints
# interchange.
SCHEDULE_MARKER = "<schedule>"

_f32 = np.float32


def hyper_for_checkpoint(hyper: dict) -> dict:
    """Copy of ``hyper`` safe to serialize: callable lr → marker."""
    out = dict(hyper)
    if callable(out.get("lr")):
        out["lr"] = SCHEDULE_MARKER
    return out


def hyper_from_checkpoint(saved: dict, current: dict) -> dict:
    """Resolve a restored hyper dict against the restoring optimizer's.

    A marker lr keeps ``current``'s schedule; a marker restored into a
    float-lr optimizer is refused; a float-lr checkpoint restored into a
    scheduled optimizer keeps the schedule (the restorer's construction
    intent).  All other hypers restore from the checkpoint, as torch's
    ``load_state_dict`` does."""
    out = dict(saved)
    if out.get("lr") == SCHEDULE_MARKER:
        if not callable(current.get("lr")):
            raise ValueError(
                "checkpoint was written with an lr schedule; construct the "
                "restoring optimizer with an lr schedule too "
                "(optim.schedules) or edit the checkpoint hyper")
        out["lr"] = current["lr"]
    elif callable(current.get("lr")):
        out["lr"] = current["lr"]
    return out


def resolve_hyper(hyper: dict, step):
    """Resolve a callable lr against the step count — the single place
    the 'lr may be a schedule' contract is interpreted."""
    if callable(hyper.get("lr")):
        return dict(hyper, lr=hyper["lr"](step))
    return hyper


def _s(step) -> np.float32:
    """The step count (an int or a 0-d host tensor) as float32."""
    return _f32(int(step))


def _clip01(x: np.float32) -> np.float32:
    return _f32(min(max(x, _f32(0.0)), _f32(1.0)))


def _over(c: float) -> np.float32:
    """``1 / c`` in float32: XLA's rewrite of a division by ``c``."""
    return _f32(1.0) / _f32(c)


def _ftz(x: np.float32) -> np.float32:
    """``x`` with a subnormal flushed to zero, as XLA does."""
    return _f32(0.0) if abs(x) < np.finfo(np.float32).tiny else _f32(x)


def constant(lr: float):
    """Trivial schedule — equivalent to passing the float directly (the
    value is rounded to float32, as the JAX schedules return it)."""
    value = float(_f32(lr))

    def sched(step):
        del step
        return value
    return sched


def linear_warmup(base_lr: float, warmup_steps: int):
    """0 → base_lr over ``warmup_steps``, then constant."""
    def sched(step):
        frac = _clip01(_s(step) * _over(max(float(warmup_steps), 1.0)))
        return float(_f32(base_lr) * frac)
    return sched


def cosine(base_lr: float, total_steps: int, *, warmup_steps: int = 0,
           final_lr: float = 0.0):
    """Linear warmup then cosine decay to ``final_lr`` at ``total_steps``."""
    half_span = _f32(0.5 * (base_lr - final_lr))
    # ``base_lr * (s / warmup)``: XLA folds the constants first.
    warm_slope = _f32(base_lr) * _over(max(float(warmup_steps), 1.0))
    over_span = _over(max(float(total_steps - warmup_steps), 1.0))

    def sched(step):
        s = _s(step)
        if s < _f32(warmup_steps):
            return float(warm_slope * s)
        prog = _clip01((s - _f32(warmup_steps)) * over_span)
        cos = _f32(final_lr) + half_span * (
            _f32(1.0) + np.cos(_f32(np.pi) * prog))
        return float(_f32(cos))
    return sched


def step_decay(base_lr: float, step_size: int, gamma: float = 0.1):
    """lr * gamma^(step // step_size) — torch ``StepLR``'s shape."""
    def sched(step):
        k = np.floor(_s(step) * _over(step_size))
        return float(_ftz(_f32(base_lr) * _ftz(_f32(gamma) ** _f32(k))))
    return sched


def exponential(base_lr: float, gamma: float):
    """lr * gamma^step — torch ``ExponentialLR``'s shape."""
    def sched(step):
        return float(_ftz(_f32(base_lr) * _ftz(_f32(gamma) ** _s(step))))
    return sched
