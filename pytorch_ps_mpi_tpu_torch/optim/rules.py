"""Torch-parity optimizer update rules as functions on tensors.

Counterpart of `pytorch_ps_mpi_tpu/optim/rules.py`.  The math is the
reference's old-torch form, including its two quirks:

* **SGD first-step momentum asymmetry**: the first step's buffer is the
  *undamped* gradient; later steps use
  ``buf = momentum*buf + (1-dampening)*d_p``.
* **Adam eps placement**: ``denom = sqrt(v) + eps`` on the *uncorrected*
  second moment, with the bias correction folded into
  ``step_size = lr * sqrt(1-b2^t) / (1-b1^t)``.

Each rule is a pure ``(param, d_p, state) -> (param, state)`` function,
applied per named parameter by the PS layer after the cross-rank sum.

The step counter is a 0-d int32 tensor kept on the host, so that the
first-step branch and the bias corrections cost no device sync.  The bias
corrections are computed in float32 with numpy, whose ``powf`` gives the
same bits as XLA's float32 ``pow`` on the CPU; every tensor operation runs
in the parameter's dtype in the JAX rule's order, so the two packages
agree bitwise in float32.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

State = dict[str, Any]


def _step0() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


def _f32(x) -> float:
    """A Python float holding an exact float32 value (a numpy scalar on
    the left of ``*`` would turn a tensor into an array)."""
    return float(np.float32(x))


# --------------------------------------------------------------------------
# SGD
# --------------------------------------------------------------------------


def sgd_init(param: torch.Tensor) -> State:
    return {"step": _step0(), "momentum_buffer": torch.zeros_like(param)}


def sgd_update(param, d_p, state: State, *, lr: float, momentum: float = 0.0,
               dampening: float = 0.0, weight_decay: float = 0.0,
               nesterov: bool = False):
    if nesterov and (momentum <= 0 or dampening != 0):
        raise ValueError("Nesterov momentum requires a momentum and zero dampening")
    step = state["step"]
    if weight_decay != 0:
        d_p = d_p + weight_decay * param
    buf = state["momentum_buffer"]
    if momentum != 0:
        # First step: buf <- d_p exactly (zeros*momentum + d_p); afterwards
        # the damped running average.
        if int(step) == 0:
            buf = d_p
        else:
            buf = momentum * buf + (1.0 - dampening) * d_p
        update = d_p + momentum * buf if nesterov else buf
    else:
        update = d_p
    new_param = param - lr * update
    return new_param, {"step": step + 1, "momentum_buffer": buf}


# --------------------------------------------------------------------------
# Adam
# --------------------------------------------------------------------------


def adam_init(param: torch.Tensor, *, amsgrad: bool = False) -> State:
    state = {"step": _step0(), "exp_avg": torch.zeros_like(param),
             "exp_avg_sq": torch.zeros_like(param)}
    if amsgrad:
        state["max_exp_avg_sq"] = torch.zeros_like(param)
    return state


def _bias_corrections(step: torch.Tensor, beta1: float, beta2: float):
    t = np.float32(int(step))
    one = np.float32(1.0)
    return (one - np.float32(beta1) ** t, one - np.float32(beta2) ** t)


def adam_update(param, grad, state: State, *, lr: float = 1e-3,
                betas=(0.9, 0.999), eps: float = 1e-8,
                weight_decay: float = 0.0, amsgrad: bool = False):
    beta1, beta2 = betas
    step = state["step"] + 1
    if weight_decay != 0:
        grad = grad + weight_decay * param
    exp_avg = beta1 * state["exp_avg"] + (1.0 - beta1) * grad
    exp_avg_sq = beta2 * state["exp_avg_sq"] + (1.0 - beta2) * grad * grad
    new_state = {"step": step, "exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq}
    if amsgrad:
        max_sq = torch.maximum(state["max_exp_avg_sq"], exp_avg_sq)
        new_state["max_exp_avg_sq"] = max_sq
        denom = torch.sqrt(max_sq) + eps
    else:
        denom = torch.sqrt(exp_avg_sq) + eps
    bc1, bc2 = _bias_corrections(step, beta1, beta2)
    step_size = _f32(np.float32(lr) * np.sqrt(bc2) / bc1)
    new_param = param - step_size * exp_avg / denom
    return new_param, new_state


# --------------------------------------------------------------------------
# AdamW (decoupled weight decay; torch.optim.AdamW math)
# --------------------------------------------------------------------------


def adamw_update(param, grad, state: State, *, lr: float = 1e-3,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2, amsgrad: bool = False):
    beta1, beta2 = betas
    step = state["step"] + 1
    param = param * (1.0 - lr * weight_decay)  # decoupled decay
    exp_avg = beta1 * state["exp_avg"] + (1.0 - beta1) * grad
    exp_avg_sq = beta2 * state["exp_avg_sq"] + (1.0 - beta2) * grad * grad
    new_state = {"step": step, "exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq}
    bc1, bc2 = _bias_corrections(step, beta1, beta2)
    sqrt_bc2 = _f32(np.sqrt(bc2))
    if amsgrad:
        max_sq = torch.maximum(state["max_exp_avg_sq"], exp_avg_sq)
        new_state["max_exp_avg_sq"] = max_sq
        denom = torch.sqrt(max_sq) / sqrt_bc2 + eps
    else:
        denom = torch.sqrt(exp_avg_sq) / sqrt_bc2 + eps
    new_param = param - _f32(np.float32(lr) / bc1) * exp_avg / denom
    return new_param, new_state


RULES = {
    "sgd": (sgd_init, sgd_update),
    "adam": (adam_init, adam_update),
    "adamw": (adam_init, adamw_update),
}
