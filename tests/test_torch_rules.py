"""Update rules of the PyTorch port against the JAX package's, bitwise.

Each case runs five steps of the same rule from the same numpy parameter
and gradients through `pytorch_ps_mpi_tpu.optim.rules` and
`pytorch_ps_mpi_tpu_torch.optim.rules`.  Tolerance: none — both evaluate
the same float32 operations in the same order (the port computes the bias
corrections with numpy's float32 ``pow``, which gives XLA's bits), so the
parameters and every state tensor must be equal bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu.optim import rules as jrules
from pytorch_ps_mpi_tpu.optim import schedules as jsched
from pytorch_ps_mpi_tpu_torch.optim import rules as trules
from pytorch_ps_mpi_tpu_torch.optim import schedules as tsched

CASES = [
    ("sgd", dict(lr=0.1)),
    ("sgd", dict(lr=0.1, momentum=0.9)),
    ("sgd", dict(lr=0.1, momentum=0.9, dampening=0.3)),
    ("sgd", dict(lr=0.1, momentum=0.9, weight_decay=0.01)),
    ("sgd", dict(lr=0.05, momentum=0.8, nesterov=True)),
    ("sgd", dict(lr=0.05, momentum=0.8, weight_decay=0.1, nesterov=True)),
    ("adam", dict(lr=1e-3)),
    ("adam", dict(lr=3e-3, betas=(0.8, 0.99), eps=1e-6, weight_decay=0.01)),
    ("adam", dict(lr=1e-3, amsgrad=True)),
    ("adamw", dict(lr=1e-3)),
    ("adamw", dict(lr=2e-3, weight_decay=0.05, amsgrad=True)),
]


def _run(rules, to, frm, optim, hyper, p0, grads):
    init, update = rules.RULES[optim]
    p = to(p0)
    kw = ({"amsgrad": hyper.get("amsgrad", False)}
          if optim != "sgd" else {})
    state = init(p, **kw)
    for g in grads:
        p, state = update(p, to(g), state, **hyper)
    return frm(p), {k: frm(v) for k, v in state.items()}


@pytest.mark.parametrize("optim,hyper", CASES)
def test_rule_bitwise_matches_jax(optim, hyper):
    rng = np.random.RandomState(0)
    p0 = rng.randn(7, 3).astype(np.float32)
    grads = [rng.randn(7, 3).astype(np.float32) for _ in range(5)]
    pj, sj = _run(jrules, jnp.asarray, np.asarray, optim, hyper, p0, grads)
    pt, st = _run(trules, torch.from_numpy, lambda t: t.numpy(), optim,
                  hyper, p0, grads)
    np.testing.assert_array_equal(pt, pj)
    assert st.keys() == sj.keys()
    for k in sj:
        np.testing.assert_array_equal(st[k], sj[k], err_msg=k)


def test_constant_schedule_resolves_like_jax():
    hyper = {"lr": tsched.constant(0.1), "momentum": 0.9}
    out = tsched.resolve_hyper(hyper, torch.tensor(3))
    ref = jsched.resolve_hyper({"lr": jsched.constant(0.1)}, jnp.int32(3))
    assert out["lr"] == float(ref["lr"])
    assert out["momentum"] == 0.9
    assert tsched.resolve_hyper({"lr": 0.5}, 0) == {"lr": 0.5}
