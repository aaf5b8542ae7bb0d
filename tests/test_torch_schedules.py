"""The port's lr schedules against the JAX package's, steps 0-300.

The port computes each lr on the host in numpy float32 (its step counters
live there); the JAX schedules are evaluated as the JAX step evaluates
them, jitted over a traced int32 step.  Tolerance: bitwise for
``constant``, ``linear_warmup``, ``step_decay`` (XLA's float32 ``pow``
equals numpy's) and ``exponential``, and for ``cosine``'s warmup; for ``cosine``'s decay,
within two float32 epsilons (2^-22) of ``0.5 * (base_lr - final_lr)``,
absolute: numpy's float32 ``cos`` and XLA's are different approximations
(most steps agree bitwise), and near the end ``1 + cos`` cancels, so the
bound is on the absolute error that ``cos``'s last bit can carry.  The checkpoint helpers are held to
the JAX package's outcomes, marker string included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pytorch_ps_mpi_tpu.optim import schedules as jsched
from pytorch_ps_mpi_tpu_torch.optim import schedules as tsched

STEPS = np.arange(301)

CASES = [
    ("constant", (0.05,), {}),
    ("constant", (0.1,), {}),
    ("linear_warmup", (0.2, 4), {}),
    ("linear_warmup", (0.1, 0), {}),
    ("linear_warmup", (3e-4, 250), {}),
    ("cosine", (0.1, 100), dict(warmup_steps=10, final_lr=0.01)),
    ("cosine", (0.4, 300), {}),
    ("cosine", (1e-3, 200), dict(warmup_steps=50)),
    ("cosine", (0.1, 5), dict(warmup_steps=5, final_lr=0.02)),
    ("step_decay", (1.0, 10), dict(gamma=0.5)),
    ("step_decay", (0.1, 30), {}),
    ("step_decay", (0.3, 7), dict(gamma=0.93)),
    ("exponential", (1.0, 0.9)),
    ("exponential", (0.1, 0.99)),
    ("exponential", (0.05, 1.01)),
]
CASES = [c if len(c) == 3 else (*c, {}) for c in CASES]


def _jax_values(name, args, kw):
    sched = getattr(jsched, name)(*args, **kw)
    out = jax.jit(jax.vmap(lambda s: jnp.asarray(sched(s), jnp.float32)))(
        jnp.asarray(STEPS, jnp.int32))
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("name,args,kw", CASES)
def test_schedule_matches_jax_steps_0_to_300(name, args, kw):
    sched = getattr(tsched, name)(*args, **kw)
    ours = np.asarray([sched(int(s)) for s in STEPS], np.float32)
    assert all(isinstance(sched(int(s)), float) for s in (0, 7))
    want = _jax_values(name, args, kw)
    if name != "cosine":
        np.testing.assert_array_equal(ours.view(np.int32),
                                      want.view(np.int32))
        return
    warm = STEPS < kw.get("warmup_steps", 0)
    np.testing.assert_array_equal(ours[warm].view(np.int32),
                                  want[warm].view(np.int32))
    base_lr, final_lr = args[0], kw.get("final_lr", 0.0)
    atol = 2 * np.finfo(np.float32).eps * 0.5 * abs(base_lr - final_lr)
    np.testing.assert_allclose(ours[~warm], want[~warm], rtol=0, atol=atol)


def test_schedule_reads_a_host_step_counter():
    """The PS passes its 0-d int32 host tensor: the same value as the
    int."""
    import torch
    sched = tsched.cosine(0.1, 100, warmup_steps=10)
    for s in (0, 9, 10, 57):
        assert sched(torch.tensor(s, dtype=torch.int32)) == sched(s)


def test_checkpoint_helpers_match_jax():
    sched_t = tsched.cosine(0.1, 10)
    sched_j = jsched.cosine(0.1, 10)
    assert tsched.SCHEDULE_MARKER == jsched.SCHEDULE_MARKER
    base = dict(lr=0.1, momentum=0.9)
    for hyper_t, hyper_j in ((base, base),
                             (dict(base, lr=sched_t), dict(base, lr=sched_j))):
        assert (tsched.hyper_for_checkpoint(hyper_t)
                == jsched.hyper_for_checkpoint(hyper_j))
    saved = tsched.hyper_for_checkpoint(dict(base, lr=sched_t))
    # A marker restored into a scheduled optimizer keeps its schedule.
    assert tsched.hyper_from_checkpoint(saved, dict(lr=sched_t))["lr"] \
        is sched_t
    # A marker into a float-lr optimizer is refused, in both packages.
    for mod in (tsched, jsched):
        with pytest.raises(ValueError, match="lr schedule"):
            mod.hyper_from_checkpoint(saved, dict(lr=0.1))
    # A float checkpoint into a scheduled optimizer keeps the schedule.
    out = tsched.hyper_from_checkpoint(dict(lr=0.5, momentum=0.8),
                                       dict(lr=sched_t, momentum=0.9))
    assert out["lr"] is sched_t and out["momentum"] == 0.8
    assert tsched.resolve_hyper(dict(lr=sched_t), 3)["lr"] == sched_t(3)
