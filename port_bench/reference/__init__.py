"""The plain reference: the training step in float32 plain PyTorch.

Independent of the program: it imports neither JAX, nor the JAX package,
nor anything of the port.  It takes the benchmark's weights and batches
(the same the program gets) and works out again whatever the program
derives from them: each rank's shard and gradient, the blockq codes and
their decoded sum over ranks (`blockq`), and the SGD-momentum update
(`sgd`).  Each model is written out in a file of its own,
``reference/<model>.py``, found by the configuration's ``model`` (`model`):
its ``CHUNK_ROWS`` (the rows a chunk of the shard's loss takes, None for
the whole shard at once), ``loss_sum(config, weights, batch, rnd)`` (the
summed loss over a chunk's items) and ``count(shard)`` (the items the
mean is over).

``precision="fp8"`` is the control, the step below the configurations'
bfloat16: wherever a configuration computes in bfloat16, the reference
rounds to float8 with a per-tensor scale, e4m3 going forward and e5m2 for
the gradient coming back (float8 training's usual pair).  TF32 is off in
both.
"""

from __future__ import annotations

import importlib
from collections import OrderedDict
from pathlib import Path

import torch

from . import blockq, sgd


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _scaled_round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` under a per-tensor scale that
    maps its largest magnitude to ``top``, back in x's dtype."""
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Float8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _scaled_round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, grad):
        return _scaled_round(grad, torch.float8_e5m2, 57344.0)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float8 e4m3, its gradient in float8 e5m2."""
    return _Float8.apply(x)


def _identity(x):
    return x


def operand_rounding(precision: str):
    if precision == "f32":
        return _identity
    if precision == "fp8":
        return fp8_round
    raise ValueError(f"no precision {precision!r}")


def model(name: str):
    """The plain model ``reference/<name>.py``."""
    path = Path(__file__).with_name(f"{name}.py")
    if not path.exists():
        raise ValueError(f"no reference model {name!r}: {path} missing")
    return importlib.import_module(f"{__name__}.{name}")


def shard_grad(config: dict, weights, batch, rows: slice,
               rnd) -> "tuple[float, OrderedDict]":
    """One rank's loss and gradient of the mean loss over its shard
    ``rows`` of the global batch, taken in chunks of the model's
    ``CHUNK_ROWS`` rows where it has one (each chunk's summed loss over
    the whole shard's count, gradients added)."""
    plain = model(config["model"])
    leaves = OrderedDict((n, w.detach().clone().requires_grad_())
                         for n, w in weights.items())
    shard = {k: v[rows] for k, v in batch.items()}
    n_rows = next(iter(shard.values())).shape[0]
    step = min(plain.CHUNK_ROWS or n_rows, n_rows)
    total = 0.0
    grads = None
    for lo in range(0, n_rows, step):
        part = {k: v[lo:lo + step] for k, v in shard.items()}
        loss = (plain.loss_sum(config, leaves, part, rnd)
                / plain.count(shard))
        g = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True, materialize_grads=True)
        total += float(loss.detach())
        grads = list(g) if grads is None else [a + b for a, b in
                                               zip(grads, g)]
    return total, OrderedDict(zip(leaves, grads))


def run(config: dict, traffic: dict, weights, batches, *, steps: int = 3,
        precision: str = "f32", fault: "str | None" = None) -> dict:
    """``steps`` synchronous steps of the plain reference from
    ``weights`` on ``batches`` (global batches, one a step).

    Returns ``losses`` (the mean over ranks of each shard's mean loss),
    ``grad_norms`` (the first decoded gradient's norm a leaf: what the
    optimizer gets), ``change_norms`` (each leaf's distance from
    ``weights`` after the steps) and ``step_grad_norms`` (a list a step of
    each leaf's decoded-gradient norm).

    ``fault`` plants one of the faults the comparison must catch:
    ``"half"`` takes each rank's loss over the first half of its shard
    only, ``"no_exchange"`` applies rank 0's decoded gradient alone."""
    tf32_off()
    rnd = operand_rounding(precision)
    world = int(traffic.get("world", 1))
    per = int(traffic["batch_per_rank"])
    lr, momentum = float(traffic["lr"]), float(traffic["momentum"])
    params = OrderedDict((n, w.detach().to(torch.float32).clone())
                         for n, w in weights.items())
    bufs = None
    losses, step_norms = [], []
    grad_norms = None
    for i in range(steps):
        batch = batches[i]
        rank_losses, decoded = [], []
        for r in range(world):
            take = per // 2 if fault == "half" else per
            rows = slice(r * per, r * per + take)
            loss, g = shard_grad(config, params, batch, rows, rnd)
            rank_losses.append(loss)
            decoded.append(blockq.roundtrip(g, bits=traffic["bits"]))
            del g
        ranks = decoded[:1] if fault == "no_exchange" else decoded
        d = blockq.sum_ranks(ranks)
        del decoded, ranks
        losses.append(sum(rank_losses) / world)
        norms = OrderedDict((n, float(torch.linalg.vector_norm(t)))
                            for n, t in d.items())
        step_norms.append(norms)
        if grad_norms is None:
            grad_norms = norms
        params, bufs = sgd.step(params, d, bufs, lr=lr, momentum=momentum)
        del d
    change = OrderedDict(
        (n, float(torch.linalg.vector_norm(params[n] - w.to(torch.float32))))
        for n, w in weights.items())
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change, "step_grad_norms": step_norms}

