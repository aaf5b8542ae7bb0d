"""SGD with momentum, in the reference's form (PyTorch's, no dampening):
the first step's buffer is the gradient itself, later ones
``momentum * buf + d``; ``param - lr * buf``."""

from __future__ import annotations

from collections import OrderedDict


def step(params, grads, bufs, *, lr: float, momentum: float):
    if bufs is None:
        new_bufs = OrderedDict((n, g) for n, g in grads.items())
    else:
        new_bufs = OrderedDict((n, momentum * bufs[n] + grads[n])
                               for n in grads)
    new_params = OrderedDict((n, p - lr * new_bufs[n])
                             for n, p in params.items())
    return new_params, new_bufs
