"""Weights from the seed, made on the device in a few calls, and the
generators that each use of the seed draws from.

The weights follow flax's initialisers (what the port's models use):
LeCun normal truncated at two deviations for kernels, ``1/sqrt(features)``
for embedding tables, ones for norm scales (zeros where the
configuration's ``zero_init`` names them), zeros for biases.  A kernel's
fan-in is the product of its shape after the first axis, unless the
model's family gives its own (``families/<model>.py::fan_in``).  Each
family makes its own batches (``batch_pool``), from `generator`.  The same
seed gives the same tensors on any card.
"""

from __future__ import annotations

import math
import re
from collections import OrderedDict

import torch

from . import spec

# Seeds reach 2**31 and beyond; a generator takes any 64-bit value.
_MASK = (1 << 63) - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator of its own for each use (weights, each batch), so that
    one use never shifts another's numbers."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) & _MASK)
    return g


def _lecun_std(fan_in: int) -> float:
    # flax variance_scaling(1, fan_in, truncated_normal): the deviation of
    # the untruncated normal, corrected for the cut at two deviations.
    return math.sqrt(1.0 / fan_in) / 0.87962566103423978


def default_fan_in(name: str, shape: tuple) -> int:
    """A kernel's fan-in in the port's layouts: ``(out, in)`` dense and
    ``OIHW`` convolution kernels."""
    return math.prod(shape[1:])


def init_weights(shapes: "OrderedDict[str, tuple]", config: dict, seed: int,
                 device) -> "OrderedDict[str, torch.Tensor]":
    """f32 weights for the leaves ``shapes`` (name -> shape): every random
    leaf is a slice of one normal draw, scaled in place."""
    fan_in = getattr(spec.family(config["model"]), "fan_in", default_fan_in)
    zero = [re.compile(p) for p in config.get("zero_init", ())]
    embed = re.compile(config.get("embedding_pattern", r"$^"))
    random = [(n, s) for n, s in shapes.items() if len(s) >= 2]
    total = sum(math.prod(s) for _, s in random)
    draw = torch.randn(total, generator=generator(seed, 0, device),
                       device=device, dtype=torch.float32)
    out, at = OrderedDict(), 0
    views = {}
    for n, s in random:
        k = math.prod(s)
        w = draw[at:at + k].view(s)
        at += k
        if embed.search(n):
            w.mul_(1.0 / math.sqrt(s[1]))
        else:
            std = _lecun_std(fan_in(n, s))
            w.clamp_(-2.0, 2.0).mul_(std)
        views[n] = w
    for n, s in shapes.items():
        if n in views:
            out[n] = views[n]
        elif n.endswith("bias") or any(z.search(n) for z in zero):
            out[n] = torch.zeros(s, device=device)
        else:
            out[n] = torch.ones(s, device=device)
    return out


def init_aux(shapes: "OrderedDict[str, tuple]", device):
    """BatchNorm statistics: running means 0, running variances 1."""
    return OrderedDict(
        (n, (torch.ones if n.endswith("running_var") else torch.zeros)(
            s, device=device)) for n, s in shapes.items())
