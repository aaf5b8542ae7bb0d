"""Weights and batches from the seed, made on the device in a few calls.

The generators are copies of the port's ``data/datasets.py`` functions
``synthetic_classification`` and ``synthetic_lm``, rewritten in torch so
that they run where the batch is used: class-structured Gaussian blobs for
the image models, token rows that follow ``t+1 = 5t+3 mod vocab`` with a
little noise for the LM.  The weights follow flax's initialisers (what the
port's models use): LeCun normal truncated at two deviations for kernels,
``1/sqrt(features)`` for embedding tables, ones for norm scales (zeros
where the configuration's ``zero_init`` names them), zeros for biases.
The same seed gives the same tensors on any card.
"""

from __future__ import annotations

import math
import re
from collections import OrderedDict

import torch

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


def init_weights(shapes: "OrderedDict[str, tuple]", config: dict, seed: int,
                 device) -> "OrderedDict[str, torch.Tensor]":
    """f32 weights for the leaves ``shapes`` (name -> shape): every random
    leaf is a slice of one normal draw, scaled in place."""
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
            std = _lecun_std(math.prod(s[1:]))
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


def classification_pool(traffic: dict, config: dict, seed: int,
                        device) -> "list[dict]":
    """``pool`` global batches of ``{"x": [B, *image] f32, "y": [B] int32}``:
    ``y`` uniform over the classes, ``x = mu_y + noise * N(0, 1)`` with one
    set of class means for all the batches (``synthetic_classification``)."""
    shape = tuple(config["image"])
    classes = int(config["num_classes"])
    b = int(traffic["batch_per_rank"]) * int(traffic.get("world", 1))
    d = math.prod(shape)
    g = generator(seed, 1, device)
    mus = torch.randn(classes, d, generator=g, device=device)
    pool = []
    for i in range(int(traffic["pool"])):
        g = generator(seed, 2 + i, device)
        y = torch.randint(0, classes, (b,), generator=g, device=device)
        x = mus[y] + float(traffic["noise"]) * torch.randn(
            b, d, generator=g, device=device)
        pool.append({"x": x.view(b, *shape), "y": y.to(torch.int32)})
    return pool


def lm_rows(n: int, seq_len: int, vocab: int, noise: float,
            g: torch.Generator, device) -> torch.Tensor:
    """``[n, seq_len + 1]`` int64 token rows (``synthetic_lm``): a uniform
    first token, then ``t+1 = (5t + 3) mod vocab``, then each token
    replaced by a uniform one with probability ``noise``.  The recurrence
    in closed form, ``t_k = (a_k t_0 + b_k) mod vocab``, with its
    coefficients worked out on the host in exact integers."""
    a, b, coef = 1, 0, []
    for _ in range(seq_len + 1):
        coef.append((a, b))
        a, b = (5 * a) % vocab, (5 * b + 3) % vocab
    ab = torch.tensor(coef, dtype=torch.int64, device=device)
    t0 = torch.randint(0, vocab, (n, 1), generator=g, device=device)
    toks = (ab[:, 0][None] * t0 + ab[:, 1][None]) % vocab
    flip = torch.rand(toks.shape, generator=g, device=device) < noise
    fresh = torch.randint(0, vocab, toks.shape, generator=g, device=device)
    return torch.where(flip, fresh, toks)


def lm_pool(traffic: dict, config: dict, seed: int, device) -> "list[dict]":
    """``pool`` global batches ``{tokens, targets, positions}`` (int32
    ``[B, S]``, targets shifted before sharding), as ``lm_batch`` makes
    them."""
    b = int(traffic["batch_per_rank"]) * int(traffic.get("world", 1))
    s = int(traffic["seq_len"])
    pool = []
    for i in range(int(traffic["pool"])):
        rows = lm_rows(b, s, int(config["vocab_size"]),
                       float(traffic["noise"]),
                       generator(seed, 2 + i, device), device)
        pool.append({
            "tokens": rows[:, :-1].to(torch.int32).contiguous(),
            "targets": rows[:, 1:].to(torch.int32).contiguous(),
            "positions": torch.arange(s, dtype=torch.int32, device=device)
            .expand(b, s).contiguous()})
    return pool


def batch_pool(traffic: dict, config: dict, seed: int, device):
    if config["model"] == "lm":
        return lm_pool(traffic, config, seed, device)
    return classification_pool(traffic, config, seed, device)


def items_per_batch(traffic: dict) -> int:
    """What a global batch counts toward the cell's rate: tokens for the
    LM, images otherwise."""
    b = int(traffic["batch_per_rank"]) * int(traffic.get("world", 1))
    return b * int(traffic.get("seq_len", 1))
