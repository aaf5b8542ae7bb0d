"""Synthetic datasets + batch iteration (numpy only).

Counterpart of `pytorch_ps_mpi_tpu/data/datasets.py`, copied: the same
seed gives the same arrays in both packages.  Class-structured Gaussian
blobs shaped like MNIST/CIFAR/ImageNet, so small models genuinely learn,
token rows with next-token structure for the LM, and an iterator of global
batches whose leading dim shards evenly across ranks.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def synthetic_classification(n: int, input_shape, num_classes: int,
                             seed: int = 0, noise: float = 1.0):
    """Gaussian class-blob images: y ~ uniform classes, x = mu_y + noise."""
    rng = np.random.RandomState(seed)
    d = int(np.prod(input_shape))
    mus = rng.randn(num_classes, d).astype(np.float32)
    y = rng.randint(0, num_classes, size=n)
    x = mus[y] + noise * rng.randn(n, d).astype(np.float32)
    return x.reshape((n, *input_shape)), y.astype(np.int32)


def synthetic_mnist(n: int = 4096, seed: int = 0):
    return synthetic_classification(n, (28, 28, 1), 10, seed)


def synthetic_cifar10(n: int = 4096, seed: int = 0):
    return synthetic_classification(n, (32, 32, 3), 10, seed)


def synthetic_imagenet(n: int = 512, seed: int = 0, num_classes: int = 1000):
    return synthetic_classification(n, (224, 224, 3), num_classes, seed)


def synthetic_lm(n: int = 2048, seq_len: int = 128, vocab: int = 256,
                 seed: int = 0, noise: float = 0.02):
    """Token rows ``[n, seq_len + 1]`` following an affine recurrence
    (t+1 = 5t+3 mod vocab) with a little noise — enough next-token structure
    that a small LM's loss drops well below uniform entropy."""
    rng = np.random.RandomState(seed)
    rows = [rng.randint(0, vocab, size=(n, 1))]
    for _ in range(seq_len):
        rows.append((rows[-1] * 5 + 3) % vocab)
    toks = np.concatenate(rows, axis=1)
    flip = rng.rand(*toks.shape) < noise
    toks[flip] = rng.randint(0, vocab, size=int(flip.sum()))
    return toks.astype(np.int32)


def batches(x: np.ndarray, y: np.ndarray, batch_size: int, *,
            world_size: int = 1, seed: int = 0,
            drop_remainder: bool = True) -> Iterator[dict]:
    """Shuffle + iterate global batches; batch_size must divide by world_size
    (each rank gets batch_size/world_size examples)."""
    if batch_size % world_size:
        raise ValueError(
            f"batch_size {batch_size} not divisible by world size {world_size}")
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(x))
    for i in range(0, len(idx) - (batch_size - 1 if drop_remainder else 0),
                   batch_size):
        take = idx[i:i + batch_size]
        yield {"x": x[take], "y": y[take]}
