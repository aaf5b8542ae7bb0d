"""LeNet-5 for MNIST — the smallest convolutional model of the CLI.

Counterpart of `pytorch_ps_mpi_tpu/models/lenet.py` (flax).  What carries
over, so that the same weights give the same function:

* inputs are NHWC at the public call, as in JAX; the convolutions run on
  the NCHW view (channels-last in memory), as `resnet.ResNet` does;
* conv 1 is ``SAME`` and conv 2 ``VALID``, both with a bias; the pools are
  2x2 average pools of stride 2;
* flax flattens NHWC, so ``Dense_0``'s 400 inputs are in H, W, C order:
  the activations go back to NHWC before the flatten, and
  `utils.interop.params_from_jax` and ``jax_order`` need no LeNet rule;
* parameters are f32 and the convolutions and the first two Dense layers
  compute in ``dtype``; the classifier head computes in f32;
* submodules carry flax's names (``Conv_0``, ``Conv_1``, ``Dense_0`` ..
  ``Dense_2``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import Conv, Dense


class LeNet5(nn.Module):
    def __init__(self, num_classes: int = 10, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv(1, 6, 5, padding="SAME", dtype=dtype,
                           use_bias=True)
        self.Conv_1 = Conv(6, 16, 5, padding=((0, 0), (0, 0)), dtype=dtype,
                           use_bias=True)
        self.Dense_0 = Dense(16 * 5 * 5, 120, dtype)
        self.Dense_1 = Dense(120, 84, dtype)
        self.Dense_2 = Dense(84, num_classes)

    def reset_parameters(self, generator) -> None:
        """Initialise as flax does, drawing from ``generator`` (the draws
        differ from flax's: carry exact weights across with
        `utils.interop.params_from_jax`)."""
        for m in self.children():
            m.reset_parameters(generator)

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW view
        x = F.avg_pool2d(F.relu(self.Conv_0(x)), 2, 2)
        x = F.avg_pool2d(F.relu(self.Conv_1(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's HWC order
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)
