"""ResNet-18/34/50 — the benchmark models of the sync PS step.

Counterpart of `pytorch_ps_mpi_tpu/models/resnet.py` (flax).  What carries
over, so that the same weights give the same function:

* inputs are NHWC at the public call, as in JAX; the module permutes them
  to NCHW inside, which leaves them channels-last in memory;
* parameters are f32; convolutions compute in ``dtype`` (bf16 on the
  card), BatchNorm and the classifier head in f32;
* submodules carry flax's auto-names (``Conv_0``, ``BatchNorm_0``,
  ``BasicBlock_0`` or ``BottleneckBlock_0``, ``Dense_0``), so
  ``named_parameters()`` lines up with
  the names `build_model` gives in the JAX package (``.`` for ``/``,
  ``weight`` for ``kernel``/``scale``);
* the last BatchNorm of each block starts at zero scale;
* flax ``padding="SAME"`` is asymmetric at stride 2 on an even input
  (``(0, 1)``: 32 -> 16), so the padding is computed with the general
  formula and applied with ``F.pad`` where it is not symmetric;
* flax BatchNorm keeps the *biased* batch variance in its running ``var``
  (``ra = 0.9*ra + 0.1*batch``); ``nn.BatchNorm2d`` would keep the
  unbiased one, so `BatchNorm` rescales the kernel's unbiased variance by
  ``(n-1)/n`` before it updates the running statistics.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def _trunc_normal_(t: torch.Tensor, std: float, generator) -> None:
    """flax ``lecun_normal``: a normal truncated at ±2 std, drawn by the
    inverse CDF from uniforms of ``generator``."""
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, \
        (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    with torch.no_grad():
        t.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
        t.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)


def _lecun_std(fan_in: int) -> float:
    # variance_scaling(1.0, "fan_in", "truncated_normal"): the std of the
    # untruncated normal is corrected for the truncation.
    return math.sqrt(1.0 / fan_in) / 0.87962566103423978


def _same_pads(size: int, k: int, stride: int) -> "tuple[int, int]":
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv``: f32 OIHW weight (and, with ``use_bias``, an f32
    bias, zero-initialised, added in ``dtype`` after the convolution),
    computed in ``dtype``; ``padding`` is ``"SAME"`` or an explicit
    ``(lo, hi)`` per spatial dim."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding="SAME", dtype=torch.float32, use_bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.register_parameter(
            "bias", nn.Parameter(torch.empty(out_ch)) if use_bias else None)
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.dtype = dtype

    def reset_parameters(self, generator) -> None:
        fan_in = self.weight.shape[1] * self.kernel * self.kernel
        _trunc_normal_(self.weight, _lecun_std(fan_in), generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        if self.padding == "SAME":
            (t, b), (l, r) = (_same_pads(s, self.kernel, self.stride)
                              for s in x.shape[-2:])
        else:
            (t, b), (l, r) = self.padding
        x = x.to(self.dtype)
        w = self.weight.to(self.dtype)
        if t == b and l == r:
            y = F.conv2d(x, w, stride=self.stride, padding=(t, l))
        else:
            y = F.conv2d(F.pad(x, (l, r, t, b)), w, stride=self.stride)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)[:, None, None]
        return y


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=f32)`` over
    NCHW: normalises in f32 with the batch statistics in training and the
    running ones in evaluation; training updates ``running_mean`` and
    ``running_var`` in place with the batch mean and *biased* variance."""

    def __init__(self, features: int, zero_scale: bool = False,
                 momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.zero_scale, self.momentum, self.eps = zero_scale, momentum, eps

    def reset_parameters(self, generator=None) -> None:
        del generator  # constant initialisers
        with torch.no_grad():
            self.weight.fill_(0.0 if self.zero_scale else 1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x):
        x = x.to(torch.float32)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, training=False,
                                eps=self.eps)
        # With momentum 1.0 the kernel writes this batch's mean and
        # unbiased variance into the two scratch vectors, from the pass it
        # makes anyway; a separate reduction for the statistics would read
        # every activation once more.
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, training=True,
                         momentum=1.0, eps=self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var
                                   + (1.0 - m) * (var * ((n - 1) / n)))
        return y


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=dtype)``, f32 unless ``dtype`` says otherwise;
    the weight is torch's ``(out, in)``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        self.dtype = dtype

    def reset_parameters(self, generator) -> None:
        _trunc_normal_(self.weight, _lecun_std(self.weight.shape[1]),
                       generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, filters: int, strides: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_ch, filters, 3, strides, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(filters, zero_scale=True)
        # flax projects the shortcut when the shapes differ, which for the
        # inputs these models take is exactly when the block strides or
        # widens.
        self.project = strides != 1 or in_ch != filters
        if self.project:
            self.Conv_2 = Conv(in_ch, filters, 1, strides, dtype=dtype)
            self.BatchNorm_2 = BatchNorm(filters)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = self.BatchNorm_2(self.Conv_2(x)) if self.project else x
        return F.relu(y + residual)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 to ``4 * filters`` channels; the last
    BatchNorm starts at zero scale (flax ``scale_init=zeros``)."""

    expansion = 4

    def __init__(self, in_ch: int, filters: int, strides: int = 1,
                 dtype=torch.float32):
        super().__init__()
        out_ch = filters * self.expansion
        self.Conv_0 = Conv(in_ch, filters, 1, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3, strides, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(filters)
        self.Conv_2 = Conv(filters, out_ch, 1, dtype=dtype)
        self.BatchNorm_2 = BatchNorm(out_ch, zero_scale=True)
        self.project = strides != 1 or in_ch != out_ch
        if self.project:
            self.Conv_3 = Conv(in_ch, out_ch, 1, strides, dtype=dtype)
            self.BatchNorm_3 = BatchNorm(out_ch)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = self.BatchNorm_3(self.Conv_3(x)) if self.project else x
        return F.relu(y + residual)


class ResNet(nn.Module):
    """``ResNet(stage_sizes, block)`` of `BasicBlock` or `BottleneckBlock`;
    ``small_inputs`` selects the CIFAR stem (3x3/stride 1, no max-pool) over
    the ImageNet one (7x7/stride 2 + 3x3/stride 2 max-pool).  Call it on
    NHWC images."""

    def __init__(self, stage_sizes: Sequence[int], block: type = BasicBlock,
                 num_classes: int = 10, small_inputs: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.small_inputs = small_inputs
        if small_inputs:
            self.Conv_0 = Conv(3, 64, 3, dtype=dtype)
        else:
            self.Conv_0 = Conv(3, 64, 7, 2, padding=((3, 3), (3, 3)),
                               dtype=dtype)
        self.BatchNorm_0 = BatchNorm(64)
        expansion = getattr(block, "expansion", 1)
        in_ch, k = 64, 0
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                strides = 2 if i > 0 and j == 0 else 1
                self.add_module(f"{block.__name__}_{k}",
                                block(in_ch, 64 * 2 ** i, strides, dtype))
                in_ch, k = 64 * 2 ** i * expansion, k + 1
        self.block_names = [f"{block.__name__}_{i}" for i in range(k)]
        self.Dense_0 = Dense(in_ch, num_classes)

    def reset_parameters(self, generator) -> None:
        """Initialise every parameter and statistic as flax does, drawing
        from ``generator`` (the draws differ from flax's: carry exact
        weights across with `utils.interop.params_from_jax`)."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW, channels-last in memory
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        if not self.small_inputs:
            t, b = _same_pads(x.shape[-2], 3, 2)
            l, r = _same_pads(x.shape[-1], 3, 2)
            x = F.max_pool2d(F.pad(x, (l, r, t, b), value=-math.inf), 3, 2)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.Dense_0(x.mean(dim=(2, 3)))


def resnet18(num_classes=10, small_inputs=True, dtype=torch.float32):
    return ResNet((2, 2, 2, 2), BasicBlock, num_classes, small_inputs, dtype)


def resnet34(num_classes=10, small_inputs=True, dtype=torch.float32):
    return ResNet((3, 4, 6, 3), BasicBlock, num_classes, small_inputs, dtype)


def resnet50(num_classes=1000, small_inputs=False, dtype=torch.float32):
    return ResNet((3, 4, 6, 3), BottleneckBlock, num_classes, small_inputs,
                  dtype)
