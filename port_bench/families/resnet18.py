"""ResNet-18: the port's ``resnet18`` with its classifier loss and
BatchNorm statistics, ``synthetic_classification`` image blobs (a copy of
the port's ``data/datasets.py`` generator, rewritten in torch to run where
the batch is used) and the step's FLOPs."""

from __future__ import annotations

import math

import torch

from .. import data


def build(config: dict, dtype):
    from pytorch_ps_mpi_tpu_torch.models import resnet18

    return resnet18(num_classes=config["num_classes"],
                    small_inputs=config["small_inputs"], dtype=dtype)


def bind_loss(opt, module, aux) -> None:
    from pytorch_ps_mpi_tpu_torch.models import make_classifier_loss

    loss_fn, has_aux = make_classifier_loss(module, has_aux=True)
    opt.compile_step(loss_fn, has_aux=has_aux, aux=aux)


def batch_pool(traffic: dict, config: dict, seed: int,
               device) -> "list[dict]":
    """``pool`` global batches of ``{"x": [B, *image] f32, "y": [B] int32}``:
    ``y`` uniform over the classes, ``x = mu_y + noise * N(0, 1)`` with one
    set of class means for all the batches (``synthetic_classification``)."""
    shape = tuple(config["image"])
    classes = int(config["num_classes"])
    b = int(traffic["batch_per_rank"]) * int(traffic.get("world", 1))
    d = math.prod(shape)
    g = data.generator(seed, 1, device)
    mus = torch.randn(classes, d, generator=g, device=device)
    pool = []
    for i in range(int(traffic["pool"])):
        g = data.generator(seed, 2 + i, device)
        y = torch.randint(0, classes, (b,), generator=g, device=device)
        x = mus[y] + float(traffic["noise"]) * torch.randn(
            b, d, generator=g, device=device)
        pool.append({"x": x.view(b, *shape), "y": y.to(torch.int32)})
    return pool


def items_per_batch(traffic: dict) -> int:
    """Images of a global batch."""
    return int(traffic["batch_per_rank"]) * int(traffic.get("world", 1))


def resnet_macs_per_image(c: dict) -> int:
    """Multiply-adds of one image through the CIFAR-form ResNet with basic
    blocks: the 3x3 stem, each block's two 3x3 convolutions and its 1x1
    projection where the shape changes, and the dense head."""
    h, w, ch = c["image"]
    macs = h * w * ch * 64 * 9
    in_ch = 64
    for stage, blocks in enumerate(c["stage_sizes"]):
        filters = 64 * 2 ** stage
        for j in range(blocks):
            stride = 2 if stage > 0 and j == 0 else 1
            h, w = -(-h // stride), -(-w // stride)
            macs += h * w * in_ch * filters * 9
            macs += h * w * filters * filters * 9
            if stride != 1 or in_ch != filters:
                macs += h * w * in_ch * filters
            in_ch = filters
    return macs + in_ch * c["num_classes"]


def step_flops(config: dict, traffic: dict) -> float:
    """Every convolution and dense layer's multiply-adds times two times
    three, for one rank's images."""
    return 3.0 * 2.0 * resnet_macs_per_image(config) \
        * int(traffic["batch_per_rank"])
