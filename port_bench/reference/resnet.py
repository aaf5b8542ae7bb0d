"""ResNet-18 (He et al. 2016) in its CIFAR form, in plain float32 PyTorch.

NHWC images; a 3x3 stem with no max-pool; four stages of two basic blocks
(64, 128, 256, 512 filters, stride 2 at the first block of stages 2-4, a
1x1 projection where the shape changes); BatchNorm with the batch's
statistics (eps 1e-5, training mode); global mean pool, a dense head and
the mean cross-entropy.  Convolutions pad "SAME" as flax does: at stride 2
on an even input the padding is ``(0, 1)``.  ``rnd`` (the identity, or the
control's rounding) is applied where the configuration computes in its
lower precision: each convolution's operands and output; BatchNorm and
the head stay in float32.
"""

from __future__ import annotations

import torch.nn.functional as F

CHUNK_ROWS = None  # BatchNorm takes its statistics over the whole shard
EPS = 1e-5


def _same(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(rnd, x, w, stride):
    k = w.shape[-1]
    t, b = _same(x.shape[-2], k, stride)
    l, r = _same(x.shape[-1], k, stride)
    return rnd(F.conv2d(F.pad(rnd(x), (l, r, t, b)), rnd(w), stride=stride))


def _bn(x, w, b):
    return F.batch_norm(x, None, None, w, b, training=True, eps=EPS)


def _block(rnd, w, p, x, stride, project):
    y = F.relu(_bn(_conv(rnd, x, w[p + "Conv_0.weight"], stride),
                   w[p + "BatchNorm_0.weight"], w[p + "BatchNorm_0.bias"]))
    y = _bn(_conv(rnd, y, w[p + "Conv_1.weight"], 1),
            w[p + "BatchNorm_1.weight"], w[p + "BatchNorm_1.bias"])
    if project:
        x = _bn(_conv(rnd, x, w[p + "Conv_2.weight"], stride),
                w[p + "BatchNorm_2.weight"], w[p + "BatchNorm_2.bias"])
    return F.relu(y + x)


def logits(config: dict, w, images, rnd):
    x = images.permute(0, 3, 1, 2)
    x = F.relu(_bn(_conv(rnd, x, w["Conv_0.weight"], 1),
                   w["BatchNorm_0.weight"], w["BatchNorm_0.bias"]))
    k, in_ch = 0, 64
    for stage, blocks in enumerate(config["stage_sizes"]):
        filters = 64 * 2 ** stage
        for j in range(blocks):
            stride = 2 if stage > 0 and j == 0 else 1
            x = _block(rnd, w, f"BasicBlock_{k}.", x, stride,
                       stride != 1 or in_ch != filters)
            k, in_ch = k + 1, filters
    x = x.mean(dim=(2, 3))
    return x @ w["Dense_0.weight"].t() + w["Dense_0.bias"]


def loss_sum(config: dict, w, batch, rnd):
    out = logits(config, w, batch["x"], rnd)
    return F.cross_entropy(out, batch["y"].long(), reduction="sum")


def count(batch) -> int:
    return batch["y"].numel()
