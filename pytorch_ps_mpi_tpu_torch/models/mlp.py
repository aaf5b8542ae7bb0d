"""Plain MLP over a parameter dict — the smallest model.

Counterpart of `pytorch_ps_mpi_tpu/models/mlp.py`: the same numpy
initialisation and the same ``dense{i}/kernel`` ``(in, out)`` layout in
both packages, so one dict of arrays serves both.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch.nn.functional as F


def init_mlp(rng: np.random.RandomState, sizes=(784, 128, 10)):
    """He-initialized weights as flat named numpy params."""
    params = OrderedDict()
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        scale = np.sqrt(2.0 / fan_in)
        # astype LAST: randn output is f64 and multiplying an f32 array by a
        # python-float scale silently upcasts back to f64.
        params[f"dense{i}/kernel"] = (
            rng.randn(fan_in, fan_out) * scale).astype(np.float32)
        params[f"dense{i}/bias"] = np.zeros(fan_out, np.float32)
    return params


def mlp_apply(params, x):
    n_layers = sum(1 for k in params if k.endswith("/kernel"))
    h = x.reshape(x.shape[0], -1)
    for i in range(n_layers):
        h = h @ params[f"dense{i}/kernel"] + params[f"dense{i}/bias"]
        if i < n_layers - 1:
            h = F.relu(h)
    return h


def mlp_loss_fn(params, batch):
    logp = F.log_softmax(mlp_apply(params, batch["x"]), dim=-1)
    return -logp.gather(-1, batch["y"].long()[:, None]).mean()
