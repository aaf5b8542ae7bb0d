"""The decoder-only LM, written out in plain float32 PyTorch.

Pre-LN blocks with learned positions: ``x = tok[t] + pos[p]``; each block
``x += out(attn(LN0(x)))``, ``x += fc2(gelu_tanh(fc1(LN1(x))))``; then
``logits = lm_head(LN(x))`` and the mean next-token cross-entropy.
LayerNorm has eps 1e-6; the fused QKV projection's columns are laid out
per head as ``[q | k | v]`` blocks; attention is causal softmax attention
with scale ``1/sqrt(head size)``.  ``rnd`` (the identity, or the
control's rounding) is applied wherever the configuration computes in its
lower precision: every block matmul's operands and output, the embedded
input, the residual stream, the blocks' LayerNorm outputs, the attention's
operands and output, and the GELU; the final LayerNorm and the
``lm_head`` stay in float32, as the configuration states.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

CHUNK_ROWS = 8  # rows are independent: the loss is taken 8 rows at a time
EPS = 1e-6


def _dense(rnd, x, w, b):
    return rnd(rnd(x) @ rnd(w).t() + b)


def _ln(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps=EPS)


def _attention(rnd, q, k, v):
    # q, k, v: [B, S, H, D] -> [B, S, H, D]
    d = q.shape[-1]
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    scores = rnd(q) @ rnd(k).transpose(-1, -2) / math.sqrt(d)
    s = scores.shape[-1]
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return rnd(rnd(probs) @ rnd(v)).transpose(1, 2)


def logits(config: dict, w, tokens, positions, rnd):
    h = config["n_heads"]
    x = rnd(w["tok_embed.weight"][tokens.long()]
            + w["pos_embed.weight"][positions.long()])
    b, s, dm = x.shape
    for i in range(config["n_layers"]):
        p = f"block_{i}."
        y = rnd(_ln(x, w[p + "LayerNorm_0.weight"],
                    w[p + "LayerNorm_0.bias"]))
        qkv = _dense(rnd, y, w[p + "qkv.weight"], w[p + "qkv.bias"])
        q, k, v = qkv.view(b, s, h, 3, dm // h).unbind(3)
        y = _attention(rnd, q, k, v).reshape(b, s, dm)
        x = rnd(x + _dense(rnd, y, w[p + "out.weight"], w[p + "out.bias"]))
        y = rnd(_ln(x, w[p + "LayerNorm_1.weight"],
                    w[p + "LayerNorm_1.bias"]))
        y = rnd(F.gelu(_dense(rnd, y, w[p + "fc1.weight"],
                              w[p + "fc1.bias"]), approximate="tanh"))
        x = rnd(x + _dense(rnd, y, w[p + "fc2.weight"], w[p + "fc2.bias"]))
    x = _ln(x, w["LayerNorm_0.weight"], w["LayerNorm_0.bias"])
    return x @ w["lm_head.weight"].t() + w["lm_head.bias"]


def loss_sum(config: dict, w, batch, rnd):
    """The summed cross-entropy over the batch's tokens."""
    out = logits(config, w, batch["tokens"], batch["positions"], rnd)
    return F.cross_entropy(out.flatten(0, 1),
                           batch["targets"].flatten().long(),
                           reduction="sum")


def count(batch) -> int:
    return batch["targets"].numel()
