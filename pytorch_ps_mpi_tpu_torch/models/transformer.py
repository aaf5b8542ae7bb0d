"""Decoder-only transformer LM — the long-context model family.

Counterpart of `pytorch_ps_mpi_tpu/models/transformer.py` (flax), for its
dense path: pre-LN blocks, learned positional embeddings, parameters in
f32 and matmuls in ``dtype`` (bf16 on the card).  The attention is
pluggable (``attn=``): causal `dense_attention` by default, or
``functools.partial(flash_attention, causal=True)`` on the kernels.

``moe_experts=E`` replaces each block's MLP with a dense mixture of
experts (`models.moe.MoEMLP`, every expert local), whose Switch
load-balance losses `make_lm_loss` adds.  Tensor parallelism (``tp_axis``)
and expert parallelism (``ep_axis``) are not ported yet and raise.

What carries over, so that the same weights give the same function:

* submodules carry flax's names (``tok_embed``, ``pos_embed``,
  ``block_{i}`` with ``LayerNorm_0``, ``qkv``, ``out``, ``LayerNorm_1``,
  ``fc1``, ``fc2`` or ``moe``, then ``LayerNorm_0`` and ``lm_head``), so
  `utils.interop.params_from_jax` maps the names one to one;
* flax ``LayerNorm`` has eps 1e-6 (torch's default is 1e-5) and takes its
  statistics in f32 whatever the input's dtype;
* flax ``nn.gelu`` is the tanh approximation;
* ``PDense`` computes ``x @ W`` in ``dtype`` and then adds the bias cast to
  ``dtype`` as a separate op, not a fused ``addmm``;
* the QKV projection's columns are laid out per head as ``[q | k | v]``
  blocks (``view(b, s, h, 3, dh)``);
* flax ``Embed`` casts the f32 table to ``dtype`` before the gather;
* the residual stream is in ``dtype``; the final LayerNorm and the
  ``lm_head`` run in f32.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Callable

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from ..parallel.ring_attention import dense_attention
from .moe import MoEMLP
from .resnet import _lecun_std, _trunc_normal_

LN_EPS = 1e-6  # flax nn.LayerNorm's default


class PDense(nn.Module):
    """flax ``PDense`` without tensor parallelism: ``x @ kernel + bias``
    with the product in ``dtype``; ``weight`` is ``(out, in)`` f32."""

    def __init__(self, in_features: int, features: int,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features))
        self.dtype = dtype

    def reset_parameters(self, generator) -> None:
        _trunc_normal_(self.weight, _lecun_std(self.weight.shape[1]),
                       generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        return y + self.bias.to(self.dtype)


class Embed(nn.Module):
    """flax ``nn.Embed``: the ``(num, features)`` f32 table, cast to
    ``dtype`` before the gather; initialised from a normal of std
    ``1/sqrt(features)`` (flax's ``variance_scaling(1, fan_in, normal,
    out_axis=0)``)."""

    def __init__(self, num: int, features: int, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, features))
        self.dtype = dtype

    def reset_parameters(self, generator) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 / math.sqrt(self.weight.shape[1]),
                                generator=generator)

    def forward(self, idx):
        return F.embedding(idx, self.weight.to(self.dtype))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=...)``: mean and variance in f32, eps 1e-6,
    f32 ``weight`` (flax ``scale``) and ``bias``, output in ``dtype``."""

    def __init__(self, features: int, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.dtype = dtype

    def reset_parameters(self, generator=None) -> None:
        del generator  # constant initialisers
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        y = F.layer_norm(x.to(torch.float32), self.weight.shape, self.weight,
                         self.bias, eps=LN_EPS)
        return y.to(self.dtype)


class Block(nn.Module):
    """Pre-LN block: ``x + attn(LN(x))``, then ``x + MLP(LN(x))``;
    ``forward`` returns the new residual stream and the MoE's aux loss
    (None for the dense MLP)."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, dtype,
                 attn: Callable, moe_experts: int = 0,
                 moe_capacity: float = 1.25):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} not divisible by n_heads "
                             f"{n_heads}")
        self.n_heads, self.attn = n_heads, attn
        self.LayerNorm_0 = LayerNorm(d_model, dtype)
        self.qkv = PDense(d_model, 3 * d_model, dtype)
        self.out = PDense(d_model, d_model, dtype)
        self.LayerNorm_1 = LayerNorm(d_model, dtype)
        if moe_experts:
            self.moe = MoEMLP(d_model, d_ff, moe_experts, moe_capacity,
                              dtype)
        else:
            self.fc1 = PDense(d_model, d_ff, dtype)
            self.fc2 = PDense(d_ff, d_model, dtype)

    def forward(self, x):
        b, s, d = x.shape
        h = self.n_heads
        qkv = self.qkv(self.LayerNorm_0(x)).view(b, s, h, 3, d // h)
        q, k, v = qkv.unbind(3)
        y = self.attn(q, k, v).reshape(b, s, d)
        x = x + self.out(y)
        y = self.LayerNorm_1(x)
        if hasattr(self, "moe"):
            y, aux = self.moe(y)
            return x + y, aux
        return x + self.fc2(F.gelu(self.fc1(y), approximate="tanh")), None


def _causal_dense(q, k, v):
    return dense_attention(q, k, v, causal=True)


class TransformerLM(nn.Module):
    """``forward(tokens, positions=None) -> logits`` (f32 ``[B, S,
    vocab]``).  ``positions`` are global position ids, ``arange(S)`` when
    not given.  ``moe_experts=E`` (> 0) gives every block a dense MoE MLP
    of ``E`` experts and capacity factor ``moe_capacity``; then
    ``forward(..., return_aux=True)`` returns ``(logits, aux)``, the sum
    of the blocks' load-balance losses."""

    def __init__(self, vocab_size: int, d_model: int = 128, n_heads: int = 4,
                 n_layers: int = 2, d_ff: int = 512, max_len: int = 2048,
                 dtype=torch.float32, attn: Callable | None = None,
                 tp_axis: str | None = None, moe_experts: int = 0,
                 moe_capacity: float = 1.25, ep_axis: str | None = None):
        super().__init__()
        if tp_axis is not None or ep_axis is not None:
            raise NotImplementedError(
                "tp_axis= and ep_axis= are not ported to the PyTorch "
                "package yet (the multi-rank LM paths, tp/sp/ep/pp, "
                "follow)")
        attn = _causal_dense if attn is None else attn
        self.tok_embed = Embed(vocab_size, d_model, dtype)
        self.pos_embed = Embed(max_len, d_model, dtype)
        for i in range(n_layers):
            self.add_module(f"block_{i}", Block(
                d_model, n_heads, d_ff, dtype, attn, moe_experts,
                moe_capacity))
        self.n_layers = n_layers
        self.moe_experts = moe_experts
        self.LayerNorm_0 = LayerNorm(d_model, torch.float32)
        self.lm_head = PDense(d_model, vocab_size, torch.float32)

    def reset_parameters(self, generator) -> None:
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, tokens, positions=None, return_aux: bool = False):
        if positions is None:
            positions = torch.arange(tokens.shape[1],
                                     device=tokens.device)[None, :]
        x = self.tok_embed(tokens) + self.pos_embed(positions)
        auxes = {}
        for i in range(self.n_layers):
            name = f"block_{i}"
            x, auxes[name] = getattr(self, name)(x)
        logits = self.lm_head(self.LayerNorm_0(x))
        if not return_aux:
            return logits
        # Summed in the JAX tree's leaf order (block names sorted as
        # strings), from 0 as Python's ``sum`` starts.
        return logits, sum(auxes[n] for n in sorted(auxes))


def build_lm(model: TransformerLM,
             seed: int = 0) -> "OrderedDict[str, torch.Tensor]":
    """Initialise ``model`` from ``seed`` -> flat named params (detached
    CPU tensors), like `models.build_model`."""
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return OrderedDict((n, p.detach().clone())
                       for n, p in model.named_parameters())


def make_lm_loss(model: TransformerLM, *, aux_weight: float = 0.01):
    """Next-token cross-entropy, ``loss_fn(params, batch)``.  ``batch``:
    ``tokens``/``targets``/``positions``, all ``[B, S]`` integers, targets
    shifted before any sharding.  An MoE model adds ``aux_weight`` times
    the blocks' load-balance losses.  Each thread runs its own copy of the
    module (`models.per_thread`), so the async PS's worker threads may
    call the loss at once."""
    from . import per_thread

    module = per_thread(model)
    moe = bool(model.moe_experts)

    def loss_fn(params_named, batch):
        out = functional_call(module(), dict(params_named),
                              (batch["tokens"], batch["positions"]),
                              {"return_aux": moe})
        logits, aux = out if moe else (out, None)
        loss = F.cross_entropy(logits.flatten(0, -2),
                               batch["targets"].flatten().long())
        return loss if aux is None else loss + aux_weight * aux

    return loss_fn


def lm_batch(tokens) -> dict:
    """The ``{tokens, targets, positions}`` dict (int32 numpy) from raw
    token rows ``[B, S+1]`` (global, before sharding)."""
    tokens = np.asarray(tokens)
    b, s1 = tokens.shape
    return {
        "tokens": tokens[:, :-1].astype(np.int32),
        "targets": tokens[:, 1:].astype(np.int32),
        "positions": np.broadcast_to(np.arange(s1 - 1, dtype=np.int32),
                                     (b, s1 - 1)).copy(),
    }
