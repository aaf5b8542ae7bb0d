"""Decoder-only transformer LM — the long-context model family.

Counterpart of `pytorch_ps_mpi_tpu/models/transformer.py` (flax), for its
dense path: pre-LN blocks, learned positional embeddings, parameters in
f32 and matmuls in ``dtype`` (bf16 on the card).  The attention is
pluggable (``attn=``): causal `dense_attention` by default, or
``functools.partial(flash_attention, causal=True)`` on the kernels.

``moe_experts=E`` replaces each block's MLP with a mixture of experts
(`models.moe.MoEMLP`), whose Switch load-balance losses `make_lm_loss`
adds; with ``ep_axis`` the experts shard over that mesh axis.

**Tensor parallelism** (``tp_axis=``) shards the *compute*
Megatron-style over a mesh axis: the fused QKV projection is
column-parallel with whole heads (its columns are ``[q|k|v]`` per head,
so a contiguous block of columns is a block of heads), the output
projection and ``fc2`` are row-parallel, closing with the differentiable
psum (`parallel.collectives.psum`), and ``fc1`` is column-parallel.
Parameter *storage* stays replicated, with the same names and shapes at
every tp degree; each rank slices its block out of the replicated
weights.  Every rank differentiates its own copy of the replicated loss,
and the transpose of the row-parallel psum is a psum, so each rank's
gradients come out ×tp on every path through the tp region; the PS
step's mean over the non-data mesh axes cancels that factor.  A
``tp_axis`` that names no axis of the current mesh raises.

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

from ..parallel.collectives import psum
from ..parallel.mesh import axis_index, axis_size
from ..parallel.ring_attention import dense_attention
from .moe import MoEMLP
from .resnet import _lecun_std, _trunc_normal_

LN_EPS = 1e-6  # flax nn.LayerNorm's default


class PDense(nn.Module):
    """flax ``PDense``: ``x @ kernel + bias`` with the product in
    ``dtype``; ``weight`` is ``(out, in)`` f32.

    ``mode=None``: the plain layer.  ``mode="column"``: only this tp
    rank's block of output features.  ``mode="row"``: consumes this
    rank's block of input features, psums the partial products across
    ``tp_axis`` and adds the (unsharded) bias once, after the sum.  The
    parameters are the same in every mode."""

    def __init__(self, in_features: int, features: int,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features))
        self.dtype = dtype
        self.features = features

    def reset_parameters(self, generator) -> None:
        _trunc_normal_(self.weight, _lecun_std(self.weight.shape[1]),
                       generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x, *, tp_axis: "str | None" = None,
                mode: "str | None" = None):
        weight = self.weight.to(self.dtype)
        x = x.to(self.dtype)
        if tp_axis is None or mode is None:
            return F.linear(x, weight) + self.bias.to(self.dtype)
        t = axis_index(tp_axis)
        n = axis_size(tp_axis)
        if mode == "column":
            if self.features % n:
                raise ValueError(
                    f"features {self.features} not divisible by tp={n}")
            blk = self.features // n
            y = F.linear(x, weight[t * blk:(t + 1) * blk])
            return y + self.bias[t * blk:(t + 1) * blk].to(self.dtype)
        if mode == "row":
            d_in = weight.shape[1]
            if d_in % n:
                raise ValueError(f"in_features {d_in} not divisible by "
                                 f"tp={n}")
            blk = d_in // n
            y = psum(F.linear(x, weight[:, t * blk:(t + 1) * blk]), tp_axis)
            # The bias is added once, after the psum (outside the tp
            # region).
            return y + self.bias.to(self.dtype)
        raise ValueError(f"unknown tp mode {mode!r}")


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
                 attn: Callable, *, tp_axis: "str | None" = None,
                 moe_experts: int = 0, moe_capacity: float = 1.25,
                 ep_axis: "str | None" = None):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} not divisible by n_heads "
                             f"{n_heads}")
        self.n_heads, self.attn, self.tp_axis = n_heads, attn, tp_axis
        self.LayerNorm_0 = LayerNorm(d_model, dtype)
        self.qkv = PDense(d_model, 3 * d_model, dtype)
        self.out = PDense(d_model, d_model, dtype)
        self.LayerNorm_1 = LayerNorm(d_model, dtype)
        if moe_experts:
            self.moe = MoEMLP(d_model, d_ff, moe_experts, moe_capacity,
                              dtype, ep_axis)
        else:
            self.fc1 = PDense(d_model, d_ff, dtype)
            self.fc2 = PDense(d_ff, d_model, dtype)

    def forward(self, x):
        b, s, d = x.shape
        h = self.n_heads
        tp = self.tp_axis
        n = axis_size(tp) if tp else 1
        if h % n:
            raise ValueError(f"n_heads {h} not divisible by tp={n}")
        h_local = h // n
        col = dict(tp_axis=tp, mode="column") if tp else {}
        row = dict(tp_axis=tp, mode="row") if tp else {}
        # Column-parallel QKV takes a contiguous block of whole heads.
        qkv = self.qkv(self.LayerNorm_0(x), **col).view(
            b, s, h_local, 3, d // h)
        q, k, v = qkv.unbind(3)
        y = self.attn(q, k, v).reshape(b, s, h_local * (d // h))
        x = x + self.out(y, **row)
        y = self.LayerNorm_1(x)
        if hasattr(self, "moe"):
            y, aux = self.moe(y)
            return x + y, aux
        y = F.gelu(self.fc1(y, **col), approximate="tanh")
        return x + self.fc2(y, **row), None


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
        # The constructor's arguments, for `copy`.
        self.config = dict(
            vocab_size=vocab_size, d_model=d_model, n_heads=n_heads,
            n_layers=n_layers, d_ff=d_ff, max_len=max_len, dtype=dtype,
            attn=attn, tp_axis=tp_axis, moe_experts=moe_experts,
            moe_capacity=moe_capacity, ep_axis=ep_axis)
        attn = _causal_dense if attn is None else attn
        self.attn = attn
        self.tok_embed = Embed(vocab_size, d_model, dtype)
        self.pos_embed = Embed(max_len, d_model, dtype)
        for i in range(n_layers):
            self.add_module(f"block_{i}", Block(
                d_model, n_heads, d_ff, dtype, attn, tp_axis=tp_axis,
                moe_experts=moe_experts, moe_capacity=moe_capacity,
                ep_axis=ep_axis))
        self.n_layers = n_layers
        self.d_model, self.dtype = d_model, dtype
        self.tp_axis, self.moe_experts = tp_axis, moe_experts
        self.LayerNorm_0 = LayerNorm(d_model, torch.float32)
        self.lm_head = PDense(d_model, vocab_size, torch.float32)

    def reset_parameters(self, generator) -> None:
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def copy(self, **overrides) -> "TransformerLM":
        """A new LM of this configuration with ``overrides`` (flax's
        ``Module.copy``): its parameters have the same names and shapes,
        so one set of named parameters serves both."""
        return TransformerLM(**{**self.config, **overrides})

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
