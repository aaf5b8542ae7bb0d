"""Mixture-of-experts MLP (Switch-style top-1), dense: every expert local.

Counterpart of `pytorch_ps_mpi_tpu/models/moe.py` without its expert
parallelism (``ep_axis``, the tokens' all-to-all over an ``ep`` group),
which waits for the multi-rank LM slice and raises here.

Static-shape dispatch, as the JAX layer does it:

1. an f32 router picks one expert per token (the first of equal
   probabilities, as ``argmax`` does); the gate is that expert's softmax
   probability;
2. every expert has ``C = ceil(T * capacity_factor / E)`` slots; a
   token's slot is its position among the tokens of its expert (a one-hot
   ``cumsum`` in f32), and a token past the capacity is dropped: it goes to
   the spare bin ``E * C`` and passes on the residual branch only;
3. the kept tokens fill a ``[E, C, d]`` dispatch buffer, each expert's
   two-layer MLP (tanh GELU) runs as one batched product pair, and each
   token takes its slot's output scaled by its gate.

The dispatch buffer is filled by ``index_put(accumulate=True)``: a kept
slot receives exactly one token (its sum is that token, in any order), and
the spare bin, which takes every dropped token, is thrown away.  No atomic
decides a kept value.  The Switch load-balance loss (``E * sum_e
frac_tokens_e * frac_probs_e``) is returned beside the output, for the
trainer to add (`models.transformer.make_lm_loss`).

The parameters keep flax's expert-major layout and names (``router``
``(d, E)``, ``w1`` ``(E, d, d_ff)``, ``b1``, ``w2`` ``(E, d_ff, d)``,
``b2``), so `utils.interop.params_from_jax` carries them across as they
are and a codec sees them in the JAX package's element order.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import _lecun_std, _trunc_normal_


class MoEMLP(nn.Module):
    """Drop-in MLP: ``forward(x [B, S, d]) -> (y [B, S, d], aux_loss)``,
    ``y`` in ``x``'s dtype, the products in ``dtype``."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int,
                 capacity_factor: float = 1.25, dtype=torch.float32,
                 ep_axis: "str | None" = None):
        super().__init__()
        if ep_axis is not None:
            raise NotImplementedError(
                "ep_axis= (experts sharded over an ep group) is not ported "
                "to the PyTorch package yet (the multi-rank LM paths, "
                "tp/sp/ep/pp, follow); ep_axis=None runs every expert "
                "locally")
        E = n_experts
        self.n_experts, self.capacity_factor = E, capacity_factor
        self.dtype = dtype
        self.router = nn.Parameter(torch.empty(d_model, E))
        self.w1 = nn.Parameter(torch.empty(E, d_model, d_ff))
        self.b1 = nn.Parameter(torch.empty(E, d_ff))
        self.w2 = nn.Parameter(torch.empty(E, d_ff, d_model))
        self.b2 = nn.Parameter(torch.empty(E, d_model))

    def reset_parameters(self, generator) -> None:
        """flax ``lecun_normal`` on the router and the expert kernels (the
        fan-in of an ``(E, in, out)`` kernel is ``E * in``, flax's
        receptive-field rule), zero biases."""
        E = self.n_experts
        _trunc_normal_(self.router, _lecun_std(self.router.shape[0]),
                       generator)
        _trunc_normal_(self.w1, _lecun_std(E * self.w1.shape[1]), generator)
        _trunc_normal_(self.w2, _lecun_std(E * self.w2.shape[1]), generator)
        with torch.no_grad():
            self.b1.zero_()
            self.b2.zero_()

    def capacity(self, tokens: int) -> int:
        return max(1, math.ceil(tokens * self.capacity_factor
                                / self.n_experts))

    def route(self, toks: torch.Tensor):
        """``(probs, expert, onehot, gate, slot, keep)`` of ``toks [T,
        d]``: slot ``E * C`` is the spare bin of the dropped tokens."""
        E = self.n_experts
        T = toks.shape[0]
        probs = F.softmax(toks.to(torch.float32) @ self.router, dim=-1)
        expert = torch.argmax(probs, dim=-1)
        gate = probs.gather(1, expert[:, None])[:, 0]
        onehot = F.one_hot(expert, E).to(torch.float32)
        C = self.capacity(T)
        pos = ((torch.cumsum(onehot, dim=0) - 1.0) * onehot).sum(dim=1)
        keep = (pos < C).to(torch.float32)
        slot = expert * C + pos.to(torch.int64)
        slot = torch.where(keep > 0, slot, torch.full_like(slot, E * C))
        return probs, expert, onehot, gate, slot, keep

    def forward(self, x):
        b, s, d = x.shape
        E = self.n_experts
        toks = x.reshape(b * s, d)
        probs, _expert, onehot, gate, slot, keep = self.route(toks)
        aux_loss = E * torch.sum(onehot.mean(dim=0) * probs.mean(dim=0))
        C = self.capacity(b * s)
        dispatch = toks.new_zeros((E * C + 1, d)).index_put(
            (slot,), (toks * keep[:, None]).to(toks.dtype), accumulate=True)
        y = self._ffn(dispatch[:E * C].reshape(E, C, d))
        y = torch.cat([y.reshape(E * C, d), y.new_zeros((1, d))])
        out = y[slot] * (gate * keep)[:, None].to(y.dtype)
        return out.reshape(b, s, d).to(x.dtype), aux_loss

    def _ffn(self, xs):
        """Every expert's two-layer MLP on its ``[E, C, d]`` slots: one
        batched product pair, in ``dtype``."""
        dt = self.dtype
        h = (torch.einsum("etd,edf->etf", xs.to(dt), self.w1.to(dt))
             + self.b1[:, None].to(dt))
        h = F.gelu(h, approximate="tanh")
        return (torch.einsum("etf,efd->etd", h, self.w2.to(dt))
                + self.b2[:, None].to(dt))
