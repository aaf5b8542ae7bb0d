"""Mixture-of-experts MLP (Switch-style top-1), with expert parallelism.

Counterpart of `pytorch_ps_mpi_tpu/models/moe.py`.  With ``ep_axis=None``
every expert runs locally (the dense MoE); with a mesh axis the experts
shard over it (below).

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

Expert parallelism (``ep_axis``): ``ep`` is a **data** axis (tokens
shard over it; it belongs in `MPI_PS`'s ``axis`` tuple).  The capacity
``C`` comes from the rank's **local** token count, as in JAX.  The
dispatch buffer ``[E, C, d]`` is reshaped to ``[n, e_loc, C, d]`` and goes
through the differentiable all-to-all (untiled: chunk ``j`` goes to rank
``j``, the owner of experts ``[j*e_loc, (j+1)*e_loc)``); each rank runs
its ``e_loc`` experts on its slice of ``w1/b1/w2/b2`` over every rank's
tokens, and the inverse all-to-all brings the outputs back.  An expert
slice's gradient lives on its owner only; the PS step's sum over the data
axes assembles it.

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

from ..parallel.collectives import all_to_all
from ..parallel.mesh import axis_index, axis_size
from .resnet import _lecun_std, _trunc_normal_


class MoEMLP(nn.Module):
    """Drop-in MLP: ``forward(x [B, S, d]) -> (y [B, S, d], aux_loss)``,
    ``y`` in ``x``'s dtype, the products in ``dtype``."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int,
                 capacity_factor: float = 1.25, dtype=torch.float32,
                 ep_axis: "str | None" = None):
        super().__init__()
        E = n_experts
        self.n_experts, self.capacity_factor = E, capacity_factor
        self.dtype, self.ep_axis = dtype, ep_axis
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
        dispatch = dispatch[:E * C].reshape(E, C, d)
        params = (self.w1, self.b1, self.w2, self.b2)
        if self.ep_axis is None:
            y = self._ffn(dispatch, *params)                 # [E, C, d]
        else:
            n = axis_size(self.ep_axis)
            if E % n:
                raise ValueError(f"n_experts {E} not divisible by ep={n}")
            e_loc = E // n
            r = axis_index(self.ep_axis)
            # Send: chunk j of the dispatch buffer goes to rank j (owner of
            # experts [j*e_loc, (j+1)*e_loc)).  Receive: this rank's
            # experts' tokens from every rank, [n, e_loc, C, d].
            inbound = all_to_all(dispatch.reshape(n, e_loc, C, d),
                                 self.ep_axis, 0, 0, tiled=False)
            inbound = inbound.permute(1, 0, 2, 3).reshape(e_loc, n * C, d)
            mine = [w[r * e_loc:(r + 1) * e_loc] for w in params]
            y = self._ffn(inbound, *mine)                    # [e_loc, n*C, d]
            # Return: the inverse shuffle back to the tokens' ranks.
            y = y.reshape(e_loc, n, C, d).permute(1, 0, 2, 3)
            y = all_to_all(y, self.ep_axis, 0, 0, tiled=False)
            y = y.reshape(E, C, d)
        y = torch.cat([y.reshape(E * C, d), y.new_zeros((1, d))])
        out = y[slot] * (gate * keep)[:, None].to(y.dtype)
        return out.reshape(b, s, d).to(x.dtype), aux_loss

    def _ffn(self, xs, w1, b1, w2, b2):
        """Each expert's two-layer MLP on its ``[E', T, d]`` slots, with
        expert-major parameters: one batched product pair, in
        ``dtype``."""
        dt = self.dtype
        h = (torch.einsum("etd,edf->etf", xs.to(dt), w1.to(dt))
             + b1[:, None].to(dt))
        h = F.gelu(h, approximate="tanh")
        return (torch.einsum("etf,efd->etd", h, w2.to(dt))
                + b2[:, None].to(dt))
