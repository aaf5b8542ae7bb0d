"""Pipeline-parallel execution of `TransformerLM` — same parameters, same
math, depth sharded over a ``pp`` mesh axis.

Counterpart of `pytorch_ps_mpi_tpu/models/pipelined.py`.  Storage stays
replicated (the PS model: checkpoints are pp-independent); the compute
splits by depth: pp rank ``r`` runs layers ``[r·L/pp, (r+1)·L/pp)``,
through the model's own ``block_{l}`` modules, and microbatched
activations ride the `parallel.pipeline` ppermute ring.

Gradient bookkeeping: the embeddings run on every rank and only stage 0
consumes them (the pipeline's input mask); the final LayerNorm and the
``lm_head`` run after the pipeline, and the scalar loss is masked to the
last stage (`last_stage_value`) — so every parameter's gradient is
single-owner ×pp, and the PS step's mean over the non-data axes recovers
the dense gradients.  A layer a rank never applies gets no gradient from
autograd where JAX's is zeros; the PS step fills such gradients with
zeros before the exchange.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch.func import functional_call

from ..parallel.mesh import axis_index, axis_size
from ..parallel.pipeline import last_stage_value, pipeline_apply
from . import per_thread
from .transformer import TransformerLM


def _sub(params_named, prefix: str) -> dict:
    return {n[len(prefix):]: v for n, v in params_named.items()
            if n.startswith(prefix)}


def make_pipelined_lm_loss(model: TransformerLM, *, pp_axis: str = "pp",
                           n_micro: int | None = None):
    """Next-token cross-entropy for ``model``, run pipeline-parallel over
    ``pp_axis``.  A drop-in for `make_lm_loss`: the same named parameters
    (the dense model's), the same batch dict, the same loss value — use
    with ``MPI_PS(..., mesh=make_dp_pp_mesh(dp, pp), batch_spec=("ps",))``.

    ``n_micro`` sets the microbatch count (default: the pp degree); the
    per-rank batch must split evenly.  MoE blocks are not pipelineable
    (their aux losses would need per-stage plumbing)."""
    if getattr(model, "moe_experts", 0):
        raise NotImplementedError(
            "pipeline parallelism with MoE blocks is not supported yet")
    module = per_thread(model)
    L = model.n_layers

    def loss_fn(params_named, batch):
        m = module()
        n = axis_size(pp_axis)
        r = axis_index(pp_axis)
        if L % n:
            raise ValueError(f"{L} layers do not split into {n} pipeline "
                             f"stages")
        lps = L // n
        tokens, positions = batch["tokens"], batch["positions"]
        # Embeddings — the dense model's modules, on every rank; only
        # stage 0 consumes the result (the pipeline's input mask).
        x = (functional_call(m.tok_embed, _sub(params_named, "tok_embed."),
                             (tokens,))
             + functional_call(m.pos_embed,
                               _sub(params_named, "pos_embed."),
                               (positions,)))

        def stage_fn(h):
            for l in range(r * lps, (r + 1) * lps):
                name = f"block_{l}"
                h, _ = functional_call(getattr(m, name),
                                       _sub(params_named, name + "."), (h,))
            return h

        y = pipeline_apply(stage_fn, x, axis=pp_axis, n_micro=n_micro)
        # The final LayerNorm and the head — the dense model's own.
        y = functional_call(m.LayerNorm_0, _sub(params_named, "LayerNorm_0."),
                            (y,))
        logits = functional_call(m.lm_head, _sub(params_named, "lm_head."),
                                 (y,))
        loss = F.cross_entropy(logits.flatten(0, -2),
                               batch["targets"].flatten().long())
        # Masked to the last stage: gradients stay single-owner and the
        # value is replicated.
        return last_stage_value(loss, pp_axis)

    return loss_fn
