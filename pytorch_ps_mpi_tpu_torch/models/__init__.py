"""Model zoo + glue to the named-parameter PS API.

Counterpart of `pytorch_ps_mpi_tpu/models/__init__.py`: `build_model`
initialises a module into flat named params plus its BatchNorm statistics
(``aux``), and `make_classifier_loss` turns a classifier into the
``loss_fn`` that ``MPI_PS.compile_step`` binds; `eval_accuracy` scores a
classifier in evaluation mode.  The transformer LM has its own `build_lm`,
`make_lm_loss` and `lm_batch`.
"""

from __future__ import annotations

import copy
import threading
from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch.func import functional_call

from .lenet import LeNet5
from .mlp import init_mlp, mlp_apply, mlp_loss_fn
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34,
                     resnet50)
from .transformer import (Block, PDense, TransformerLM, build_lm, lm_batch,
                          make_lm_loss)

__all__ = [
    "BasicBlock", "BottleneckBlock", "ResNet", "resnet18", "resnet34",
    "resnet50", "LeNet5",
    "init_mlp", "mlp_apply", "mlp_loss_fn",
    "PDense", "Block", "TransformerLM", "build_lm", "make_lm_loss",
    "lm_batch",
    "build_model", "cross_entropy", "make_classifier_loss", "eval_accuracy",
    "per_thread",
]


def per_thread(model: torch.nn.Module):
    """A getter of the module a thread may run `functional_call` on.

    `torch.func.functional_call` swaps the module's tensors for the
    call's duration, so two threads calling it on one module race (the
    async PS's workers do).  The thread that made the getter gets
    ``model`` itself; any other thread gets its own copy, made once, on
    first use, whose parameters are storage-free placeholders on the
    ``meta`` device (every call passes the real ones), so a copy costs
    the module's structure and buffers only."""
    owner = threading.get_ident()
    local = threading.local()
    lock = threading.Lock()

    def module() -> torch.nn.Module:
        if threading.get_ident() == owner:
            return model
        mine = getattr(local, "module", None)
        if mine is None:
            with lock:
                memo = {id(p): torch.nn.Parameter(
                    torch.empty_like(p, device="meta"),
                    requires_grad=p.requires_grad)
                    for p in model.parameters()}
                mine = copy.deepcopy(model, memo)
            local.module = mine
        return mine

    return module


def build_model(model: torch.nn.Module, seed: int = 0):
    """Initialise ``model`` from ``seed`` -> ``(named_params, aux)``: two
    ordered dicts of detached CPU tensors, the parameters and the
    BatchNorm running statistics ({} for stat-less models)."""
    model.reset_parameters(torch.Generator().manual_seed(seed))
    params = OrderedDict((n, p.detach().clone())
                         for n, p in model.named_parameters())
    aux = OrderedDict((n, b.detach().clone())
                      for n, b in model.named_buffers())
    return params, aux


def cross_entropy(logits, labels_int):
    """Mean negative log-likelihood of integer labels."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return -logp.gather(-1, labels_int.long()[:, None]).mean()


def make_classifier_loss(model: torch.nn.Module, *,
                         has_aux: bool | None = None):
    """Build the ``loss_fn`` MPI_PS consumes from a classifier module.

    Returns ``(loss_fn, has_aux)``: ``loss_fn(params, batch)`` for
    stat-less models, or ``loss_fn(params, aux, batch) -> (loss,
    new_aux)`` when the model carries BatchNorm statistics (``has_aux``
    defaults to whether it has buffers).  The module runs in training mode
    through `torch.func.functional_call`, so the parameters and statistics
    passed in are the ones used; ``aux`` is left as it is and the updated
    statistics come back as ``new_aux``.  Each thread runs its own copy of
    the module (`per_thread`), so worker threads may call the loss at
    once."""
    if has_aux is None:
        has_aux = any(True for _ in model.buffers())
    model.train()
    module = per_thread(model)

    def loss_plain(params_named, batch):
        logits = functional_call(module(), dict(params_named), (batch["x"],))
        return cross_entropy(logits, batch["y"])

    def loss_aux(params_named, aux, batch):
        new_aux = OrderedDict((n, t.clone()) for n, t in aux.items())
        logits = functional_call(module(), {**params_named, **new_aux},
                                 (batch["x"],))
        return cross_entropy(logits, batch["y"]), new_aux

    return (loss_aux, True) if has_aux else (loss_plain, False)


def eval_accuracy(model: torch.nn.Module, params_named, aux, batches) -> float:
    """Top-1 accuracy of ``model`` over an iterable of ``{"x", "y"}``
    batches, in evaluation mode: BatchNorm normalises with the running
    statistics ``aux`` (nothing is updated).  ``params_named`` are the
    weights to score (the EMA weights, when the caller has them); the
    batches go to their device."""
    device = next(iter(params_named.values())).device
    was_training = model.training
    model.eval()
    correct = total = 0
    try:
        with torch.no_grad():
            for b in batches:
                x = torch.as_tensor(b["x"]).to(device)
                logits = functional_call(model, {**params_named, **aux},
                                         (x,))
                pred = logits.argmax(-1).cpu()
                y = torch.as_tensor(b["y"]).long()
                correct += int((pred == y).sum())
                total += int(y.shape[0])
    finally:
        model.train(was_training)
    return correct / max(total, 1)
