"""Rank functions of the multi-rank LM tests (`tests/test_torch_mesh.py`,
`test_torch_seq_parallel.py`, `test_torch_model_parallel.py`,
`test_torch_parallel_cli.py`), run on every rank of a gloo world through
`torch_dist_helpers.run_world("torch_mesh_helpers:<name>", ...)`.

Every rank builds every mesh (a mesh's groups are made collectively over
the world); a rank outside a mesh (``mesh.coords is None``) skips its
cases and returns None for them.  Inputs arrive as numpy, results go back
as numpy.  This module imports no JAX.
"""

from __future__ import annotations

import functools
import itertools
from collections import OrderedDict

import numpy as np
import torch
import torch.distributed as dist

CPU = dict(device="cpu")


def _np(t):
    return t.detach().to(torch.float32).numpy().copy()


def _tree_np(tree):
    return {k: _np(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Meshes and the tree collectives
# ---------------------------------------------------------------------------

MESHES = {
    "ps4": ("make_ps_mesh", (), {}),
    "ps2": ("make_ps_mesh", (2,), {}),
    "dp_sp": ("make_dp_sp_mesh", (2, 2), {}),
    "dp_tp": ("make_dp_tp_mesh", (None, 2), {}),
    "dp_ep": ("make_dp_ep_mesh", (1, 4), {}),
    "dp_pp": ("make_dp_pp_mesh", (None, 2), {}),
    "dp_sp_tp": ("make_dp_sp_tp_mesh", (1, 2, 2), {}),
    "dp_pp_tp": ("make_dp_pp_tp_mesh", (1, 2, 2), {}),
    "hybrid": ("make_hybrid_mesh", (2,), {}),
}

# Arguments each constructor refuses on a world of 4.
REFUSALS = {
    "too_many": ("make_ps_mesh", (5,), {}),
    "dp_x_product": ("make_dp_sp_mesh", (3, 2), {}),
    "dp_x_degree": ("make_dp_tp_mesh", (1, 0), {}),
    "dp_x_empty": ("make_dp_pp_mesh", (None, 8), {}),
    "sp_tp_product": ("make_dp_sp_tp_mesh", (2, 2, 2), {}),
    "pp_tp_product": ("make_dp_pp_tp_mesh", (1, 4, 2), {}),
    "hybrid_split": ("make_hybrid_mesh", (3,), {}),
}


def _subsets(names):
    return [s for k in range(1, len(names) + 1)
            for s in itertools.combinations(names, k)]


def mesh_layouts(rank, world):
    """Each mesh of `MESHES`: this rank's coordinate, `describe_mesh`,
    `world_size`, and for every axis and tuple of axes the index, size and
    the rank and size of its process group; each call of `REFUSALS`'s
    message."""
    from pytorch_ps_mpi_tpu_torch.parallel import mesh as M

    out = {"layouts": {}, "refusals": {}}
    for name, (fn, args, kw) in MESHES.items():
        m = getattr(M, fn)(*args, **kw, **CPU)
        rec = {"coords": m.coords, "describe": M.describe_mesh(m),
               "world_size": M.world_size(m, m.axis_names[0])}
        if m.coords is not None:
            rec["axes"] = {
                s: {"index": m.axis_index(s), "size": m.axis_size(s),
                    "group_rank": dist.get_rank(m.group(s)),
                    "group_size": dist.get_world_size(m.group(s))}
                for s in _subsets(m.axis_names)}
        out["layouts"][name] = rec
    for name, (fn, args, kw) in REFUSALS.items():
        try:
            getattr(M, fn)(*args, **kw, **CPU)
            out["refusals"][name] = None
        except ValueError as e:
            out["refusals"][name] = str(e)
    return out


def tree_collectives(rank, world, inputs):
    """The in-step tree collectives of `parallel.collectives` on this
    rank's slice of ``inputs`` (leading dim: the rank), over the 4-rank
    ``ps`` mesh, the tuple ``("ps", "tp")`` and ``"tp"`` of a 2 x 2 mesh;
    and the gradients of psum, ppermute and all_to_all (world 2 on the
    first two ranks, and a 4-rank ring)."""
    from pytorch_ps_mpi_tpu_torch.parallel import collectives as C
    from pytorch_ps_mpi_tpu_torch.parallel import mesh as M

    def mine(key):
        return torch.from_numpy(inputs[key][rank].copy())

    out = {}
    ps4 = M.make_ps_mesh(**CPU)
    ps2 = M.make_ps_mesh(2, **CPU)
    dp_tp = M.make_dp_tp_mesh(2, 2, **CPU)
    tree = {"a": mine("a"), "b": mine("b")}
    with ps4:
        out["psum"] = _tree_np(C.psum_tree(tree, "ps"))
        out["pmean"] = _tree_np(C.pmean_tree(tree, "ps"))
        out["allgather"] = _tree_np(C.allgather_tree(tree, "ps"))
        out["allgather_tiled"] = _tree_np(C.allgather_tree(tree, "ps",
                                                           tiled=True))
        out["bcast"] = _tree_np(C.bcast_tree(tree, "ps", root=1))
        flags = {"f": mine("a") > 0}
        got = C.bcast_tree(flags, "ps", root=2)["f"]
        out["bcast_bool"] = {"f": got.numpy().copy(),
                             "dtype": str(got.dtype)}
        out["reduce_scatter"] = _tree_np(C.reduce_scatter_tree(tree, "ps"))
        out["alltoall"] = _tree_np(C.alltoall_tree(tree, "ps"))
        out["ppermute"] = _tree_np(C.ppermute_tree(
            tree, "ps", [(0, 2), (2, 1), (1, 0)]))
        out["ring_shift"] = _tree_np(C.ring_shift_tree(tree, "ps", shift=3))
        out["rank"] = C.rank("ps")
        # A 4-rank ring's gradients.
        x = mine("a").requires_grad_()
        y = C.ppermute(x, "ps", [(i, (i + 1) % 4) for i in range(4)])
        (g,) = torch.autograd.grad((y * mine("w")).sum(), x)
        out["grad_ring"] = _np(g)
    with dp_tp:
        out["psum_tuple"] = _tree_np(C.psum_tree(tree, ("ps", "tp")))
        out["pmean_tp"] = _tree_np(C.pmean_tree(tree, "tp"))
        out["allgather_tuple"] = _tree_np(C.allgather_tree(tree,
                                                           ("ps", "tp")))
        out["rank_tuple"] = C.rank(("ps", "tp"))
    if ps2.coords is not None:
        with ps2:
            grads = {}
            ops = {
                "psum": lambda x: C.psum(x, "ps"),
                "ppermute": lambda x: C.ppermute(x, "ps", [(0, 1)]),
                "all_to_all": lambda x: C.all_to_all(x, "ps", 0, 1,
                                                     tiled=True),
                "pmean": lambda x: C.pmean_tree({"x": x}, "ps")["x"],
            }
            for name, op in ops.items():
                x = mine("a").requires_grad_()
                y = op(x)
                w = torch.from_numpy(inputs["w_" + name][rank].copy())
                (g,) = torch.autograd.grad((y * w).sum(), x)
                grads[name] = {"y": _np(y), "grad": _np(g)}
            out["grads"] = grads
    return out


# ---------------------------------------------------------------------------
# Ring and Ulysses attention
# ---------------------------------------------------------------------------


def attention_cases(rank, world, cases):
    """For each case ``name -> (kind, n, q, k, v, do, kwargs)`` (global
    ``[B, S, H, D]`` arrays, ``do`` the output cotangent): this rank's
    output shard and its shards of dq, dk, dv, over the sp axis of a
    ``(1, n)`` mesh; the refusals' messages for ``"refuse"`` cases."""
    from pytorch_ps_mpi_tpu_torch.ops.flash_attention import flash_attention
    from pytorch_ps_mpi_tpu_torch.parallel import mesh as M
    from pytorch_ps_mpi_tpu_torch.parallel.ring_attention import (
        make_ring_attention, ring_attention)
    from pytorch_ps_mpi_tpu_torch.parallel.ulysses import (
        make_ulysses_attention, ulysses_attention)

    meshes = {n: M.make_dp_sp_mesh(1, n, **CPU) for n in (2, 4)}
    out = {}
    for name, (kind, n, q, k, v, do, kw) in cases.items():
        mesh = meshes[n]
        if mesh.coords is None:
            out[name] = None
            continue
        me = mesh.axis_index("sp")
        s = q.shape[1] // n

        def shard(a):
            return torch.from_numpy(a[:, me * s:(me + 1) * s].copy())

        qs, ks, vs = (shard(a).requires_grad_() for a in (q, k, v))
        kw = dict(kw)
        if kind == "ring":
            fn = functools.partial(ring_attention, axis="sp", **kw)
        elif kind == "ring_bound":
            fn = make_ring_attention(mesh, axis="sp", **kw)
        elif kind == "ulysses_bound":
            fn = make_ulysses_attention(mesh, axis="sp", **kw)
        else:
            inner = flash_attention if kw.pop("flash", False) else None
            fn = functools.partial(ulysses_attention, axis="sp",
                                   inner=inner, **kw)
        with mesh:
            if kind == "refuse":
                try:
                    ulysses_attention(qs, ks, vs, axis="sp")
                    out[name] = None
                except ValueError as e:
                    out[name] = str(e)
                continue
            o = fn(qs, ks, vs)
            grads = torch.autograd.grad((o * shard(do)).sum(),
                                        [qs, ks, vs])
        out[name] = {"o": _np(o), "dq": _np(grads[0]), "dk": _np(grads[1]),
                     "dv": _np(grads[2]), "dtype": str(o.dtype)}
    # Ulysses' head round trip: the two all-to-alls invert each other
    # bitwise.
    from pytorch_ps_mpi_tpu_torch.parallel.collectives import all_to_all

    mesh = meshes[2]
    if mesh.coords is not None:
        with mesh:
            x = torch.from_numpy(np.random.RandomState(rank).randn(
                2, 3, 4, 5).astype(np.float32))
            back = all_to_all(all_to_all(x, "sp", 2, 1, tiled=True), "sp",
                              1, 2, tiled=True)
            out["round_trip"] = bool(torch.equal(back, x))
    return out


# ---------------------------------------------------------------------------
# Tensor, pipeline and expert parallelism; MPI_PS over a mesh
# ---------------------------------------------------------------------------

# The LM of these tests.
LM = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
          max_len=64)


def port_model(spec):
    """The port's LM of ``spec["model"]``: `LM` with ``tp_axis``,
    ``ep_axis``, ``moe_experts``, ``moe_capacity`` and ``attn`` (None,
    ``"ring"``, ``"ulysses"`` or ``"ulysses_flash"``) as given."""
    from pytorch_ps_mpi_tpu_torch.ops.flash_attention import flash_attention
    from pytorch_ps_mpi_tpu_torch.models.transformer import TransformerLM
    from pytorch_ps_mpi_tpu_torch.parallel.ring_attention import (
        ring_attention)
    from pytorch_ps_mpi_tpu_torch.parallel.ulysses import ulysses_attention

    kw = dict(spec.get("model", {}))
    attn = kw.pop("attn", None)
    if attn == "ring":
        kw["attn"] = functools.partial(ring_attention, axis="sp",
                                       causal=True)
    elif attn is not None:
        kw["attn"] = functools.partial(
            ulysses_attention, axis="sp", causal=True,
            inner=flash_attention if attn == "ulysses_flash" else None)
    return TransformerLM(**LM, **kw)


def build_mesh(spec):
    from pytorch_ps_mpi_tpu_torch.parallel import mesh as M

    fn, args = spec["mesh"]
    return getattr(M, fn)(*args, **CPU)


def lm_runs(rank, world, specs):
    """For each spec (name -> dict, in order): `MPI_PS` SGD(lr 0.05,
    momentum 0.9) over ``spec["mesh"]`` (a mesh constructor and its arguments) with
    ``spec["kwargs"]`` (``axis``, ``batch_spec``, ``code``, ``sync_mode``,
    ``zero``, ...), the LM of `port_model` and `make_lm_loss` (or, with
    ``spec["n_micro"]``, `make_pipelined_lm_loss`), from ``spec["params"]``
    or from the state dict an earlier spec named by ``spec["load"]`` kept
    after ``spec["save_after"]`` steps; a step a batch of
    ``spec["batches"]``.  Returns the losses and the final params (None on
    a rank outside the mesh)."""
    from pytorch_ps_mpi_tpu_torch import SGD
    from pytorch_ps_mpi_tpu_torch.models.pipelined import (
        make_pipelined_lm_loss)
    from pytorch_ps_mpi_tpu_torch.models.transformer import make_lm_loss

    out, saved = {}, {}
    for name, spec in specs.items():
        mesh = build_mesh(spec)
        if mesh.coords is None:
            out[name] = None
            continue
        model = port_model(spec)
        opt = SGD(list(spec["params"].items()), lr=0.05, momentum=0.9,
                  mesh=mesh, **spec.get("kwargs", {}))
        if "n_micro" in spec:
            loss_fn = make_pipelined_lm_loss(model, n_micro=spec["n_micro"])
        else:
            loss_fn = make_lm_loss(model)
        opt.compile_step(loss_fn)
        if spec.get("load"):
            opt.load_state_dict(saved[spec["load"]])
        losses, each = [], []
        for i, b in enumerate(spec["batches"]):
            losses.append(opt.step(b)[0])
            each.append(_tree_np(opt.params))
            if spec.get("save_after") == i + 1:
                saved[name] = opt.state_dict()
        out[name] = {"losses": losses, "params": each[-1], "each": each,
                     "world_size": opt.world_size,
                     "topology": opt.state_dict()["topology"]}
    return out


def tp_grads(rank, world, params, batch):
    """This rank's loss and raw gradients (before any PS reduction) of the
    tp=2 LM on a ``(1, 2)`` ``(ps, tp)`` mesh, and the param names and
    shapes of the tp model."""
    from pytorch_ps_mpi_tpu_torch.models.transformer import make_lm_loss
    from pytorch_ps_mpi_tpu_torch.parallel import mesh as M

    mesh = M.make_dp_tp_mesh(1, 2, **CPU)
    model = port_model({"model": dict(tp_axis="tp")})
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    if mesh.coords is None:
        return {"shapes": shapes}
    leaves = OrderedDict((n, torch.as_tensor(p).clone().requires_grad_())
                         for n, p in params.items())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with mesh:
        loss = make_lm_loss(model)(leaves, tb)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return {"loss": float(loss.detach()), "shapes": shapes,
            "grads": {n: _np(g) for n, g in zip(leaves, grads)}}


def pipeline_cases(rank, world, W, x, w, micro):
    """`pipeline_apply` of a stack of ``tanh(h @ W[l])`` stages at pp 2
    (`stage_slice` of ``W``): this rank's output and its gradients of
    ``sum(y * w)`` with respect to ``W`` and ``x``, for each microbatch
    count of ``micro``; and the refusals of a batch that does not split
    and of a stage that changes the shape."""
    from pytorch_ps_mpi_tpu_torch.parallel import mesh as M
    from pytorch_ps_mpi_tpu_torch.parallel.pipeline import (pipeline_apply,
                                                            stage_slice)

    mesh = M.make_dp_pp_mesh(1, 2, **CPU)
    if mesh.coords is None:
        return None
    out = {}
    for m in micro:
        Wt = torch.from_numpy(W.copy()).requires_grad_()
        xt = torch.from_numpy(x.copy()).requires_grad_()
        with mesh:
            mine = stage_slice({"W": Wt}, "pp")["W"]

            def stage_fn(h):
                for j in range(mine.shape[0]):
                    h = torch.tanh(h @ mine[j])
                return h

            y = pipeline_apply(stage_fn, xt, axis="pp", n_micro=m)
            gW, gx = torch.autograd.grad((y * torch.from_numpy(w)).sum(),
                                         [Wt, xt])
        out[m] = {"y": _np(y), "gW": _np(gW), "gx": _np(gx)}
    refusals = {}
    with mesh:
        for key, call in (
                ("split", lambda: pipeline_apply(
                    lambda h: h, torch.zeros(3, 2), axis="pp", n_micro=2)),
                ("shape", lambda: pipeline_apply(
                    lambda h: h[:, :1], torch.zeros(4, 2), axis="pp")),
                ("micro", lambda: pipeline_apply(
                    lambda h: h, torch.zeros(4, 2), axis="pp", n_micro=0)),
                ("layers", lambda: stage_slice({"W": torch.zeros(3, 2)},
                                               "pp"))):
            try:
                call()
                refusals[key] = None
            except ValueError as e:
                refusals[key] = str(e)
    out["refusals"] = refusals
    return out


def cli_mesh_runs(rank, world, runs):
    """The port's training CLI in-process on this rank, once per argv of
    ``runs`` (name -> argv), with its stderr kept: each run's log (rank
    0's) and final params."""
    import contextlib
    import io

    from pytorch_ps_mpi_tpu_torch import train

    out = {}
    for name, argv in runs.items():
        log = io.StringIO()
        with contextlib.redirect_stderr(log):
            opt = train.main(list(argv))
        out[name] = {"log": log.getvalue(), "params": _tree_np(opt.params)}
    return out
