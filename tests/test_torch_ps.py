"""The sync PS step of the port against the JAX package's, end to end.

A 3-step SGD(lr=0.1, momentum=0.9) trajectory at world 2: the JAX `SGD` on
the ``mesh2`` fixture (two virtual CPU devices), the port's `SGD` on two
spawned gloo ranks, from the same initialisation and the same global
batches:

* the identity codec on `ResNet((1, 1))` (f32, 8x8 inputs), weights and
  statistics carried across by `params_from_jax`;
* the blockq codec on the same ResNet at 1,024-element tiles
  (``block_rows=8``), so that its conv kernels span many tiles and the
  codes equal the JAX package's only if each gradient is quantized in
  flax's element order (`utils.interop.jax_order`);
* the blockq codec on the MLP (the same numpy parameters in both).

``msg_bytes``/``packaged_bytes`` must be equal exactly.  Parameters,
statistics and losses: ``rtol=1e-4, atol=1e-5`` for the ResNet — XLA and
PyTorch sum convolutions in other orders (a few ulps per op, see
``tests/test_torch_models.py``) and three steps of momentum carry that
forward; ``rtol=1e-5, atol=1e-6`` for the MLP, whose gradients differ by
ulps only (one matmul per layer) and whose blockq codes must then come
out the same, so the update matches to float32 rounding.  The blockq
ResNet is held to the same tolerance, except that at most one element in
10,000 may fall outside it: a gradient element within float32 noise of a
rounding boundary rounds to the neighbouring code in one package and not
the other (one element of the ~306,000 on this tree, 5.2e-5 apart).  A code
quantized in another element order moves a parameter by a quantum
(``lr * amax / 127``); on the parent of the element-order repair 8,279
elements fell outside the tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu import SGD as JSGD
from pytorch_ps_mpi_tpu import models as jmodels
from pytorch_ps_mpi_tpu.ops import codecs as jcodecs
from pytorch_ps_mpi_tpu_torch import SGD, Adam, AdamW, MPI_PS, NotCompiledError
from pytorch_ps_mpi_tpu_torch import models as tmodels
from pytorch_ps_mpi_tpu_torch.ops import codecs as tcodecs
from pytorch_ps_mpi_tpu_torch.utils.interop import params_from_jax

from torch_dist_helpers import run_world

WORLD = 2
STEPS = 3


def _jax_trajectory(mesh, named, aux, loss_fn, has_aux, batches, code):
    opt = JSGD(list(named.items()), lr=0.1, momentum=0.9, mesh=mesh,
               code=code)
    opt.compile_step(loss_fn, has_aux=has_aux, aux=aux)
    losses, metrics = [], []
    for b in batches:
        loss, m = opt.step(b)
        losses.append(loss)
        metrics.append(m)
    params = {n: np.asarray(p) for n, p in opt.params.items()}
    return losses, metrics, params, jax.tree.map(np.asarray, opt.aux)


def _batches(rng, shape, n_classes=10):
    return [{"x": rng.randn(8, *shape).astype(np.float32),
             "y": rng.randint(0, n_classes, 8).astype(np.int32)}
            for _ in range(STEPS)]


def _check_metrics(ours, ref):
    for m, jm in zip(ours, ref):
        assert m["msg_bytes"] == jm["msg_bytes"]
        assert m["packaged_bytes"] == jm["packaged_bytes"]
        assert set(jm) <= set(m) | {"nonfinite_skip"}


def _resnet_world2(mesh2, tmp_path, jcode, tcode):
    """The ResNet((1, 1)) trajectory in both packages with the given
    codecs; returns the port's ranks and the JAX run."""
    jmodel = jmodels.ResNet((1, 1), num_classes=10, dtype=jnp.float32)
    named, aux = jmodels.build_model(jmodel, (1, 8, 8, 3), seed=1)
    named = {n: np.asarray(p) for n, p in named.items()}
    aux = jax.tree.map(np.asarray, aux)
    batches = _batches(np.random.RandomState(0), (8, 8, 3))
    loss_fn, _ = jmodels.make_classifier_loss(jmodel, has_aux=True)
    jrun = _jax_trajectory(mesh2, named, aux, loss_fn, True, batches, jcode)
    tparams, taux = params_from_jax(named, aux)
    ranks = run_world("ps_trajectory", WORLD, tmp_path, "resnet11",
                      {n: t.numpy() for n, t in tparams.items()},
                      {n: t.numpy() for n, t in taux.items()}, batches,
                      tcode, 0.1, 0.9)
    return ranks, jrun


def test_world2_resnet_identity_trajectory_matches_jax(mesh2, tmp_path):
    ranks, (jl, jm, jp, jaux) = _resnet_world2(mesh2, tmp_path, None, None)
    _check_resnet(ranks, jl, jm, jp, jaux)


def test_world2_resnet_blockq_in_jax_order_matches_jax(mesh2, tmp_path):
    """Blockq at 1,024-element tiles: every conv kernel of the narrow
    ResNet spans several tiles (36 for a 3x3x64x64 kernel), so which
    elements share a scale depends on the element order.  The port must
    quantize each gradient in flax's order to match."""
    ranks, (jl, jm, jp, jaux) = _resnet_world2(
        mesh2, tmp_path, jcodecs.BlockQuantizeCodec(block_rows=8),
        tcodecs.BlockQuantizeCodec(block_rows=8))
    _check_resnet(ranks, jl, jm, jp, jaux, flips=1e-4)


def _check_resnet(ranks, jl, jm, jp, jaux, flips=0.0):
    """Port ranks against the JAX run; ``flips``: the share of parameter
    elements allowed outside the tolerance (codes one quantum apart)."""
    for r in ranks[1:]:  # replicated state: every rank holds the same
        for n in r["params"]:
            np.testing.assert_array_equal(r["params"][n],
                                          ranks[0]["params"][n])
    out = ranks[0]
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out["losses"], jl, **tol)
    _check_metrics(out["metrics"], jm)
    jp_t, jaux_t = params_from_jax(jp, jaux)
    assert set(out["params"]) == set(jp_t)
    if flips:
        outside = sum(int((~np.isclose(out["params"][n], p.numpy(),
                                       **tol)).sum())
                      for n, p in jp_t.items())
        total = sum(p.numel() for p in jp_t.values())
        assert outside <= flips * total, (outside, total)
    else:
        for n, p in jp_t.items():
            np.testing.assert_allclose(out["params"][n], p.numpy(),
                                       err_msg=n, **tol)
    for n, a in jaux_t.items():
        np.testing.assert_allclose(out["aux"][n], a.numpy(), err_msg=n,
                                   **tol)


def test_world2_mlp_blockq_trajectory_matches_jax(mesh2, tmp_path):
    named = jmodels.init_mlp(np.random.RandomState(2), (48, 32, 10))
    batches = _batches(np.random.RandomState(3), (4, 4, 3))
    jl, jm, jp, _ = _jax_trajectory(mesh2, named, None,
                                    jmodels.mlp_loss_fn, False, batches,
                                    "blockq")
    ranks = run_world("ps_trajectory", WORLD, tmp_path, "mlp", dict(named),
                      None, batches, "blockq", 0.1, 0.9)
    out = ranks[0]
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out["losses"], jl, **tol)
    _check_metrics(out["metrics"], jm)
    for n, p in jp.items():
        np.testing.assert_allclose(out["params"][n], p, err_msg=n, **tol)
        np.testing.assert_array_equal(ranks[1]["params"][n],
                                      out["params"][n])


def test_world2_mlp_bf16_trajectory_matches_jax(mesh2, tmp_path):
    """The bf16 codec at world 2 with the default buckets: the MLP's four
    leaves (1,584, 33, 330 and 10 elements) share one gathered bucket, so
    the grouped cast_sum reads leaves at odd element offsets of rows an odd
    number of elements apart.  Tolerance as for the blockq MLP."""
    named = jmodels.init_mlp(np.random.RandomState(4), (48, 33, 10))
    batches = _batches(np.random.RandomState(5), (4, 4, 3))
    jl, jm, jp, _ = _jax_trajectory(mesh2, named, None,
                                    jmodels.mlp_loss_fn, False, batches,
                                    "bf16")
    ranks = run_world("ps_trajectory", WORLD, tmp_path, "mlp", dict(named),
                      None, batches, "bf16", 0.1, 0.9)
    out = ranks[0]
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out["losses"], jl, **tol)
    _check_metrics(out["metrics"], jm)
    for n, p in jp.items():
        np.testing.assert_allclose(out["params"][n], p, err_msg=n, **tol)
        np.testing.assert_array_equal(ranks[1]["params"][n],
                                      out["params"][n])


# ---------------------------------------------------------------------------
# Construction and step contract, in one process (a world of one)
# ---------------------------------------------------------------------------


def _named():
    rng = np.random.RandomState(0)
    return [("w", rng.randn(6, 3).astype(np.float32)),
            ("b", np.zeros(3, np.float32))]


def _loss(p, batch):
    return ((batch["x"] @ p["w"] + p["b"] - batch["y"]) ** 2).mean()


def _batch():
    rng = np.random.RandomState(1)
    return {"x": rng.randn(8, 6).astype(np.float32),
            "y": rng.randn(8, 3).astype(np.float32)}


def test_constructor_validates_like_jax():
    with pytest.raises(ValueError, match="not supported"):
        MPI_PS(_named(), optim="rmsprop", device="cpu")
    with pytest.raises(TypeError, match="unexpected sgd hyperparameters"):
        SGD(_named(), lr=0.1, betas=(0.9, 0.99), device="cpu")
    with pytest.raises(ValueError, match="unique"):
        SGD(_named() + _named(), device="cpu")
    with pytest.raises(ValueError, match="sync_mode"):
        SGD(_named(), sync_mode="eager", device="cpu")
    with pytest.raises(ValueError, match="bucket_mb"):
        SGD(_named(), bucket_mb=-1, device="cpu")


@pytest.mark.parametrize("kwargs", [dict(cuda=True)])
def test_unported_options_raise(kwargs):
    """``cuda=`` is the reference's constructor argument, accepted for API
    parity as the JAX package accepts it: the device stays ``device``'s,
    and the steps are those of ``cuda=False``, bitwise.  (Only the mesh
    options are refused: `tests/test_torch_isolation.py`.)"""
    runs = []
    for extra in (kwargs, dict(cuda=False)):
        opt = SGD(_named(), lr=0.05, momentum=0.9, device="cpu",
                  code="blockq", **extra)
        assert opt.device == torch.device("cpu")
        opt.compile_step(_loss)
        losses = [opt.step(_batch())[0] for _ in range(2)]
        runs.append((losses, {n: p.clone() for n, p in opt.params.items()}))
    assert runs[0][0] == runs[1][0]
    for n, p in runs[1][1].items():
        assert torch.equal(runs[0][1][n], p), n
    # An axis missing from the mesh is refused in the JAX package's words.
    from pytorch_ps_mpi_tpu import SGD as JSGD
    from pytorch_ps_mpi_tpu.parallel.mesh import make_ps_mesh as jmesh

    from pytorch_ps_mpi_tpu_torch import make_ps_mesh

    with pytest.raises(ValueError) as e:
        SGD(_named(), device="cpu", mesh=make_ps_mesh(1, device="cpu"),
            axis=("ps", "tp"))
    with pytest.raises(ValueError) as j:
        JSGD(_named(), mesh=jmesh(1), axis=("ps", "tp"))
    assert str(e.value) == str(j.value) == (
        "axis 'tp' not in mesh axes ('ps',)")


def test_exports_cover_the_jax_package():
    """Each name of the JAX package's ``__all__`` is exported by the port,
    or waits for the slice named here."""
    import pytorch_ps_mpi_tpu as jpkg

    import pytorch_ps_mpi_tpu_torch as port

    waiting = {
        "TorchUnavailableError": "none: the port is the torch package",
    }
    for name in jpkg.__all__:
        if name in waiting:
            assert name not in port.__all__, name
            continue
        assert name in port.__all__, name
        assert hasattr(port, name), name
    # The hierarchy's names, which the JAX package exports from ``shard``
    # (its top level carries the error only).
    import pytorch_ps_mpi_tpu.shard as jshard

    for name in ("LocalAggregator", "GroupWorker", "Hierarchy"):
        assert name in jshard.__all__ and name in port.shard.__all__
        assert name in port.__all__
    assert "AggregatorDeadError" in port.__all__
    assert port.ReducerCodecError.__name__ == "ReducerCodecError"
    assert port.PS.__mro__[1] is port.MPI_PS
    assert port.checkpoint.save_optimizer is not None


@pytest.mark.parametrize("kwargs", [
    dict(clip_norm=1.0), dict(skip_nonfinite=True), dict(profile=True),
    dict(sync_mode="overlap"), dict(fused_encode=True),
    dict(decompose_allreduce=True), dict(zero=True),
    dict(error_feedback=True), dict(ema_decay=0.99),
    dict(consensus_every=1),
])
def test_ported_options_take_a_step(kwargs):
    """The ported options construct and run a CPU step (``fused_encode``
    needs the overlap mode, as in the JAX package)."""
    if kwargs.get("fused_encode"):
        with pytest.raises(ValueError, match="fused_encode requires"):
            SGD(_named(), device="cpu", code="blockq", **kwargs)
        kwargs = dict(kwargs, sync_mode="overlap")
    code = "identity" if kwargs.get("decompose_allreduce") else "blockq"
    opt = SGD(_named(), lr=0.05, momentum=0.9, device="cpu", code=code,
              **kwargs)
    opt.compile_step(_loss)
    before = {n: p.clone() for n, p in opt.params.items()}
    loss, m = opt.step(_batch())
    assert np.isfinite(loss) and m["nonfinite_skip"] == 0.0
    for n, p in opt.params.items():
        assert bool(torch.isfinite(p).all())
        assert not torch.equal(p, before[n]), n


def test_unported_compile_options_raise():
    """``compile_step`` validates as the JAX package does: accum_steps
    below 1 and a per-rank batch that does not split into the microbatches
    are refused; accum_steps and remat are accepted and take a step."""
    opt = SGD(_named(), device="cpu")
    with pytest.raises(ValueError, match="accum_steps"):
        opt.compile_step(_loss, accum_steps=0)
    opt.compile_step(_loss, accum_steps=3, remat=True)
    with pytest.raises(ValueError, match="does not split"):
        opt.step(_batch())
    opt.compile_step(_loss, accum_steps=2, remat=True)
    loss, _ = opt.step(_batch())
    assert np.isfinite(loss)


def test_step_contract():
    opt = SGD(_named(), lr=0.05, momentum=0.9, device="cpu", code="bf16")
    with pytest.raises(NotCompiledError):
        opt.step(_batch())
    opt.compile_step(_loss)
    with pytest.raises(ValueError, match="needs a batch"):
        opt.step()
    calls = []
    loss0, m = opt.step(_batch(), closure=lambda: calls.append(1) or 123.0)
    assert calls == [1] and isinstance(loss0, float) and loss0 != 123.0
    assert m["packaged_bytes"] == (18 + 3) * 2
    assert m["msg_bytes"] == (18 + 3) * 4
    assert m["iallgather_prepare_time"] > 0 and m["isend_time"] == 0.0
    losses = [opt.step(_batch())[0] for _ in range(5)]
    assert losses[-1] < loss0
    loss, m = opt.step(_batch(), block=False)
    assert isinstance(loss, torch.Tensor) and m["comm_wait"] == 0.0
    assert m["isend_time"] > 0
    assert opt.steps_completed == 7 and len(opt.timings) == 7


@pytest.mark.parametrize("cls,hyper", [(SGD, dict(lr=0.1, momentum=0.9)),
                                       (Adam, dict(lr=1e-2)),
                                       (AdamW, dict(lr=1e-2))])
@pytest.mark.parametrize("code", ["identity", "bf16", "blockq"])
def test_world1_step_matches_jax(cls, hyper, code):
    """World 1 on both sides (a one-device mesh), every optimizer and codec:
    the same update to float32 rounding (one matmul per step: ``rtol=1e-5,
    atol=1e-6``)."""
    from pytorch_ps_mpi_tpu import Adam as JAdam, AdamW as JAdamW
    from pytorch_ps_mpi_tpu.parallel.mesh import make_ps_mesh

    jcls = {SGD: JSGD, Adam: JAdam, AdamW: JAdamW}[cls]
    mesh1 = make_ps_mesh(1)
    jopt = jcls(_named(), mesh=mesh1, code=code, **hyper)
    jopt.compile_step(lambda p, b: jnp.mean(
        (b["x"] @ p["w"] + p["b"] - b["y"]) ** 2))
    opt = cls(_named(), device="cpu", code=code, **hyper)
    opt.compile_step(_loss)
    for _ in range(3):
        jl, _ = jopt.step(_batch())
        tl, _ = opt.step(_batch())
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for n, p in opt.params.items():
        np.testing.assert_allclose(p.numpy(), np.asarray(jopt.params[n]),
                                   rtol=1e-5, atol=1e-6)
