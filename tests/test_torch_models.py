"""Models of the port against the flax models of the JAX package.

`ResNet((1, 1))` — the stem, an identity block and a downsampling block
with its 1x1 shortcut — in float32 at an 8x8 input, with the flax weights
and statistics carried across by `params_from_jax`.  The 8x8 input is what
catches flax's asymmetric SAME padding at stride 2 (a symmetric pad shifts
every output pixel by one, an error of order one).  Logits, the loss, its
gradients and the updated BatchNorm statistics must match.

Tolerance: ``rtol=2e-4, atol=2e-5``.  Both run in float32 on the CPU, but
XLA and PyTorch accumulate convolutions and the BatchNorm reductions in
other orders (and flax takes the variance as ``E[x^2]-E[x]^2``), which
moves results by a few float32 ulps per op and up to ~1e-5 relative
after the backward pass through five convolutions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu import models as jmodels
from pytorch_ps_mpi_tpu.models import resnet as jresnet
from pytorch_ps_mpi_tpu.utils.flatten import unflatten_params
from pytorch_ps_mpi_tpu_torch import models as tmodels
from pytorch_ps_mpi_tpu_torch.utils.interop import params_from_jax

TOL = dict(rtol=2e-4, atol=2e-5)


def _flax_to_torch_name(n):
    n = n.replace("/", ".")
    for leaf in ("kernel", "scale"):
        n = n.replace(leaf, "weight")
    return n


def _to_torch_layout(a):
    a = np.asarray(a)
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    return a.T if a.ndim == 2 else a


@pytest.mark.parametrize("small_inputs", [True, False])
def test_resnet_matches_flax(small_inputs):
    size = 8 if small_inputs else 16
    _against_flax(
        jmodels.ResNet((1, 1), num_classes=10, small_inputs=small_inputs,
                       dtype=jnp.float32),
        tmodels.ResNet((1, 1), num_classes=10, small_inputs=small_inputs),
        (size, size, 3))


def test_bottleneck_resnet_matches_flax():
    """Four Bottleneck blocks behind ResNet-50's ImageNet stem, at 16x16:
    the 1x1 -> 3x3 -> 1x1 order, the 4x-wide projections (the first
    block's at stride 1, the others strided) and the zero-scale last
    BatchNorm."""
    _against_flax(
        jmodels.ResNet((1, 1, 1, 1), jresnet.BottleneckBlock, num_classes=10,
                       small_inputs=False, dtype=jnp.float32),
        tmodels.ResNet((1, 1, 1, 1), tmodels.BottleneckBlock, num_classes=10,
                       small_inputs=False),
        (16, 16, 3))


def test_lenet_matches_flax():
    """LeNet-5 at 28x28x1: SAME then VALID convolutions with biases,
    average pools, and ``Dense_0``'s inputs in flax's H, W, C order (a
    C, H, W flatten would permute its 400 inputs)."""
    _against_flax(jmodels.LeNet5(dtype=jnp.float32), tmodels.LeNet5(),
                  (28, 28, 1))


def _against_flax(jmodel, tmodel, shape):
    """Logits (evaluation mode), the loss, its gradients and the updated
    BatchNorm statistics of ``tmodel`` against the flax ``jmodel`` from
    the same weights (carried by `params_from_jax`), at inputs of
    ``shape``."""
    jparams, jaux = jmodels.build_model(jmodel, (1, *shape), seed=3)
    jparams = {n: np.asarray(p) for n, p in jparams.items()}
    jaux = jax.tree.map(np.asarray, jaux)
    # Non-trivial statistics, a non-zero last-BN scale and non-zero
    # conv/Dense biases, so that every path (eval mode, the residual
    # branch, the bias adds) is exercised.  BatchNorm biases stay zero:
    # with non-zero ones, flax's float32 variance (E[x^2] - E[x]^2) puts
    # the Bottleneck net's gradients up to 4e-5 off the same function in
    # float64, past this tolerance (the port's stay within 3e-8 of it).
    rng = np.random.RandomState(0)
    jparams = {n: (p + 0.1 * rng.randn(*p.shape)).astype(np.float32)
               if n.endswith("scale") or (n.endswith("bias")
                                          and "BatchNorm" not in n) else p
               for n, p in jparams.items()}
    jaux = jax.tree.map(lambda a: (np.abs(a + 0.3 * rng.randn(*a.shape)) +
                                   0.1).astype(np.float32), jaux)
    x = rng.randn(4, *shape).astype(np.float32)
    y = rng.randint(0, 10, size=4).astype(np.int32)
    batch = {"x": x, "y": y}
    has_aux = bool(jaux)

    jloss_fn, _ = jmodels.make_classifier_loss(jmodel, has_aux=has_aux)
    if has_aux:
        (jloss, jnew_aux), jgrads = jax.value_and_grad(
            jloss_fn, has_aux=True)(jparams, jaux, batch)
        jlogits = jmodel.apply({"params": unflatten_params(jparams),
                                "batch_stats": jaux}, x, train=False)
    else:
        jloss, jgrads = jax.value_and_grad(jloss_fn)(jparams, batch)
        jlogits = jmodel.apply({"params": unflatten_params(jparams)}, x)

    tparams, taux = params_from_jax(jparams, jaux)
    assert set(tparams) == {n for n, _ in tmodel.named_parameters()}
    assert set(taux) == {n for n, _ in tmodel.named_buffers()}
    loss_fn, t_has_aux = tmodels.make_classifier_loss(tmodel)
    assert t_has_aux == has_aux
    leaves = {n: p.clone().requires_grad_() for n, p in tparams.items()}
    tbatch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    if has_aux:
        loss, new_aux = loss_fn(leaves, taux, tbatch)
    else:
        loss = loss_fn(leaves, tbatch)
    grads = torch.autograd.grad(loss, list(leaves.values()))

    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    for (n, g) in zip(leaves, grads):
        flax_name = [k for k in jgrads if _flax_to_torch_name(k) == n]
        assert len(flax_name) == 1, n
        np.testing.assert_allclose(
            g.numpy(), _to_torch_layout(jgrads[flax_name[0]]),
            err_msg=n, **TOL)
    if has_aux:
        _, jnew = params_from_jax({}, jax.tree.map(np.asarray, jnew_aux))
        assert set(new_aux) == set(jnew)
        for n in jnew:
            np.testing.assert_allclose(new_aux[n].numpy(), jnew[n].numpy(),
                                       err_msg=n, **TOL)
        # The statistics passed in are left as they were.
        for n, t in taux.items():
            np.testing.assert_array_equal(t.numpy(), params_from_jax(
                {}, jaux)[1][n].numpy())

    tmodel.eval()
    logits = torch.func.functional_call(
        tmodel, {**tparams, **taux}, (torch.from_numpy(x),))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **TOL)


def test_build_model_initialises_like_flax():
    """Same shapes, zero-scale last BN per block, unit running variance,
    and weights drawn from a truncated lecun normal (the draws themselves
    differ between the packages)."""
    model = tmodels.ResNet((1, 1))
    params, aux = tmodels.build_model(model, seed=0)
    again, _ = tmodels.build_model(tmodels.ResNet((1, 1)), seed=0)
    for n in params:
        np.testing.assert_array_equal(params[n].numpy(), again[n].numpy())
    assert not params["BasicBlock_0.BatchNorm_1.weight"].any()
    assert (params["BasicBlock_0.BatchNorm_0.weight"] == 1).all()
    assert (aux["BatchNorm_0.running_var"] == 1).all()
    w = params["BasicBlock_1.Conv_0.weight"]
    std = np.sqrt(1.0 / (64 * 9)) / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std
    assert abs(float(w.std()) - np.sqrt(1.0 / (64 * 9))) < 0.1 * std


@pytest.mark.parametrize("depth", [18, 34])
def test_resnet_names_and_shapes_match_flax(depth):
    """Every parameter and statistic of the full-width ResNet-18/34 under
    flax's name, in torch's layout (shapes only: `jax.eval_shape`)."""
    jmodel = getattr(jmodels, f"resnet{depth}")(num_classes=10)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)), train=False))
    jnamed = {n: np.zeros(s.shape, np.float32) for n, s in
              jmodels.named_params(shapes["params"]).items()}
    jaux = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                        shapes["batch_stats"])
    want_params, want_aux = params_from_jax(jnamed, jaux)
    params, aux = tmodels.build_model(
        getattr(tmodels, f"resnet{depth}")(num_classes=10))
    assert {n: tuple(p.shape) for n, p in params.items()} == {
        n: tuple(p.shape) for n, p in want_params.items()}
    assert {n: tuple(b.shape) for n, b in aux.items()} == {
        n: tuple(b.shape) for n, b in want_aux.items()}


def test_resnet50_names_and_shapes_match_flax():
    """Every parameter and statistic of the full-width ResNet-50 (ImageNet
    stem, 1000 classes: 161 tensors, 25,557,032 parameters) under flax's
    name, in torch's layout (shapes only: `jax.eval_shape`)."""
    jmodel = jmodels.resnet50()
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3)), train=False))
    jnamed = {n: np.zeros(s.shape, np.float32) for n, s in
              jmodels.named_params(shapes["params"]).items()}
    jaux = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                        shapes["batch_stats"])
    want_params, want_aux = params_from_jax(jnamed, jaux)
    params, aux = tmodels.build_model(tmodels.resnet50())
    assert {n: tuple(p.shape) for n, p in params.items()} == {
        n: tuple(p.shape) for n, p in want_params.items()}
    assert {n: tuple(b.shape) for n, b in aux.items()} == {
        n: tuple(b.shape) for n, b in want_aux.items()}
    assert len(params) == 161
    assert sum(p.numel() for p in params.values()) == 25_557_032
    # The zero-scale last BatchNorm of every block.
    for k in range(16):
        assert not params[f"BottleneckBlock_{k}.BatchNorm_2.weight"].any()
        assert (params[f"BottleneckBlock_{k}.BatchNorm_1.weight"] == 1).all()


@pytest.mark.parametrize("model", ["bottleneck", "lenet"])
def test_jax_order_covers_the_new_models(model):
    """`utils.interop.jax_order`'s name patterns cover the Bottleneck
    blocks' convolutions and LeNet's convolutions and Dense layers: for
    every leaf, permuting the port's array gives flax's back exactly, and
    exactly the flax kernels are permuted."""
    from pytorch_ps_mpi_tpu_torch.utils import interop

    if model == "bottleneck":
        jmodel = jmodels.ResNet((1, 1, 1, 1), jresnet.BottleneckBlock)
        shape = (1, 16, 16, 3)
    else:
        jmodel = jmodels.LeNet5()
        shape = (1, 28, 28, 1)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros(shape)))
    rng = np.random.RandomState(1)
    named = {n: rng.randn(*s.shape).astype(np.float32) for n, s in
             jmodels.named_params(shapes["params"]).items()}
    tparams, _ = params_from_jax(named)
    permuted = 0
    for (fname, a), (tname, t) in zip(named.items(), tparams.items()):
        order = interop.jax_order(tname, t.shape)
        assert (order is None) == (not fname.endswith("/kernel")), fname
        np.testing.assert_array_equal(
            interop.to_jax_order(t, order).numpy(), a, err_msg=tname)
        permuted += order is not None
    # 4 convs a block (with its projection), the stem and the head; or
    # LeNet's 2 convs and 3 Dense layers.
    assert permuted == {"bottleneck": 4 * 4 + 2, "lenet": 5}[model]


@pytest.mark.parametrize("model", ["bottleneck", "lenet", "mlp"])
def test_eval_accuracy_matches_jax(model):
    """`eval_accuracy` in evaluation mode (BatchNorm on its running
    statistics) scores like the JAX package's on the same weights."""
    rng = np.random.RandomState(2)
    if model == "mlp":
        jparams = jmodels.init_mlp(np.random.RandomState(0), (48, 16, 10))
        x = rng.randn(40, 4, 4, 3).astype(np.float32)
        y = rng.randint(0, 10, 40).astype(np.int32)
        want = float((np.argmax(np.asarray(jmodels.mlp_apply(
            {n: jnp.asarray(p) for n, p in jparams.items()},
            jnp.asarray(x.reshape(40, -1)))), -1) == y).mean())
        got = tmodels.mlp_apply({n: torch.from_numpy(p)
                                 for n, p in jparams.items()},
                                torch.from_numpy(x.reshape(40, -1)))
        assert float((got.argmax(-1).numpy() == y).mean()) == want
        return
    if model == "bottleneck":
        jmodel = jmodels.ResNet((1, 1, 1, 1), jresnet.BottleneckBlock,
                                small_inputs=False)
        tmodel = tmodels.ResNet((1, 1, 1, 1), tmodels.BottleneckBlock,
                                small_inputs=False)
        shape = (16, 16, 3)
    else:
        jmodel, tmodel, shape = jmodels.LeNet5(), tmodels.LeNet5(), \
            (28, 28, 1)
    jparams, jaux = jmodels.build_model(jmodel, (1, *shape), seed=4)
    jparams = {n: np.asarray(p) for n, p in jparams.items()}
    jaux = jax.tree.map(lambda a: (np.abs(np.asarray(a) + 0.3 * rng.randn(
        *a.shape)) + 0.1).astype(np.float32), jaux)
    x = rng.randn(40, *shape).astype(np.float32)
    y = rng.randint(0, 10, 40).astype(np.int32)
    batches = [{"x": x[i:i + 16], "y": y[i:i + 16]} for i in (0, 16, 32)]
    want = jmodels.eval_accuracy(jmodel, jparams, jaux, batches)
    tparams, taux = params_from_jax(jparams, jaux)
    tmodel.train()
    assert tmodels.eval_accuracy(tmodel, tparams, taux, batches) == want
    assert tmodel.training  # the mode it was in comes back


def test_datasets_match_jax():
    """The numpy datasets are copies: the same seed gives the same arrays
    and the same batches, bitwise."""
    from pytorch_ps_mpi_tpu.data import datasets as jdata
    from pytorch_ps_mpi_tpu_torch.data import datasets as tdata

    for name in ("synthetic_cifar10", "synthetic_mnist"):
        for a, b in zip(getattr(jdata, name)(64, seed=5),
                        getattr(tdata, name)(64, seed=5)):
            np.testing.assert_array_equal(a, b)
    x, y = tdata.synthetic_cifar10(50, seed=1)
    for drop in (True, False):
        want = list(jdata.batches(x, y, 16, world_size=2, seed=2,
                                  drop_remainder=drop))
        got = list(tdata.batches(x, y, 16, world_size=2, seed=2,
                                 drop_remainder=drop))
        assert len(got) == len(want) == (3 if drop else 4)
        for g, w in zip(got, want):
            for k in ("x", "y"):
                np.testing.assert_array_equal(g[k], w[k])
    with pytest.raises(ValueError, match="divisible"):
        next(tdata.batches(x, y, 15, world_size=2))


def test_mlp_matches_jax():
    """The MLP shares its numpy parameters across packages.  Tolerance
    ``rtol=1e-5, atol=1e-6``: one matmul per layer, summed in other orders
    by XLA and PyTorch."""
    rng = np.random.RandomState(0)
    params = jmodels.init_mlp(np.random.RandomState(1), (12, 16, 5))
    tparams = tmodels.init_mlp(np.random.RandomState(1), (12, 16, 5))
    for n in params:
        np.testing.assert_array_equal(params[n], tparams[n])
    batch = {"x": rng.randn(6, 3, 4).astype(np.float32),
             "y": rng.randint(0, 5, 6).astype(np.int32)}
    jloss, jgrads = jax.value_and_grad(jmodels.mlp_loss_fn)(
        {n: jnp.asarray(p) for n, p in params.items()}, batch)
    leaves = {n: torch.from_numpy(p).requires_grad_()
              for n, p in tparams.items()}
    loss = tmodels.mlp_loss_fn(leaves, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for n, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[n]),
                                   rtol=1e-5, atol=1e-6)
