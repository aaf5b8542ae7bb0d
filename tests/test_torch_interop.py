"""`utils.interop` of the port: the element order the codecs see, and
optimizer state carried across from and back to the JAX package.

* `jax_order` inverts `params_from_jax` for every leaf of ResNet-18 and
  of the transformer LM (names and layouts of the flax trees): permuting
  the port's leaf gives flax's array back, exactly; the MLP's plain dict
  and leaves whose layouts agree get no permutation.
* `state_from_jax` and `state_to_jax` are inverses on a JAX state dict
  (params, optimizer state, BatchNorm statistics, EF residual, EMA) and
  on the LM's names, and refuse a raw ZeRO shard.  Exact: they only
  rename and transpose.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu import SGD as JSGD
from pytorch_ps_mpi_tpu import models as jmodels
from pytorch_ps_mpi_tpu.models import transformer as jt
from pytorch_ps_mpi_tpu.parallel.mesh import make_ps_mesh
from pytorch_ps_mpi_tpu_torch.utils import interop

LM = dict(vocab_size=61, d_model=32, n_heads=4, n_layers=2, d_ff=64,
          max_len=16)


def _flax_params(model):
    if model == "resnet18":
        named, aux = jmodels.build_model(jmodels.resnet18(), (1, 32, 32, 3))
    else:
        named = jt.build_lm(jt.TransformerLM(**LM), seq_len=8)
        aux = {}
    return {n: np.asarray(p) for n, p in named.items()}, aux


@pytest.mark.parametrize("model", ["resnet18", "lm"])
def test_jax_order_inverts_params_from_jax(model):
    named, _ = _flax_params(model)
    tparams, _ = interop.params_from_jax(named)
    permuted = 0
    for (fname, a), (tname, t) in zip(named.items(), tparams.items()):
        order = interop.jax_order(tname, t.shape)
        back = interop.to_jax_order(t, order)
        assert tuple(back.shape) == a.shape, tname
        np.testing.assert_array_equal(back.numpy(), a, err_msg=tname)
        assert interop.from_jax_order(back, order).data_ptr() == t.data_ptr()
        np.testing.assert_array_equal(
            interop.from_jax_order(back, order).numpy(), t.numpy())
        assert (order is None) == (not fname.endswith("/kernel")), fname
        permuted += order is not None
    # ResNet-18: 20 convs and the Dense head; the LM: 4 PDense kernels a
    # block and lm_head.
    assert permuted == {"resnet18": 21, "lm": 4 * LM["n_layers"] + 1}[model]


def test_jax_order_leaves_other_names_alone():
    for name, shape in (("dense0/kernel", (4, 3)), ("fc.weight", (4, 3)),
                        ("conv1.weight", (8, 3, 3, 3)),
                        ("tok_embed.weight", (61, 32)),
                        ("Conv_0.weight", (8,)), ("Dense_0.bias", (10,))):
        assert interop.jax_order(name, shape) is None, name
    assert interop.invert((2, 3, 1, 0)) == (3, 2, 0, 1)


def _jax_state(zero=False, raw=False):
    """A JAX state dict of the narrow ResNet after two steps: SGD
    momentum, EMA, EF (blockq) at world 2."""
    jmodel = jmodels.ResNet((1, 1), num_classes=10, dtype=jnp.float32)
    named, aux = jmodels.build_model(jmodel, (1, 8, 8, 3), seed=1)
    loss_fn, _ = jmodels.make_classifier_loss(jmodel, has_aux=True)
    opt = JSGD(list(named.items()), lr=0.1, momentum=0.9,
               mesh=make_ps_mesh(2), code="blockq", error_feedback=True,
               ema_decay=0.9, zero=zero)
    opt.compile_step(loss_fn, has_aux=True, aux=aux)
    rng = np.random.RandomState(0)
    for _ in range(2):
        opt.step({"x": rng.randn(4, 8, 8, 3).astype(np.float32),
                  "y": rng.randint(0, 10, 4).astype(np.int32)})
    return opt.state_dict(raw_shards=raw), list(named)


def test_state_from_and_to_jax_are_inverses():
    sd, flax_names = _jax_state()
    port = interop.state_from_jax(sd)
    tparams, taux = interop.params_from_jax(sd["params"], sd["aux"])
    for n, t in tparams.items():
        np.testing.assert_array_equal(port["params"][n], t.numpy())
        assert port["state"][n]["momentum_buffer"].shape == tuple(t.shape)
        assert port["ef"][n].shape == (2, *t.shape)
        np.testing.assert_array_equal(port["ema"][n].shape, t.shape)
    for n, a in taux.items():
        np.testing.assert_array_equal(port["aux"][n], a.numpy())
    assert port["topology"] == sd["topology"]
    assert port["hyper"] == sd["hyper"] and port["optim"] == "sgd"
    back = interop.state_to_jax(port)
    assert list(back["params"]) == flax_names
    jax.tree.map(np.testing.assert_array_equal,
                 {k: back[k] for k in ("params", "state", "ef", "ema",
                                       "aux")},
                 {k: jax.tree.map(np.asarray, sd[k])
                  for k in ("params", "state", "ef", "ema", "aux")})


def test_lm_names_cross_back():
    """The LM's names come back from the port's: embeddings, LayerNorm
    scales, PDense kernels and biases."""
    named, _ = _flax_params("lm")
    tparams, _ = interop.params_from_jax(named)
    sd = {"params": {n: t.numpy() for n, t in tparams.items()},
          "state": {n: {} for n in tparams}, "aux": {}}
    back = interop.state_to_jax(sd)
    assert list(back["params"]) == list(named)
    for n, a in named.items():
        np.testing.assert_array_equal(back["params"][n], a)


def test_raw_zero_shards_do_not_cross():
    sd, _ = _jax_state(zero=True, raw=True)
    with pytest.raises(ValueError, match="raw ZeRO shard"):
        interop.state_from_jax(sd)
    torch_sd = interop.state_from_jax(_jax_state(zero=True)[0])
    assert torch_sd["state"]["Conv_0.weight"]["momentum_buffer"].shape == (
        64, 3, 3, 3)
