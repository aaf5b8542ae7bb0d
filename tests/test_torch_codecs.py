"""Gradient codecs of the port against the JAX package's.

* ``wire_bytes`` — exact, for every ResNet-18 parameter shape: it is the
  ``packaged_bytes`` metric and the blockq wire format.
* encode, decode and decode_sum — the same numpy gradients through both
  packages.  Tolerance: none for blockq codes, scales and sums, and for
  the bf16 cast and its f32 sum (the same float32 operations in the same
  order, see ``tests/test_torch_codec_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu.models import build_model as jbuild_model
from pytorch_ps_mpi_tpu.models import resnet18 as jresnet18
from pytorch_ps_mpi_tpu.ops import codecs as jcodecs
from pytorch_ps_mpi_tpu_torch.models import build_model, resnet18
from pytorch_ps_mpi_tpu_torch.ops import codecs as tcodecs

_TORCH_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _resnet18_shapes():
    params, _ = build_model(resnet18())
    return [tuple(p.shape) for p in params.values()]


def test_resnet18_sizes_match_jax():
    """The port's ResNet-18 has the JAX model's 62 tensors and 11,173,962
    elements, in flax's names (layouts transposed)."""
    jparams, jaux = jbuild_model(jresnet18(), (1, 32, 32, 3))
    params, aux = build_model(resnet18())
    assert len(params) == len(jparams) == 62
    assert sum(p.numel() for p in params.values()) == 11_173_962
    assert len(aux) == 2 * 20 == sum(len(v) for v in _leaves(jaux))
    tr = {n.replace(".", "/").replace("weight", "kernel") for n in params}
    fl = {n.replace("scale", "kernel") for n in jparams}
    assert tr == fl


def _leaves(tree):
    if isinstance(tree, dict) and all(not isinstance(v, dict)
                                      for v in tree.values()):
        return [tree]
    return [x for v in tree.values() for x in _leaves(v)]


@pytest.mark.parametrize("name", ["identity", "bf16", "blockq"])
def test_wire_bytes_match_jax_for_every_resnet18_shape(name):
    shapes = _resnet18_shapes()
    ours = tcodecs.get_codec(name)
    ref = jcodecs.get_codec(name)
    for shape in shapes:
        assert ours.wire_bytes(shape, torch.float32) == ref.wire_bytes(
            shape, jnp.float32), shape
    total = sum(ours.wire_bytes(s, torch.float32) for s in shapes)
    expect = {"identity": 44_695_848, "bf16": 22_347_924,
              "blockq": 11_445_104}[name]
    assert total == expect


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("shape", [(3, 3, 64, 64), (1000,), (7, 33), (10,)])
def test_blockq_encode_decode_match_jax(bits, shape):
    rng = np.random.RandomState(bits)
    world = 3
    grads = [(rng.randn(*shape) * 0.1).astype(np.float32)
             for _ in range(world)]
    ours = tcodecs.BlockQuantizeCodec(bits=bits)
    ref = jcodecs.BlockQuantizeCodec(bits=bits)
    codes = [ours.encode(torch.from_numpy(g)) for g in grads]
    jcodes = [ref.encode(jnp.asarray(g)) for g in grads]
    for c, jc in zip(codes, jcodes):
        np.testing.assert_array_equal(c["q"].numpy(), np.asarray(jc["q"]))
        np.testing.assert_array_equal(c["scales"].numpy(),
                                      np.asarray(jc["scales"]))
        np.testing.assert_array_equal(
            ours.decode(c, shape=shape, dtype=torch.float32).numpy(),
            np.asarray(ref.decode(jc, shape=shape, dtype=jnp.float32)))
    stacked = {k: torch.stack([c[k] for c in codes]) for k in codes[0]}
    jstacked = {k: jnp.stack([c[k] for c in jcodes]) for k in jcodes[0]}
    out = ours.decode_sum(stacked, shape=shape, dtype=torch.float32)
    assert tuple(out.shape) == shape
    np.testing.assert_array_equal(
        out.numpy(),
        np.asarray(ref.decode_sum(jstacked, shape=shape, dtype=jnp.float32)))


@pytest.mark.parametrize("shape", [(1000,), (7, 33), (3, 128, 5), ()])
def test_cast_codec_matches_jax(shape):
    rng = np.random.RandomState(1)
    world = 5
    grads = [np.asarray(3 * rng.randn(*shape), np.float32)
             for _ in range(world)]
    ours, ref = tcodecs.CastCodec(), jcodecs.CastCodec()
    assert ours.name == ref.name == "bf16"
    codes = torch.stack([ours.encode(torch.from_numpy(g)) for g in grads])
    jcodes = jnp.stack([ref.encode(jnp.asarray(g)) for g in grads])
    np.testing.assert_array_equal(codes.to(torch.float32).numpy(),
                                  np.asarray(jcodes.astype(jnp.float32)))
    out = ours.decode_sum(codes, shape=shape, dtype=torch.float32)
    assert tuple(out.shape) == shape and out.dtype == torch.float32
    np.testing.assert_array_equal(
        out.numpy(),
        np.asarray(ref.decode_sum(jcodes, shape=shape, dtype=jnp.float32)))
    # The generic decode-then-add path gives the same sum.
    generic = tcodecs.Codec.decode_sum(ours, codes, shape=shape,
                                       dtype=torch.float32)
    np.testing.assert_array_equal(out.numpy(), generic.numpy())


@pytest.mark.parametrize("name", ["identity", "bf16", "blockq"])
def test_decode_sum_leaves_equals_per_leaf_decode_sum(name):
    """The step's one call over all leaves gives, leaf by leaf, the bits
    of `decode_sum`: codes of three ranks gathered leaf by leaf, shapes
    from a scalar and a 1-element leaf to one past a 512-row tile."""
    rng = np.random.RandomState(7)
    world = 3
    shapes = [(), (1,), (7, 33), (10,), (3, 3, 64, 64), (512 * 128 + 5,)]
    codec = tcodecs.get_codec(name)
    gathered, metas = {}, {}
    for i, shape in enumerate(shapes):
        codes = [codec.encode(torch.from_numpy(
            np.asarray(rng.randn(*shape) * 0.1, np.float32)))
            for _ in range(world)]
        key = f"leaf{i}"
        gathered[key] = ({k: torch.stack([c[k] for c in codes])
                          for k in codes[0]} if isinstance(codes[0], dict)
                         else torch.stack(codes))
        metas[key] = (shape, torch.float32)
    out = codec.decode_sum_leaves(gathered, metas)
    assert list(out) == list(metas)
    for key, (shape, dtype) in metas.items():
        want = codec.decode_sum(gathered[key], shape=shape, dtype=dtype)
        assert tuple(out[key].shape) == shape
        assert out[key].dtype == want.dtype == torch.float32
        np.testing.assert_array_equal(out[key].numpy().view(np.uint32),
                                      want.numpy().view(np.uint32))


def test_identity_codec_round_trip():
    codec = tcodecs.get_codec(None)
    assert isinstance(codec, tcodecs.IdentityCodec)
    g = torch.arange(6.0).reshape(2, 3)
    assert codec.decode(codec.encode(g)) is g
    out = codec.decode_sum(torch.stack([g, 2 * g]), shape=(2, 3),
                           dtype=torch.float32)
    np.testing.assert_array_equal(out.numpy(), 3 * g.numpy())


@pytest.mark.parametrize("name", ["topk", "topk_approx", "quantize", "sign"])
def test_unported_codecs_raise(name):
    with pytest.raises(NotImplementedError, match="not ported"):
        tcodecs.get_codec(name)


def test_unknown_codec_and_bad_bits_raise():
    with pytest.raises(ValueError, match="unknown codec"):
        tcodecs.get_codec("nope")
    with pytest.raises(ValueError, match="bits"):
        tcodecs.BlockQuantizeCodec(bits=4)
