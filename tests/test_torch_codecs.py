"""Gradient codecs of the port against the JAX package's.

* ``wire_bytes`` — exact, for every ResNet-18 parameter shape and every
  codec: it is the ``packaged_bytes`` metric and the wire format.
* encode, decode and decode_sum — the same numpy gradients through both
  packages.  Tolerance: none for blockq codes, scales and sums, and for
  the bf16 cast and its f32 sum (the same float32 operations in the same
  order, see ``tests/test_torch_codec_kernels.py``); none for topk's
  values, indices and scatter-add sums, quantize's codes, scale and sums,
  and sign's packed bytes; ``rtol=1e-6`` for sign's mean-|g| scale and
  what it scales (a float32 mean summed in another order than XLA's).
* blockq in the JAX package's element order: for every ResNet-18 and
  transformer-LM parameter shape, the port's gradient permuted by
  `utils.interop.jax_order` quantizes to JAX's codes and scales bitwise.
* ``scale_code`` (the async PS's contribution weights), for every codec:
  bitwise against JAX's, on one code and vmapped over a stack, and the
  weighted decode sums bitwise; linear within the JAX test's tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu.models import build_model as jbuild_model
from pytorch_ps_mpi_tpu.models import resnet18 as jresnet18
from pytorch_ps_mpi_tpu.models import transformer as jt
from pytorch_ps_mpi_tpu.ops import codecs as jcodecs
from pytorch_ps_mpi_tpu.ops import pallas_kernels as jpk
from pytorch_ps_mpi_tpu.utils.flatten import named_params as jnamed_params
from pytorch_ps_mpi_tpu_torch.models import build_model, resnet18
from pytorch_ps_mpi_tpu_torch.ops import codecs as tcodecs
from pytorch_ps_mpi_tpu_torch.utils import interop

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


ALL_CODECS = ["identity", "bf16", "blockq", "topk", "topk_approx",
              "quantize", "sign"]


@pytest.mark.parametrize("name", ALL_CODECS)
def test_wire_bytes_match_jax_for_every_resnet18_shape(name):
    shapes = _resnet18_shapes()
    ours = tcodecs.get_codec(name)
    ref = jcodecs.get_codec(name)
    for shape in shapes:
        assert ours.wire_bytes(shape, torch.float32) == ref.wire_bytes(
            shape, jnp.float32), shape
    total = sum(ours.wire_bytes(s, torch.float32) for s in shapes)
    expect = {"identity": 44_695_848, "bf16": 22_347_924,
              "blockq": 11_445_104}.get(name)
    assert total == (expect if expect is not None else sum(
        ref.wire_bytes(s, jnp.float32) for s in shapes))


@pytest.mark.parametrize("name", ALL_CODECS)
def test_get_codec_resolves_every_jax_name(name):
    """The port's table is the JAX package's: the same class names, codec
    names and settings."""
    ours, ref = tcodecs.get_codec(name), jcodecs.get_codec(name)
    assert type(ours).__name__ == type(ref).__name__
    assert ours.name == ref.name
    for attr in ("fraction", "k", "approx", "recall_target", "bits",
                 "qmax", "block_rows"):
        assert getattr(ours, attr, None) == getattr(ref, attr, None), attr
    assert ours.ordered == (name not in ("identity", "bf16"))


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


@pytest.mark.parametrize("name", ALL_CODECS)
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


def test_unknown_codec_and_bad_bits_raise():
    with pytest.raises(ValueError, match="unknown codec"):
        tcodecs.get_codec("nope")
    with pytest.raises(ValueError, match="bits"):
        tcodecs.BlockQuantizeCodec(bits=4)


# ---------------------------------------------------------------------------
# topk, quantize and sign against the JAX package
# ---------------------------------------------------------------------------

WORLD = 3


def _distinct(rng, shape, scale=1.0):
    """A gradient with no two equal magnitudes (a tie at the k-th
    magnitude would let the two packages pick different indices)."""
    n = int(np.prod(shape))
    mags = (rng.permutation(n) + 1).astype(np.float32) * np.float32(scale / n)
    signs = np.where(rng.rand(n) < 0.5, -1.0, 1.0).astype(np.float32)
    return (mags * signs).reshape(shape)


def _stack(codes, lib):
    return {k: lib.stack([c[k] for c in codes]) for k in codes[0]}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_topk_breaks_ties_as_lax_top_k(approx, k):
    """Ties at the k-th magnitude: ``lax.top_k`` (the JAX codec's exact
    selection) keeps the lower index first (``[1, 2, 2, 2, .5]``, k = 2
    -> ``[1, 2]``), and so must the port, in the same order — its
    approximate variant too, which selects exactly (the JAX package's
    ``approx_max_k`` may take any of the tied indices)."""
    g = np.array([1.0, -2.0, 2.0, 2.0, 0.5], np.float32)
    ours = tcodecs.TopKCodec(k=k, approx=approx).encode(torch.from_numpy(g))
    ref = jcodecs.TopKCodec(k=k).encode(jnp.asarray(g))
    np.testing.assert_array_equal(_np(ours["indices"]), _np(ref["indices"]))
    np.testing.assert_array_equal(_np(ours["values"]), _np(ref["values"]))
    if k == 2:
        np.testing.assert_array_equal(_np(ours["indices"]), [1, 2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", range(6))
def test_topk_matches_jax_on_bf16_precision_ties(dtype, seed):
    """Gradients of bf16 precision (f32 values rounded to bf16, or bf16
    leaves) at n = 2,000 and fraction 0.01 meet ties at the k-th
    magnitude; the selection, its order and the decode-sum are the JAX
    package's, bitwise."""
    g = torch.from_numpy(np.random.RandomState(seed).randn(2000)
                         .astype(np.float32) * np.float32(0.01))
    g = g.to(torch.bfloat16)
    jg = jnp.asarray(g.to(torch.float32).numpy())
    if dtype == "float32":
        g = g.to(torch.float32)
    else:
        jg = jg.astype(jnp.bfloat16)
    ours = tcodecs.TopKCodec(fraction=0.01).encode(g)
    ref = jcodecs.TopKCodec(fraction=0.01).encode(jg)
    np.testing.assert_array_equal(_np(ours["indices"]), _np(ref["indices"]))
    np.testing.assert_array_equal(_np(ours["values"].to(torch.float32)),
                                  np.asarray(ref["values"], np.float32))


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("shape,kw", [((1000,), dict(fraction=0.01)),
                                      ((7, 33), dict(fraction=0.25)),
                                      ((3, 3, 4, 8), dict(k=5)),
                                      ((10,), dict(k=40))])
def test_topk_matches_jax(approx, shape, kw):
    """Values and indices bitwise (exact selection also meets the approx
    codec's recall target, as the JAX package's does on the CPU); decode
    and the scatter-add decode_sum over three ranks, whose indices repeat
    across ranks, bitwise."""
    rng = np.random.RandomState(11)
    grads = [_distinct(rng, shape) for _ in range(WORLD)]
    ours = tcodecs.TopKCodec(approx=approx, **kw)
    ref = jcodecs.TopKCodec(approx=approx, **kw)
    codes = [ours.encode(torch.from_numpy(g)) for g in grads]
    jcodes = [ref.encode(jnp.asarray(g)) for g in grads]
    for c, jc in zip(codes, jcodes):
        assert c["indices"].dtype == torch.int32
        if approx:  # approx_max_k may return its set in another order
            o, jo = np.argsort(_np(c["indices"])), np.argsort(
                _np(jc["indices"]))
        else:
            o = jo = slice(None)
        np.testing.assert_array_equal(_np(c["indices"])[o],
                                      _np(jc["indices"])[jo])
        np.testing.assert_array_equal(_np(c["values"])[o],
                                      _np(jc["values"])[jo])
        np.testing.assert_array_equal(
            _np(ours.decode(c, shape=shape, dtype=torch.float32)),
            _np(ref.decode(jc, shape=shape, dtype=jnp.float32)))
    out = ours.decode_sum(_stack(codes, torch), shape=shape,
                          dtype=torch.float32)
    want = ref.decode_sum(_stack(jcodes, jnp), shape=shape,
                          dtype=jnp.float32)
    assert tuple(out.shape) == shape
    np.testing.assert_array_equal(_np(out), _np(want))


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("shape", [(1000,), (7, 33), (3, 3, 4, 8), ()])
def test_quantize_matches_jax(bits, shape):
    """Codes and scale bitwise (the scale divides by a tensor, rounding
    is half to even), decode and the decode_sum over three ranks bitwise;
    an all-zero gradient gets scale 1.0, a NaN code 0 (XLA's
    conversion)."""
    rng = np.random.RandomState(bits)
    grads = [np.asarray(rng.randn(*shape) * 0.1, np.float32)
             for _ in range(WORLD)]
    grads[1] = np.zeros(shape, np.float32)
    if shape:
        grads[2].reshape(-1)[0] = np.nan
    ours, ref = tcodecs.QuantizeCodec(bits), jcodecs.QuantizeCodec(bits)
    codes = [ours.encode(torch.from_numpy(g)) for g in grads]
    jcodes = [ref.encode(jnp.asarray(g)) for g in grads]
    for c, jc in zip(codes, jcodes):
        assert c["q"].dtype == (torch.int8 if bits == 8 else torch.int16)
        np.testing.assert_array_equal(_np(c["q"]), _np(jc["q"]))
        np.testing.assert_array_equal(_np(c["scale"]), _np(jc["scale"]))
    out = ours.decode_sum(_stack(codes, torch), shape=shape,
                          dtype=torch.float32)
    np.testing.assert_array_equal(_np(out), _np(ref.decode_sum(
        _stack(jcodes, jnp), shape=shape, dtype=jnp.float32)))


@pytest.mark.parametrize("n", [1, 7, 8, 1001])
def test_pack_signs_matches_jax(n):
    """The sign plane bitwise (1 for >= 0, so -0.0 packs as +; a NaN as
    -), and its unpacking."""
    rng = np.random.RandomState(n)
    flat = rng.randn(n + (-n) % 8).astype(np.float32)
    flat[0] = -0.0
    if n > 1:
        flat[1] = np.nan
    packed = tcodecs.pack_signs(torch.from_numpy(flat))
    jpacked = jpk.pack_signs(jnp.asarray(flat))
    assert packed.dtype == torch.uint8
    np.testing.assert_array_equal(_np(packed), _np(jpacked))
    np.testing.assert_array_equal(
        _np(tcodecs.unpack_signs(packed, n)),
        _np(jpk.unpack_signs(jpacked, n)))


@pytest.mark.parametrize("shape", [(1000,), (7, 33), (3, 3, 4, 8), (5,)])
def test_sign_matches_jax(shape):
    """Packed signs bitwise; the mean-|g| scale, the decode and the
    decode_sum over three ranks within ``rtol=1e-6`` (the mean sums in
    another order than XLA's)."""
    rng = np.random.RandomState(3)
    grads = [np.asarray(rng.randn(*shape), np.float32) for _ in range(WORLD)]
    ours, ref = tcodecs.SignCodec(), jcodecs.SignCodec()
    codes = [ours.encode(torch.from_numpy(g)) for g in grads]
    jcodes = [ref.encode(jnp.asarray(g)) for g in grads]
    tol = dict(rtol=1e-6, atol=0)
    for c, jc in zip(codes, jcodes):
        np.testing.assert_array_equal(_np(c["sign"]), _np(jc["sign"]))
        np.testing.assert_allclose(_np(c["scale"]), _np(jc["scale"]), **tol)
        np.testing.assert_allclose(
            _np(ours.decode(c, shape=shape, dtype=torch.float32)),
            _np(ref.decode(jc, shape=shape, dtype=jnp.float32)), **tol)
    out = ours.decode_sum(_stack(codes, torch), shape=shape,
                          dtype=torch.float32)
    np.testing.assert_allclose(_np(out), _np(ref.decode_sum(
        _stack(jcodes, jnp), shape=shape, dtype=jnp.float32)), **tol)


def test_codec_settings_are_validated_like_jax():
    for bad in (dict(k=0), dict(fraction=0.0), dict(fraction=1.5),
                dict(recall_target=0.0)):
        with pytest.raises(ValueError):
            jcodecs.TopKCodec(**bad)
        with pytest.raises(ValueError):
            tcodecs.TopKCodec(**bad)
    with pytest.raises(ValueError, match="bits"):
        tcodecs.QuantizeCodec(bits=4)
    with pytest.raises(ValueError, match="dense shape"):
        tcodecs.TopKCodec().decode({"values": torch.ones(1),
                                    "indices": torch.zeros(1, dtype=torch.int32)})


# ---------------------------------------------------------------------------
# blockq in the JAX package's element order, every ResNet-18 and LM shape
# ---------------------------------------------------------------------------

# The bench LM (`bench.py::worker_lm_throughput`), full width and depth.
BENCH_LM = dict(vocab_size=32768, d_model=1024, n_heads=16, n_layers=12,
                d_ff=4096, max_len=1024)


def _flax_shapes(model):
    """``flax name -> shape`` of a model's parameters (no arrays)."""
    if model == "resnet18":
        jm = jresnet18()
        variables = jax.eval_shape(
            lambda: jm.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3), jnp.float32),
                            train=False))
    else:
        jm = jt.TransformerLM(**BENCH_LM)
        variables = jax.eval_shape(
            lambda: jm.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32)))
    return {n: tuple(a.shape)
            for n, a in jnamed_params(variables["params"]).items()}


def _distinct_layouts(model):
    """One ``(flax name, flax shape)`` per distinct (shape, permutation)."""
    seen, out = set(), []
    for n, shape in _flax_shapes(model).items():
        tname = interop._torch_name(n)
        tshape = interop._to_torch_layout(n, np.empty(shape, np.uint8)).shape
        key = (shape, interop.jax_order(tname, tshape))
        if key not in seen:
            seen.add(key)
            out.append((n, shape))
    return out


@pytest.mark.parametrize("model", ["resnet18", "lm"])
def test_blockq_codes_in_jax_order_match_jax_bitwise(model):
    """The port's gradient (flax's, in the port's layout) handed to the
    codec in `jax_order`'s element order quantizes to JAX's codes and
    scales bitwise at the default tiles, for each distinct parameter shape
    of ResNet-18 (62 leaves) and the bench LM (150 leaves, 219,346,944
    elements); the decode of one rank's code, back in the port's layout
    (`from_jax_order`), is the port-layout view of JAX's decode."""
    rng = np.random.default_rng(5)
    ours, ref = tcodecs.BlockQuantizeCodec(), jcodecs.BlockQuantizeCodec()
    layouts = _distinct_layouts(model)
    assert len(layouts) >= (10 if model == "lm" else 12)
    for name, shape in layouts:
        g = (rng.standard_normal(shape, dtype=np.float32)
             * np.float32(0.01))
        tg = torch.from_numpy(np.ascontiguousarray(
            interop._to_torch_layout(name, g)))
        order = interop.jax_order(interop._torch_name(name), tg.shape)
        code = ours.encode(interop.to_jax_order(tg, order))
        jcode = ref.encode(jnp.asarray(g))
        np.testing.assert_array_equal(_np(code["q"]), _np(jcode["q"]),
                                      err_msg=name)
        np.testing.assert_array_equal(_np(code["scales"]),
                                      _np(jcode["scales"]), err_msg=name)
        dec = interop.from_jax_order(
            ours.decode(code, shape=shape, dtype=torch.float32), order)
        want = interop._to_torch_layout(
            name, _np(ref.decode(jcode, shape=shape, dtype=jnp.float32)))
        np.testing.assert_array_equal(_np(dec), want, err_msg=name)


def _jcode_to_torch(code):
    """A JAX code (an array or a dict of arrays) as torch tensors, bit for
    bit (bf16 through its uint16 pattern)."""
    def one(x):
        a = np.asarray(x)
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(a.view(np.uint16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    return ({k: one(v) for k, v in code.items()} if isinstance(code, dict)
            else one(code))


def _bits(x):
    t = x if isinstance(x, torch.Tensor) else None
    if t is not None and t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


@pytest.mark.parametrize("name", ALL_CODECS)
def test_scale_code_matches_jax_bitwise(name):
    """`Codec.scale_code` on one code and `scale_codes` on a stack of three
    (the async PS's weights) against JAX's ``scale_code`` and
    ``vmap(scale_code)`` on the same code: bitwise — floating leaves times
    the weight cast to their dtype (bf16 in bf16), integer leaves as they
    are.  Then the weighted decode sums, bitwise: the port's
    ``decode_sum_leaves`` (one grouped launch for blockq and bf16) of the
    scaled stack against JAX's ``decode_sum``."""
    rng = np.random.RandomState(3)
    shape = (40, 72)  # 2,880 elements: three blockq tiles at 8 rows
    ours = tcodecs.get_codec(name)
    ref = jcodecs.get_codec(name)
    if name == "blockq":
        ours = tcodecs.BlockQuantizeCodec(block_rows=8)
        ref = jcodecs.BlockQuantizeCodec(block_rows=8)
    jcodes = [ref.encode(jnp.asarray(rng.randn(*shape).astype(np.float32)))
              for _ in range(3)]
    w = np.asarray([0.25, 1.0, 1.0 / 3.0], np.float32)
    got = ours.scale_code(_jcode_to_torch(jcodes[2]), torch.tensor(w[2]))
    want = ref.scale_code(jcodes[2], jnp.asarray(w[2]))
    for k in (want if isinstance(want, dict) else [None]):
        g = got[k] if k is not None else got
        x = want[k] if k is not None else want
        assert g.dtype == _jcode_to_torch(x).dtype, k
        np.testing.assert_array_equal(_bits(g), _bits(x), err_msg=str(k))
    jstacked = jax.tree.map(lambda *xs: jnp.stack(xs), *jcodes)
    tstacked = _jcode_to_torch(jstacked)
    got = ours.scale_codes(tstacked, torch.from_numpy(w))
    want = jax.vmap(ref.scale_code)(jstacked, jnp.asarray(w))
    for k in (want if isinstance(want, dict) else [None]):
        g = got[k] if k is not None else got
        x = want[k] if k is not None else want
        np.testing.assert_array_equal(_bits(g), _bits(x), err_msg=str(k))
    dsum = ours.decode_sum_leaves({"g": got}, {"g": (shape, torch.float32)})
    jsum = ref.decode_sum(want, shape=shape, dtype=jnp.float32)
    np.testing.assert_array_equal(_np(dsum["g"]), _np(jsum))


@pytest.mark.parametrize("name", ALL_CODECS)
def test_scale_code_is_linear_for_all_codecs(name):
    """The contract the async PS's weights rely on (JAX
    `tests/test_codecs.py::test_scale_code_is_linear_for_all_codecs`):
    ``decode_sum(scale_codes(codes, w)) == sum_i w_i * decode(code_i)``,
    through each codec's own decode sum; the JAX test's tolerance (the
    bf16 wire rounds ``w`` and the products to bf16)."""
    rng = np.random.RandomState(0)
    gs = [torch.from_numpy(rng.randn(24, 16).astype(np.float32))
          for _ in range(3)]
    w = torch.tensor([0.25, 1.0, 0.5])
    codec = tcodecs.get_codec(name)
    codes = [codec.encode(g) for g in gs]
    stacked = ({k: torch.stack([c[k] for c in codes]) for k in codes[0]}
               if isinstance(codes[0], dict) else torch.stack(codes))
    got = codec.decode_sum(codec.scale_codes(stacked, w), shape=(24, 16),
                           dtype=torch.float32)
    want = sum(float(wi) * codec.decode(c, shape=(24, 16),
                                        dtype=torch.float32)
               for wi, c in zip(w, codes))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-2, atol=1e-3,
                               err_msg=name)
