"""The wire payloads: the serializer's scatter-gather encode and the
parameter wire codecs, against the JAX package.

`native.serializer.encode_segments` must give the bytes `dumps` gives, as
an iovec whose buffer frames are byte for byte the JAX package's (the tree
frame differs by design: ``PSTP`` against the JAX ``PST2``).  A bf16 code
leaf, which numpy cannot hold without ``ml_dtypes``, crosses as its 16-bit
patterns and comes back as a ``torch.bfloat16`` tensor bit for bit.  The
host wire codecs (`ops.codecs.encode_wire_tree`) are copies of the JAX
package's and are held bitwise on the same numpy inputs.
"""

import zlib
from collections import OrderedDict

import jax
import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu.native import serializer as jser
from pytorch_ps_mpi_tpu.ops import codecs as jcodecs
from pytorch_ps_mpi_tpu_torch.native import serializer as tser
from pytorch_ps_mpi_tpu_torch.ops import codecs as tcodecs


def _tree(seed: int):
    rng = np.random.default_rng(seed)
    return OrderedDict(
        w=rng.standard_normal((33, 17)).astype(np.float32),
        b=rng.standard_normal(17).astype(np.float32),
        codes={"q": rng.integers(-127, 128, (3, 1024)).astype(np.int8),
               "scales": rng.random(3).astype(np.float32)},
        step=np.int64(7),
        ids=rng.integers(0, 2 ** 31, 9).astype(np.int32),
        empty=np.zeros((0, 4), np.float32))


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("seed", [0, 1])
def test_encode_segments_equals_dumps_and_jax_buffer_frames(level, seed):
    tree = _tree(seed)
    meta, segs = tser.encode_segments(tree, level=level)
    whole = b"".join([meta, *(bytes(s) for s in segs)])
    assert whole == tser.dumps(tree, level=level)
    assert segs.wire_len == len(whole)
    assert segs.wire_crc == zlib.crc32(whole)
    jmeta, jsegs = jser.encode_segments(tree, level=level)
    assert meta[:4] == b"PSTP" and jmeta[:4] == b"PST2"
    assert [bytes(s) for s in segs] == [bytes(s) for s in jsegs]
    back = tser.loads(whole)
    for (n, a), b in zip(jax.tree_util.tree_leaves_with_path(tree),
                         jax.tree_util.tree_leaves(back)):
        assert np.asarray(b).dtype == np.asarray(a).dtype, n
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_level0_segments_alias_the_callers_leaves():
    a = np.arange(64, dtype=np.float32)
    _, segs = tser.encode_segments({"a": a}, level=0)
    view = np.frombuffer(segs[1], np.float32)
    assert np.shares_memory(view, a)


@pytest.mark.parametrize("shape", [(7, 3), (0,), (), (4096,)])
def test_bf16_leaves_round_trip_bit_for_bit(shape):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(shape, generator=g).to(torch.bfloat16)
    if x.numel():
        x.view(-1)[0] = float("nan")
        x.view(-1)[-1] = float("-inf")
    tree = OrderedDict(w=x, q=torch.arange(6, dtype=torch.int8))
    meta, segs = tser.encode_segments(tree)
    blob = b"".join([meta, *(bytes(s) for s in segs)])
    assert blob == tser.dumps(tree, level=0)
    back = tser.loads(blob)
    assert isinstance(back["w"], torch.Tensor)
    assert back["w"].dtype == torch.bfloat16
    assert back["w"].shape == x.shape
    assert torch.equal(back["w"].view(torch.int16), x.view(torch.int16))
    lz = tser.loads(tser.dumps(tree, level=1))
    assert torch.equal(lz["w"].view(torch.int16), x.view(torch.int16))
    np.testing.assert_array_equal(back["q"], np.arange(6, dtype=np.int8))


def test_bf16_payload_is_the_bits_under_the_ports_tag():
    x = torch.tensor([1.0, -2.5, 3.0e38], dtype=torch.bfloat16)
    _, segs = tser.encode_segments({"w": x})
    assert bytes(segs[1]) == x.view(torch.int16).numpy().tobytes()
    meta = tser._restricted_loads(
        tser.dumps({"w": x})[tser._TREE_HDR.size:][
            :tser._TREE_HDR.unpack_from(tser.dumps({"w": x}))[1]])
    assert meta["dtypes"] == ["bf16"]


def _wire_inputs(seed: int):
    rng = np.random.default_rng(seed)
    big = rng.standard_normal((70, 90)).astype(np.float32) * 3
    big[0, :6] = [np.nan, np.inf, -np.inf, -0.0, 1e-40, 3.4e38]
    zeros = np.zeros((64, 64), np.float32)  # a block with amax 0
    return OrderedDict(
        big=big, zeros=zeros,
        small=rng.standard_normal(5).astype(np.float32),   # sub-block
        odd=rng.standard_normal(4097).astype(np.float32),  # 2 blocks
        step=np.arange(3, dtype=np.int64),                 # passes through
        half=rng.standard_normal(8).astype(np.float16),
        nested={"k": rng.standard_normal((130,)).astype(np.float32)})


def _bits(x):
    a = np.ascontiguousarray(np.asarray(x))
    return a.dtype, a.shape, a.view(np.uint8).tobytes()


@pytest.mark.parametrize("codec", ["identity", "bf16", "int8"])
@pytest.mark.parametrize("seed", [0, 1])
def test_wire_codecs_match_jax_bitwise(codec, seed):
    tree = _wire_inputs(seed)
    with np.errstate(invalid="ignore"):
        t = tcodecs.encode_wire_tree(codec, tree)
        j = jcodecs.encode_wire_tree(codec, tree)
    tl, ttd = jax.tree_util.tree_flatten(t)
    jl, jtd = jax.tree_util.tree_flatten(j)
    assert ttd == jtd
    assert [_bits(x) for x in tl] == [_bits(x) for x in jl]
    cid = tcodecs.wire_codec_id(codec)
    assert cid == jcodecs.wire_codec_id(codec)
    td = tcodecs.decode_wire_tree(cid, t)
    jd = jcodecs.decode_wire_tree(cid, j)
    assert ([_bits(x) for x in jax.tree_util.tree_leaves(td)]
            == [_bits(x) for x in jax.tree_util.tree_leaves(jd)])
    if codec == "identity":
        assert t is tree
    assert tcodecs.tree_raw_nbytes(tree) == jcodecs.tree_raw_nbytes(tree)


def test_wire_codec_ids_and_refusals_match_jax():
    assert tcodecs.WIRE_CODEC_IDS == jcodecs.WIRE_CODEC_IDS
    with pytest.raises(ValueError, match="unknown wire codec"):
        tcodecs.wire_codec_id("zstd")
    with pytest.raises(ValueError, match="unknown wire codec id"):
        tcodecs.decode_wire_tree(9, {})


def test_int8_wire_block_length_by_leaf_size():
    for n, blk in ((1, 64), (64, 64), (65, 128), (4000, 4032),
                   (4096, 4096), (10_000, 4096)):
        assert tcodecs._wire_block_for(n) == blk
        assert jcodecs._wire_block_for(n) == blk
