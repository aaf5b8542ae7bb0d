"""Plain versions of the port's codec kernels against the JAX package.

Here every wrapper in `pytorch_ps_mpi_tpu_torch.ops.codec_kernels` runs
its plain PyTorch version (its inputs lie on the CPU); the CUDA
kernels are held against those same plain versions on the card by
``chip_smoke.py``.  The JAX side runs as its own tests run it: the
``*_ref`` functions, and the Pallas kernels under ``interpret=True`` where
they offer it (`block_quantize_tpu`, `cast_sum_tpu`).

Tolerance: none.  The quantizer's divide, round and clip are exact float32
operations, and XLA on the CPU sums the world axis in rank order, as the
port does, so codes, scales and both sums must be equal bit for bit (the
``rtol=atol=1e-5`` of ``tests/test_pallas_kernels.py`` would be the
fallback where the two orders differed; at worlds 1-3 they do not).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu.ops import pallas_kernels as pk
from pytorch_ps_mpi_tpu_torch.models import TransformerLM, resnet18
from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
    np.testing.assert_array_equal(a.view(f"u{a.dtype.itemsize}"),
                                  b.view(f"u{b.dtype.itemsize}"))


def _gradient(rng, n, case):
    flat = (rng.randn(n) * rng.choice([1e-4, 1.0, 3e3])).astype(np.float32)
    per = 8 * pk.LANE
    if case == "zero_tile":
        flat[:per] = 0.0
    elif case == "nan_tile":
        flat[per + 5] = np.nan
    return flat


def test_constants_and_layout_match_jax():
    assert (ck.LANE, ck.BLOCK_ROWS) == (pk.LANE, pk.BLOCK_ROWS)
    for n in (1, 127, 128, 1000, 1024, 5000, 65536, 70000, 2_359_296):
        assert ck.rows_for_flat(n) == pk.rows_for_flat(n)
    flat = np.arange(1000, dtype=np.float32)
    x2d, nb = ck.pad_to_blocks(torch.from_numpy(flat), block_rows=8)
    jx2d, jnb = pk.pad_to_blocks(jnp.asarray(flat), block_rows=8)
    assert nb == jnb
    _bits_equal(x2d.numpy(), jx2d)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("rows,n,case", [
    (8, 8 * 128 * 3, "dense"),
    (8, 8 * 128 * 3, "zero_tile"),
    (8, 8 * 128 * 3, "nan_tile"),
    (16, 5000, "ragged"),
    (64, 64 * 128 * 2 - 77, "nan_tile"),
    (512, 512 * 128 + 3, "ragged"),
])
def test_block_quantize_bitwise_matches_jax(bits, rows, n, case):
    rng = np.random.RandomState(rows + n + bits)
    flat = _gradient(rng, n, case)
    q, s = ck.block_quantize(torch.from_numpy(flat), bits=bits,
                             block_rows=rows)
    x2d, _ = pk.pad_to_blocks(jnp.asarray(flat), rows)
    for fn in (pk.block_quantize_ref,
               lambda x, **kw: pk.block_quantize_tpu(x, interpret=True,
                                                     **kw)):
        jq, js = fn(x2d, bits=bits, block_rows=rows)
        _bits_equal(q.numpy(), jq)
        _bits_equal(s.numpy(), js)
    if case == "nan_tile":
        # jnp.max propagates the NaN: that tile's scale is 1.0 and the NaN
        # element quantizes to 0 — and a naive fmaxf reduction would miss it.
        assert s[(8 * pk.LANE + 5) // (rows * pk.LANE), 0] == 1.0
        assert q.reshape(-1)[8 * pk.LANE + 5] == 0
    if case == "zero_tile":
        assert s[0, 0] == 1.0 and not q[:8].any()


@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("bits,rows", [(8, 8), (16, 64), (8, 512)])
def test_block_dequant_sum_bitwise_matches_jax(world, bits, rows):
    rng = np.random.RandomState(world * 100 + rows)
    n_blocks = 3
    qs, ss = [], []
    for _ in range(world):
        x = _gradient(rng, n_blocks * rows * pk.LANE, "dense")
        q, s = pk.block_quantize_ref(jnp.asarray(x).reshape(-1, pk.LANE),
                                     bits=bits, block_rows=rows)
        qs.append(np.asarray(q))
        ss.append(np.asarray(s))
    q, s = np.stack(qs), np.stack(ss)
    ours = ck.block_dequant_sum(torch.from_numpy(q), torch.from_numpy(s),
                                block_rows=rows)
    ref = pk.block_dequant_sum_ref(jnp.asarray(q), jnp.asarray(s),
                                   block_rows=rows)
    _bits_equal(ours.numpy(), ref)


@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cast_sum_bitwise_matches_jax(world, dtype):
    rng = np.random.RandomState(world)
    rows = 16
    x = jnp.asarray(3 * rng.randn(world, 2 * rows, pk.LANE).astype(
        np.float32)).astype(getattr(jnp, dtype))
    wire = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, dtype))
    ours = ck.cast_sum(wire.reshape(world, -1)).reshape(2 * rows, pk.LANE)
    assert ours.dtype == torch.float32
    _bits_equal(ours.numpy(), pk.cast_sum_ref(x))
    _bits_equal(ours.numpy(), pk.cast_sum_tpu(x, block_rows=rows,
                                              interpret=True))


def _main_path_rows():
    """Every tile height `rows_for_flat` gives the parameters of ResNet-18
    and of the bench LM (`bench.py::worker_lm_throughput`), built on the
    meta device (shapes only), and the edge heights: 8 rows, 512 rows, and
    a one-element gradient."""
    with torch.device("meta"):
        models = (resnet18(), TransformerLM(
            vocab_size=32768, d_model=1024, n_heads=16, n_layers=12,
            d_ff=4096, max_len=1024))
    sizes = {p.numel() for m in models for p in m.parameters()}
    return sorted({ck.rows_for_flat(n) for n in sizes | {1}} | {8, 512})


@pytest.mark.parametrize("rows", _main_path_rows())
def test_cluster_ctas_hold_each_tile_in_registers(rows):
    """The block_quantize kernel's cluster per tile: at most 8 CTAs (the
    portable cluster size), a power of two that splits the tile into whole
    4-element groups, each CTA's share at most what its threads hold in
    registers, and the fewest CTAs that do."""
    tile = rows * ck.LANE
    ctas = ck.cluster_ctas(tile)
    assert ctas in (1, 2, 4, 8) and ctas <= ck.MAX_CLUSTER
    groups = tile // 4
    assert groups % ctas == 0
    chunk = ck.QUANT_THREADS * ck.QUANT_VEC  # groups a CTA holds
    assert groups // ctas <= chunk
    assert ctas == 1 or groups // (ctas // 2) > chunk
    if rows == 512:
        assert ctas == 8
    if rows == 8:
        assert ctas == 1


def test_wrappers_take_plain_version_on_cpu_and_count_no_launch():
    ck.reset_launch_counts()
    flat = torch.randn(3000, generator=torch.Generator().manual_seed(0))
    q, s = ck.block_quantize(flat, block_rows=8)
    ck.block_dequant_sum(q[None], s[None], block_rows=8)
    ck.cast_sum(flat[None].to(torch.bfloat16))
    ck.block_dequant_sum_group([(q[None], s[None], 3000, 8)] * 3)
    ck.cast_sum_group([flat[None].to(torch.bfloat16)] * 3)
    assert ck.LAUNCHES == {"block_quantize": 0, "block_dequant_sum": 0,
                           "cast_sum": 0}


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError, match="1-D"):
        ck.block_quantize(torch.zeros(4, 4))
    with pytest.raises(ValueError, match="world"):
        ck.block_dequant_sum(torch.zeros(8, 128, dtype=torch.int8),
                             torch.ones(1, 1))
    with pytest.raises(ValueError, match="do not match"):
        ck.block_dequant_sum(torch.zeros(1, 16, 128, dtype=torch.int8),
                             torch.ones(1, 1, 1), block_rows=8)
    with pytest.raises(ValueError, match=r"\(world, n\)"):
        ck.cast_sum(torch.zeros(4))
    with pytest.raises(ValueError, match="meta"):
        ck.cast_sum(torch.zeros(2, 4, device="meta"))


# ---------------------------------------------------------------------------
# Grouped decode sums: every leaf of a step in one call
# ---------------------------------------------------------------------------

# (n, block_rows) of a dequant group: one element, leaves whose length is
# not a multiple of 4, and tile heights 8, 64 and 512.  Leaves 1-3 share a
# gathered bucket (leaf 2's codes and scales at odd offsets), the last is
# a solo leaf.
_DEQUANT_LEAVES = ((1, 8), (77, 8), (64 * 128 * 2 - 3, 64), (5000, 8),
                   (512 * 128 + 5, 512))
_SHARED = (1, 2, 3)


def _check_group_layout(flat, views, ns):
    """One f32 buffer; each view a 1-D slice of it of its leaf's length, at
    an offset padded to 4 elements, the views in order and disjoint."""
    assert flat.dtype == torch.float32 and flat.dim() == 1
    end = 0
    for v, n in zip(views, ns):
        assert tuple(v.shape) == (n,) and v.is_contiguous()
        assert v.untyped_storage().data_ptr() == (
            flat.untyped_storage().data_ptr())
        off = v.storage_offset() - flat.storage_offset()
        assert off % 4 == 0 and off >= end
        end = off + n
    assert end <= flat.numel() < end + 4


def _bucket_views(rows_per_rank, pad):
    """Pack per-leaf ``(world, m)`` arrays into one ``(world, pad + sum m)``
    bucket after ``pad`` elements, as a gather of a shared bucket lays
    them out; returns the torch views ``(world, m)`` into it."""
    world = rows_per_rank[0].shape[0]
    bucket = np.concatenate(
        [np.zeros((world, pad), rows_per_rank[0].dtype)] + list(
            rows_per_rank), axis=1)
    t = torch.from_numpy(bucket)
    views, off = [], pad
    for a in rows_per_rank:
        views.append(t[:, off:off + a.shape[1]])
        off += a.shape[1]
    return views


@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("bits", [8, 16])
def test_block_dequant_sum_group_bitwise_matches_jax(world, bits):
    """Each leaf of a group equals the JAX ``block_dequant_sum_ref`` of its
    codes (padded to whole tiles as the JAX codec pads) cut to its
    length, bit for bit."""
    rng = np.random.RandomState(10 * world + bits)
    codes = []
    for n, rows in _DEQUANT_LEAVES:
        qs, ss = [], []
        for _ in range(world):
            x2d, _ = pk.pad_to_blocks(jnp.asarray(_gradient(rng, n, "dense")),
                                      rows)
            q, s = pk.block_quantize_ref(x2d, bits=bits, block_rows=rows)
            qs.append(np.asarray(q))
            ss.append(np.asarray(s))
        codes.append((np.stack(qs), np.stack(ss)))
    q_views = _bucket_views([codes[i][0].reshape(world, -1)
                             for i in _SHARED], pad=3)
    s_views = _bucket_views([codes[i][1].reshape(world, -1)
                             for i in _SHARED], pad=1)
    leaves = []
    for i, ((n, rows), (q, s)) in enumerate(zip(_DEQUANT_LEAVES, codes)):
        if i in _SHARED:
            k = _SHARED.index(i)
            tq = q_views[k].view(q.shape)
            ts = s_views[k].view(s.shape)
        else:
            tq, ts = torch.from_numpy(q), torch.from_numpy(s)
        leaves.append((tq, ts, n, rows))
    assert leaves[2][0].storage_offset() % 2 == 1
    flat, views = ck.block_dequant_sum_group(leaves)
    _check_group_layout(flat, views, [n for n, _ in _DEQUANT_LEAVES])
    for (n, rows), (q, s), v in zip(_DEQUANT_LEAVES, codes, views):
        ref = pk.block_dequant_sum_ref(jnp.asarray(q), jnp.asarray(s),
                                       block_rows=rows)
        _bits_equal(v.numpy(), np.asarray(ref).reshape(-1)[:n])


_CAST_SIZES = (1, 77, 10, 4099, 64, 3, 2 * 8 * 128)


@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_cast_sum_group_bitwise_matches_jax(world, dtype):
    """A cast group laid out as a gather lays it out: all but the last
    leaf in one shared bucket at odd element offsets (after a 1-element
    head), the last a solo leaf.  Each leaf equals the JAX
    ``cast_sum_ref`` of its wire rows, bit for bit."""
    rng = np.random.RandomState(world)
    wires = [jnp.asarray((3 * rng.randn(world, n)).astype(np.float32))
             .astype(getattr(jnp, dtype)) for n in _CAST_SIZES]
    rows = [np.array(w.astype(jnp.float32)) for w in wires]
    bucket = torch.from_numpy(np.concatenate(
        [np.zeros((world, 1), np.float32)] + rows[:-1], axis=1)).to(
            getattr(torch, dtype))
    offs = np.cumsum([1] + [r.shape[1] for r in rows[:-1]])
    leaves = [bucket[:, offs[i]:offs[i + 1]] for i in range(len(rows) - 1)]
    leaves.append(torch.from_numpy(rows[-1]).to(getattr(torch, dtype)))
    assert any(x.storage_offset() % 2 for x in leaves)
    flat, views = ck.cast_sum_group(leaves)
    _check_group_layout(flat, views, list(_CAST_SIZES))
    for w, v in zip(wires, views):
        _bits_equal(v.numpy(), pk.cast_sum_ref(w))


def _q(world=1, rows=8, dtype=torch.int8, device="cpu"):
    return torch.zeros(world, rows, 128, dtype=dtype, device=device)


def _s(world=1, n_blocks=1, dtype=torch.float32, device="cpu"):
    return torch.ones(world, n_blocks, 1, dtype=dtype, device=device)


@pytest.mark.parametrize("leaves,match", [
    ([(_q(), _s(), 10, 8), (_q(device="meta"), _s(device="meta"), 10, 8)],
     "lie on"),
    ([(_q(), _s(), 10, 8), (_q(), _s(device="meta"), 10, 8)], "lie on"),
    ([(_q(dtype=torch.float32), _s(), 10, 8)], "int8/int16"),
    ([(_q(), _s(), 10, 8), (_q(dtype=torch.int16), _s(), 10, 8)],
     "int8/int16"),
    ([(_q(), _s(dtype=torch.float64), 10, 8)], "int8/int16"),
    ([(_q(rows=16), _s(), 10, 8)], "do not match"),
    ([(_q(world=2), _s(), 10, 8)], "do not match"),
    ([(_q(), _s(), 10, 8), (_q(world=2), _s(world=2), 10, 8)], "world"),
    ([(_q(), _s(), 8 * 128 + 1, 8)], "does not fit"),
    ([], "at least one"),
])
def test_block_dequant_sum_group_rejects_bad_leaves(leaves, match):
    with pytest.raises(ValueError, match=match):
        ck.block_dequant_sum_group(leaves)


@pytest.mark.parametrize("leaves,match", [
    ([torch.zeros(2, 4), torch.zeros(2, 4, device="meta")], "lie on"),
    ([torch.zeros(2, 4, device="meta")], "meta"),
    ([torch.zeros(2, 4), torch.zeros(2, 4, dtype=torch.bfloat16)],
     "one dtype"),
    ([torch.zeros(2, 4, dtype=torch.int32)], "bf16/f16/f32"),
    ([torch.zeros(2, 4), torch.zeros(3, 4)], "world"),
    ([torch.zeros(4)], r"\(world, n\)"),
    ([], "at least one"),
])
def test_cast_sum_group_rejects_bad_leaves(leaves, match):
    with pytest.raises(ValueError, match=match):
        ck.cast_sum_group(leaves)
