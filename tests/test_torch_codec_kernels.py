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
