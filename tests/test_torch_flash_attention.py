"""Flash attention of the port against the JAX package's.

On the CPU the port's `flash_attention` runs its plain versions
(`flash_fwd_ref`, `flash_bwd_dkdv_ref`, `flash_bwd_dq_ref`), which repeat
the Pallas kernels' tile math; the JAX `flash_attention` runs its Pallas
kernels in interpret mode, as `tests/test_flash_attention.py` runs them,
and the JAX `dense_attention` is the oracle for both.  The same numpy
inputs go through all three.

Tolerances:

* forward, f32: ``rtol=2e-5, atol=2e-6`` — the two flash versions tile the
  keys differently (64 rows here, up to 1024 in the Pallas kernel), so the
  running max and the sums move by a few f32 ulps;
* gradients, f32: ``rtol=2e-4, atol=2e-5`` — the backward adds a product
  of f32 sums over up to 640 rows, in other orders;
* bf16: ``rtol=atol=2e-2`` — both versions round ``p`` and ``ds`` to bf16
  before each product, and one f32 ulp of difference in a score can move
  that rounding by one bf16 step (2^-8 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu.ops.flash_attention import flash_attention as jflash
from pytorch_ps_mpi_tpu.parallel.ring_attention import \
    dense_attention as jdense
from pytorch_ps_mpi_tpu_torch.ops import flash_attention as fa
from pytorch_ps_mpi_tpu_torch.parallel.ring_attention import dense_attention

FWD_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _qkv(seed, b=2, s=96, h=2, d=8):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, h, d).astype(np.float32) for _ in range(3)]


def _torch(xs, dtype=torch.float32, grad=False):
    return [torch.from_numpy(x).to(dtype).requires_grad_(grad) for x in xs]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [64, 96, 128, 168, 256])
def test_forward_matches_jax_flash_and_dense(causal, s):
    qkv = _qkv(0, s=s)
    got = fa.flash_attention(*_torch(qkv), causal=causal).numpy()
    jq = [jnp.asarray(x) for x in qkv]
    np.testing.assert_allclose(got, np.asarray(jflash(*jq, causal=causal)),
                               **FWD_TOL)
    np.testing.assert_allclose(got, np.asarray(jdense(*jq, causal=causal)),
                               **FWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [40, 168])
def test_forward_head_dim_20_and_scale_override(causal, s):
    qkv = _qkv(1, b=1, s=s, h=3, d=20)
    got = fa.flash_attention(*_torch(qkv), causal=causal, scale=0.2).numpy()
    jq = [jnp.asarray(x) for x in qkv]
    for want in (jflash(*jq, causal=causal, scale=0.2),
                 jdense(*jq, causal=causal, scale=0.2)):
        np.testing.assert_allclose(got, np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,h", [(152, 2), (640, 1)])
def test_gradients_match_jax_flash_and_dense(causal, s, h):
    """s=152 crosses a tile edge with a ragged tail; s=640 is ten of the
    port's tiles and a 2x2 grid of the Pallas backward's 512-row tiles."""
    qkv = _qkv(2, b=1, s=s, h=h, d=16)
    tgt = np.random.RandomState(3).randn(1, s, h, 16).astype(np.float32)

    def jloss(attn):
        return lambda q, k, v: jnp.sum(
            jnp.sin(attn(q, k, v, causal=causal)) * tgt)

    jq = [jnp.asarray(x) for x in qkv]
    tq = _torch(qkv, grad=True)
    out = fa.flash_attention(*tq, causal=causal)
    got = torch.autograd.grad(
        torch.sum(torch.sin(out) * torch.from_numpy(tgt)), tq)
    for attn in (jflash, jdense):
        want = jax.grad(jloss(attn), argnums=(0, 1, 2))(*jq)
        for g, w, name in zip(got, want, "qkv"):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg=f"d{name}", **GRAD_TOL)


def test_bf16_forward_and_gradients_match_jax_flash():
    qkv = _qkv(4, s=96, d=16)
    do = np.random.RandomState(5).randn(*qkv[0].shape).astype(np.float32)
    jq = [jnp.asarray(x, jnp.bfloat16) for x in qkv]
    jo, vjp = jax.vjp(lambda q, k, v: jflash(q, k, v, causal=True), *jq)
    jgrads = vjp(jnp.asarray(do, jnp.bfloat16))
    tq = _torch(qkv, torch.bfloat16, grad=True)
    out = fa.flash_attention(*tq, causal=True)
    assert out.dtype == torch.bfloat16
    got = torch.autograd.grad(out, tq, torch.from_numpy(do).bfloat16())
    pairs = [(out, jo)] + list(zip(got, jgrads))
    for (ours, want), name in zip(pairs, ["o", "dq", "dk", "dv"]):
        assert ours.dtype == torch.bfloat16, name
        np.testing.assert_allclose(ours.float().detach().numpy(),
                                   np.asarray(want, np.float32),
                                   err_msg=name, **BF16_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_dense_attention_matches_jax(causal):
    qkv = _qkv(6, s=48, h=3, d=8)
    got = dense_attention(*_torch(qkv), causal=causal).numpy()
    want = jdense(*[jnp.asarray(x) for x in qkv], causal=causal)
    np.testing.assert_allclose(got, np.asarray(want), **FWD_TOL)


def test_plain_versions_keep_the_kernel_contract():
    """Shapes and dtypes the kernels also return: ``o`` and the gradients
    in the operands' dtype and layout, ``lse`` f32 ``[B, H, S]`` equal to
    the dense logsumexp, no launch counted on the CPU."""
    fa.reset_launch_counts()
    q, k, v = _torch(_qkv(7, b=2, s=70, h=3, d=8))
    do = torch.randn_like(q)
    o, lse = fa.flash_fwd(q, k, v, causal=True, scale=0.3)
    assert o.shape == q.shape and lse.shape == (2, 3, 70)
    assert lse.dtype == torch.float32
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.3
    sc = sc.masked_fill(~torch.ones(70, 70, dtype=torch.bool).tril(),
                        float("-inf"))
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(sc, -1).numpy(),
                               rtol=1e-6, atol=1e-5)
    delta = torch.sum(do * o, -1).transpose(1, 2)
    dk, dv = fa.flash_bwd_dkdv(q, k, v, do, lse, delta, causal=True,
                               scale=0.3)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=True, scale=0.3)
    assert dq.shape == dk.shape == dv.shape == q.shape
    assert fa.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dkdv": 0,
                           "flash_bwd_dq": 0}


def test_kernel_head_dims_and_dtypes():
    """What the CUDA wrappers hand the kernels, checked where it is plain
    Python: D pads up to 64 or 128, zero-filled; D > 128 and dtypes other
    than bf16/f32 raise; a strided row layout passes through as it is."""
    def t(d, dtype=torch.float32):
        return torch.zeros(1, 4, 2, d, dtype=dtype)

    assert [fa._kernel_dim(t(d)) for d in (1, 20, 64, 65, 96, 128)] == [
        64, 64, 64, 128, 128, 128]
    assert fa._kernel_dim(t(64, torch.bfloat16)) == 64
    with pytest.raises(ValueError, match="at most 128"):
        fa._kernel_dim(t(129))
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fa._kernel_dim(t(64, torch.float16))
    x = torch.randn(1, 4, 2, 20)
    padded = fa._kernel_operand(x, 64)
    assert padded.shape == (1, 4, 2, 64) and not padded[..., 20:].any()
    torch.testing.assert_close(padded[..., :20], x)
    qkv = torch.randn(2, 8, 4, 3, 64)
    q = qkv.unbind(3)[1]
    assert fa._kernel_operand(q, 64).data_ptr() == q.data_ptr()
    assert list(fa._strides([q])[:3]) == [8 * 4 * 3 * 64, 4 * 3 * 64, 3 * 64]


def _layout(name):
    """A ``[2, 8, 4, 64]`` bf16 operand in one of four row layouts."""
    if name == "contiguous":
        return torch.zeros(2, 8, 4, 64, dtype=torch.bfloat16)
    if name == "qkv view":
        return torch.zeros(2, 8, 4, 3, 64, dtype=torch.bfloat16).unbind(3)[1]
    if name == "heads outside seq":
        return torch.zeros(2, 4, 8, 64, dtype=torch.bfloat16).transpose(1, 2)
    return torch.zeros(2, 8, 4, 65, dtype=torch.bfloat16)[..., :64]


@pytest.mark.parametrize("name, as_is", [
    ("contiguous", True), ("qkv view", True),
    ("heads outside seq", False), ("rows 130 bytes apart", False)])
def test_kernel_operand_row_layouts(name, as_is):
    """The layouts the kernels' TMA tensor maps over ``[D, H, S, B]`` take
    as they are (unit stride along D, 16-byte aligned row starts, strides
    nested as [D, H, S, B]); the wrappers copy any other to contiguous."""
    t = _layout(name)
    assert t.shape == (2, 8, 4, 64)
    assert fa._rows_ok(t) is as_is
    op = fa._kernel_operand(t, 64)
    assert (op.data_ptr() == t.data_ptr()) is as_is
    assert fa._rows_ok(op) and torch.equal(op, t)


@pytest.mark.parametrize("kernel, dtype, dk, rows", [
    ("flash_fwd", torch.bfloat16, 64, 128),
    ("flash_fwd", torch.bfloat16, 128, 128),
    ("flash_bwd_dkdv", torch.bfloat16, 64, 128),
    ("flash_bwd_dkdv", torch.bfloat16, 128, 64),
    ("flash_bwd_dq", torch.bfloat16, 64, 128),
    ("flash_bwd_dq", torch.bfloat16, 128, 128),
    ("flash_fwd", torch.float32, 64, 64),
    ("flash_bwd_dkdv", torch.float32, 128, 64)])
def test_kernel_grid_limits(kernel, dtype, dk, rows):
    """Each kernel's grid has a block per ``rows`` rows of S (at most
    65535) and one per (batch, head) (fewer than 2^31)."""
    assert fa.BLOCK_ROWS.get((kernel, dtype, dk), fa.TILE) == rows
    fa._check_len(kernel, dtype, dk, 1, 65535 * rows - 1, 1)
    with pytest.raises(ValueError, match=f"S < {65535 * rows}"):
        fa._check_len(kernel, dtype, dk, 1, 65535 * rows, 1)
    with pytest.raises(ValueError, match=r"B\*H < 2\^31"):
        fa._check_len(kernel, dtype, dk, 2 ** 16, 64, 2 ** 15)


def test_operands_must_agree():
    q, k, v = _torch(_qkv(8, s=16))
    with pytest.raises(ValueError, match="one shape"):
        fa.flash_fwd(q, k[:, :8], v, causal=False, scale=1.0)
    with pytest.raises(ValueError, match="differ in dtype"):
        fa.flash_fwd(q, k.double(), v, causal=False, scale=1.0)
    with pytest.raises(ValueError, match="lie on"):
        fa.flash_fwd(q.to("meta"), k, v, causal=False, scale=1.0)
