"""The transformer LM of the port against the flax LM of the JAX package.

A tiny LM (2 heads, 1-2 layers) with flax's weights carried across by
`params_from_jax`, flash attention on both sides (the port's plain
versions, the Pallas kernels in interpret mode): logits, loss and every
named gradient must match.  Then a 3-step world-1 SGD trajectory with the
identity and blockq codecs against the JAX `SGD`, and the full bench
configuration's names, shapes and wire bytes from shapes alone.

Tolerances:

* f32: ``rtol=1e-4, atol=1e-5`` — XLA and PyTorch sum the matmuls and the
  LayerNorm statistics in other orders (flax takes the variance as
  ``E[x^2] - E[x]^2``), a few f32 ulps per op, and the gradients pass
  through every layer;
* bf16: ``rtol=atol=5e-2`` on the logits and loss, gradients within 5e-2
  of their largest magnitude — every matmul rounds to bf16, and XLA fuses
  and rounds elementwise chains (bias add, GELU, residual adds) at other
  places than PyTorch's op-by-op execution, each a step of 2^-8;
* trajectories: losses and parameters ``rtol=1e-4, atol=1e-5``, as f32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu import SGD as JSGD
from pytorch_ps_mpi_tpu.data.datasets import synthetic_lm as jsynthetic_lm
from pytorch_ps_mpi_tpu.models import transformer as jt
from pytorch_ps_mpi_tpu.ops.codecs import get_codec as jget_codec
from pytorch_ps_mpi_tpu.ops.flash_attention import flash_attention as jflash
from pytorch_ps_mpi_tpu.parallel.mesh import make_ps_mesh
from pytorch_ps_mpi_tpu_torch import SGD
from pytorch_ps_mpi_tpu_torch import get_codec
from pytorch_ps_mpi_tpu_torch.data.datasets import synthetic_lm
from pytorch_ps_mpi_tpu_torch.models import transformer as tt
from pytorch_ps_mpi_tpu_torch.ops.flash_attention import flash_attention
from pytorch_ps_mpi_tpu_torch.utils.interop import params_from_jax

F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)

# The bench LM (`bench.py::worker_lm_throughput`).
BENCH = dict(vocab_size=32768, d_model=1024, n_heads=16, n_layers=12,
             d_ff=4096, max_len=1024)
BENCH_MSG_BYTES = 877387776
BENCH_PACKAGED = {"identity": 877387776, "bf16": 438693888,
                  "blockq": 219360716}


def _pair(cfg, jdtype=jnp.float32, tdtype=torch.float32, flash=True,
          seed=1):
    """The flax LM and the port's LM of one config, with flax's weights
    (perturbed, so LayerNorm scales and biases are not trivial) carried
    across.  Returns ``(jmodel, jparams, tmodel, tparams)``."""
    jattn = functools.partial(jflash, causal=True) if flash else None
    tattn = functools.partial(flash_attention, causal=True) if flash else None
    jm = jt.TransformerLM(**cfg, dtype=jdtype, attn=jattn)
    rng = np.random.RandomState(seed)
    jp = {n: (np.asarray(p) + 0.05 * rng.randn(*p.shape)).astype(np.float32)
          for n, p in jt.build_lm(jm, seq_len=8, seed=seed).items()}
    tm = tt.TransformerLM(**cfg, dtype=tdtype, attn=tattn)
    tp, _ = params_from_jax(jp)
    assert list(tp) and set(tp) == {n for n, _ in tm.named_parameters()}
    return jm, jp, tm, tp


def _tokens(vocab, b, s, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, size=(b, s + 1))


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _compare(jm, jp, tm, tp, batch, logits_tol, grad_check):
    jloss, jgrads = jax.jit(jax.value_and_grad(jt.make_lm_loss(jm)))(
        jp, batch)
    jlogits = jax.jit(lambda p, b: jm.apply(
        {"params": jt_unflatten(p)}, b["tokens"], b["positions"]))(jp, batch)
    leaves = {n: p.clone().requires_grad_() for n, p in tp.items()}
    tb = _torch_batch(batch)
    logits = torch.func.functional_call(tm, leaves,
                                        (tb["tokens"], tb["positions"]))
    assert logits.dtype == torch.float32
    loss = tt.make_lm_loss(tm)(leaves, tb)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **logits_tol)
    np.testing.assert_allclose(loss.item(), float(jloss), **logits_tol)
    want, _ = params_from_jax({n: np.asarray(g) for n, g in jgrads.items()})
    for n, g in zip(leaves, grads):
        grad_check(g.numpy(), want[n].numpy(), n)


def jt_unflatten(named):
    from pytorch_ps_mpi_tpu.utils.flatten import unflatten_params

    return unflatten_params(named)


@pytest.mark.parametrize("cfg,b,s", [
    (dict(vocab_size=17, d_model=16, n_heads=2, n_layers=1, d_ff=32,
          max_len=64), 4, 16),
    (dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
          max_len=64), 2, 40),
])
def test_lm_matches_flax_f32(cfg, b, s):
    jm, jp, tm, tp = _pair(cfg)
    batch = jt.lm_batch(_tokens(cfg["vocab_size"], b, s))

    def check(g, w, n):
        np.testing.assert_allclose(g, w, err_msg=n, **F32_TOL)

    _compare(jm, jp, tm, tp, batch, F32_TOL, check)


def test_lm_default_dense_attention_matches_flax():
    cfg = dict(vocab_size=23, d_model=16, n_heads=2, n_layers=2, d_ff=32,
               max_len=32)
    jm, jp, tm, tp = _pair(cfg, flash=False, seed=4)
    batch = jt.lm_batch(_tokens(23, 3, 20, seed=5))

    def check(g, w, n):
        np.testing.assert_allclose(g, w, err_msg=n, **F32_TOL)

    _compare(jm, jp, tm, tp, batch, F32_TOL, check)


def test_lm_matches_flax_bf16():
    cfg = dict(vocab_size=32, d_model=32, n_heads=2, n_layers=2, d_ff=64,
               max_len=64)
    jm, jp, tm, tp = _pair(cfg, jnp.bfloat16, torch.bfloat16, seed=2)
    batch = jt.lm_batch(_tokens(32, 2, 24, seed=3))

    def check(g, w, n):
        scale = max(float(np.abs(w).max()), 1e-3)
        assert float(np.abs(g - w).max()) <= 5e-2 * scale, n

    _compare(jm, jp, tm, tp, batch, BF16_TOL, check)


@pytest.mark.parametrize("code", ["identity", "blockq"])
def test_world1_sgd_trajectory_matches_jax(code):
    cfg = dict(vocab_size=29, d_model=16, n_heads=2, n_layers=1, d_ff=32,
               max_len=32)
    jm, jp, tm, tp = _pair(cfg, seed=6)
    batches = [jt.lm_batch(_tokens(29, 4, 24, seed=10 + i)) for i in range(3)]
    jopt = JSGD(list(jp.items()), lr=0.1, momentum=0.9, code=code,
                mesh=make_ps_mesh(1))
    jopt.compile_step(jt.make_lm_loss(jm))
    opt = SGD(list(tp.items()), lr=0.1, momentum=0.9, code=code,
              device="cpu")
    opt.compile_step(tt.make_lm_loss(tm))
    for batch in batches:
        jl, jmetrics = jopt.step(batch)
        tl, metrics = opt.step(batch)
        np.testing.assert_allclose(tl, jl, **F32_TOL)
        assert metrics["msg_bytes"] == jmetrics["msg_bytes"]
        assert metrics["packaged_bytes"] == jmetrics["packaged_bytes"]
    want, _ = params_from_jax({n: np.asarray(p)
                               for n, p in jopt.params.items()})
    for n, p in opt.params.items():
        np.testing.assert_allclose(p.numpy(), want[n].numpy(), err_msg=n,
                                   **F32_TOL)


def _bench_shapes():
    jm = jt.TransformerLM(**BENCH, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    from pytorch_ps_mpi_tpu.utils.flatten import named_params

    return {n: np.zeros(s.shape, np.float32)
            for n, s in named_params(shapes).items()}, named_params(shapes)


def test_bench_lm_names_and_shapes_match_flax():
    """The full bench config: 150 tensors, 219,346,944 parameters, each
    under flax's name in torch's layout (shapes only, nothing drawn)."""
    jnamed, _ = _bench_shapes()
    want, _ = params_from_jax(jnamed)
    model = tt.TransformerLM(**BENCH, dtype=torch.bfloat16)
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == {n: tuple(p.shape) for n, p in want.items()}
    assert len(got) == 150
    assert sum(p.numel() for p in model.parameters()) == 219346944


@pytest.mark.parametrize("code", ["identity", "bf16", "blockq"])
def test_bench_lm_wire_bytes_match_jax(code):
    """``msg_bytes`` and ``packaged_bytes`` of one step of the bench LM,
    from the shapes alone through each codec's ``wire_bytes``."""
    _, jshapes = _bench_shapes()
    model = tt.TransformerLM(**BENCH, dtype=torch.bfloat16)
    params = list(model.named_parameters())
    msg = sum(p.numel() * p.element_size() for _, p in params)
    packaged = sum(get_codec(code).wire_bytes(p.shape, p.dtype)
                   for _, p in params)
    jcodec = jget_codec(code)
    jpackaged = sum(jcodec.wire_bytes(s.shape, s.dtype)
                    for s in jshapes.values())
    assert msg == BENCH_MSG_BYTES
    assert packaged == jpackaged == BENCH_PACKAGED[code]


def test_build_lm_initialises_like_flax():
    """Same names and shapes as flax's init, drawn from the same
    distributions (the draws differ between the packages): truncated
    lecun-normal Dense kernels, zero biases, unit LayerNorm scales,
    normal(1/sqrt(d)) embeddings; the same seed gives the same weights."""
    cfg = dict(vocab_size=300, d_model=64, n_heads=2, n_layers=1, d_ff=256,
               max_len=128)
    params = tt.build_lm(tt.TransformerLM(**cfg), seed=0)
    again = tt.build_lm(tt.TransformerLM(**cfg), seed=0)
    jparams = jt.build_lm(jt.TransformerLM(**cfg), seq_len=8, seed=0)
    want, _ = params_from_jax({n: np.asarray(p) for n, p in jparams.items()})
    assert {n: tuple(p.shape) for n, p in params.items()} == {
        n: tuple(p.shape) for n, p in want.items()}
    for n in params:
        torch.testing.assert_close(params[n], again[n], rtol=0, atol=0)
    assert (params["block_0.LayerNorm_0.weight"] == 1).all()
    assert not params["block_0.qkv.bias"].any()
    assert not params["lm_head.bias"].any()
    w = params["block_0.fc2.weight"]  # fan_in 256
    std = np.sqrt(1.0 / 256) / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std
    assert abs(float(w.std()) - np.sqrt(1.0 / 256)) < 0.05 * std
    emb = params["tok_embed.weight"]
    assert abs(float(emb.std()) - 1 / 8) < 0.05 / 8
    assert abs(float(emb.std()) - float(want["tok_embed.weight"].std())) \
        < 0.05 / 8


def test_unported_options_raise():
    """Tensor and expert parallelism are ported
    (`tests/test_torch_model_parallel.py`); a ``tp_axis`` or ``ep_axis``
    that no current mesh binds raises at the forward, as JAX's unbound
    axis does, and never runs dense."""
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    for kw, axis in ((dict(tp_axis="tp"), "tp"),
                     (dict(moe_experts=4, ep_axis="ep"), "ep")):
        lm = tt.TransformerLM(vocab_size=8, d_model=8, n_heads=2, **kw)
        with pytest.raises(NameError, match=f"unbound axis name: {axis}"):
            lm(tokens)
        jm = jt.TransformerLM(vocab_size=8, d_model=8, n_heads=2, **kw)
        with pytest.raises(NameError, match=f"unbound axis name: {axis}"):
            jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    assert tt.TransformerLM(vocab_size=8, moe_experts=4).moe_experts == 4


def test_synthetic_lm_and_lm_batch_match_jax():
    toks = synthetic_lm(16, seq_len=33, vocab=97, seed=3)
    np.testing.assert_array_equal(toks, jsynthetic_lm(16, seq_len=33,
                                                      vocab=97, seed=3))
    ours, want = tt.lm_batch(toks), jt.lm_batch(toks)
    assert set(ours) == set(want)
    for k in want:
        assert ours[k].dtype == np.int32
        np.testing.assert_array_equal(ours[k], np.asarray(want[k]))
