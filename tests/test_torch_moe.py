"""The dense mixture-of-experts layer and LM of the port against the JAX
package's (`models/moe.py::MoEMLP` with ``ep_axis=None``), on the CPU.

* `MoEMLP` with flax's weights carried across, f32 and bf16, at a
  capacity tight enough that tokens drop: output, aux loss and every
  gradient.  Routing (each token's expert, slot and keep) is held
  bitwise: it is an argmax over ``toks.f32 @ router``, and a last-bit
  difference in that product could flip a near tie, so the inputs are
  checked to have a top-2 probability margin above 1e-4 for every token.
* `TransformerLM(moe_experts=4)`'s loss with ``aux_weight`` and its
  gradients; `params_from_jax` on the MoE leaves; the CLI's
  ``--moe-experts`` on the sync, ``--async-ps`` and ``--serve`` /
  ``--connect`` roles.

Tolerances are `tests/test_torch_transformer.py`'s for the dense LM: f32
``rtol=1e-4, atol=1e-5``; bf16 ``rtol=atol=5e-2`` on outputs and losses,
gradients within 5e-2 of their largest magnitude.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu.models import moe as jmoe
from pytorch_ps_mpi_tpu.models import transformer as jt
from pytorch_ps_mpi_tpu.utils.flatten import named_params, unflatten_params
from pytorch_ps_mpi_tpu_torch import train as ttrain
from pytorch_ps_mpi_tpu_torch.models import moe as tmoe
from pytorch_ps_mpi_tpu_torch.models import transformer as tt
from pytorch_ps_mpi_tpu_torch.utils.interop import jax_order, params_from_jax

F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
LEAVES = ("router", "w1", "b1", "w2", "b2")
MARGIN = 1e-4


def _jax_routing(x, wr, E, cf):
    """The JAX layer's routing, its ops verbatim (`models/moe.py`):
    ``(expert, slot, keep, margin)`` per token."""
    T = x.shape[0] * x.shape[1]
    toks = x.reshape(T, -1)
    probs = jax.nn.softmax(toks.astype(jnp.float32) @ wr, axis=-1)
    expert = jnp.argmax(probs, axis=-1)
    onehot = jax.nn.one_hot(expert, E, dtype=jnp.float32)
    C = max(1, int(np.ceil(T * cf / E)))
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - 1.0) * onehot, axis=1)
    keep = (pos < C).astype(jnp.float32)
    slot = jnp.where(keep > 0, (expert * C + pos.astype(jnp.int32)),
                     E * C)
    top2 = jnp.sort(probs, axis=-1)[:, -2:]
    return (np.asarray(expert), np.asarray(slot), np.asarray(keep),
            float(jnp.min(top2[:, 1] - top2[:, 0])))


@pytest.mark.parametrize("jdt,tdt", [(jnp.float32, torch.float32),
                                     (jnp.bfloat16, torch.bfloat16)],
                         ids=["f32", "bf16"])
def test_moe_mlp_matches_jax(jdt, tdt):
    d, f, E, cf = 16, 32, 4, 0.75
    jm = jmoe.MoEMLP(d, f, E, cf, jdt)
    x = np.random.RandomState(0).randn(2, 12, d).astype(np.float32)
    jx = jnp.asarray(x).astype(jdt)
    rng = np.random.RandomState(1)
    jp = {n: (np.asarray(p) + 0.05 * rng.randn(*p.shape)).astype(np.float32)
          for n, p in jm.init(jax.random.PRNGKey(0), jx)["params"].items()}

    def jloss(p, x):
        y, aux = jm.apply({"params": p}, x)
        return jnp.sum(y.astype(jnp.float32) ** 2) + aux, (y, aux)

    (jl, (jy, jaux)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jp, jx)

    tm = tmoe.MoEMLP(d, f, E, cf, tdt)
    with torch.no_grad():
        for n in LEAVES:
            getattr(tm, n).copy_(torch.from_numpy(jp[n]))
    tx = torch.from_numpy(x).to(tdt)

    # Routing, bitwise, on inputs whose top-2 margin clears MARGIN.
    expert, slot, keep, margin = _jax_routing(jx, jnp.asarray(jp["router"]),
                                              E, cf)
    assert margin > MARGIN
    _, t_expert, _, _, t_slot, t_keep = tm.route(tx.reshape(-1, d))
    np.testing.assert_array_equal(t_expert.numpy(), expert)
    np.testing.assert_array_equal(t_slot.numpy(), slot)
    np.testing.assert_array_equal(t_keep.numpy(), keep)
    assert 0 < keep.sum() < keep.size  # tokens drop at this capacity

    ty, taux = tm(tx)
    assert ty.dtype == tdt and taux.dtype == torch.float32
    tl = (ty.float() ** 2).sum() + taux
    tl.backward()
    tol = F32_TOL if tdt == torch.float32 else BF16_TOL
    np.testing.assert_allclose(ty.detach().float().numpy(),
                               np.asarray(jy, np.float32), **tol)
    np.testing.assert_allclose(taux.item(), float(jaux), **F32_TOL)
    np.testing.assert_allclose(tl.item(), float(jl), **tol)
    for n in LEAVES:
        g, w = getattr(tm, n).grad.numpy(), np.asarray(jg[n])
        if tdt == torch.float32:
            np.testing.assert_allclose(g, w, err_msg=n, **F32_TOL)
        else:
            assert np.abs(g - w).max() <= 5e-2 * np.abs(w).max(), n


def test_ep_axis_is_refused_naming_the_multi_rank_slice():
    """Expert parallelism is ported (`tests/test_torch_model_parallel.py`
    holds it against JAX); an ``ep_axis`` that no current mesh binds is
    refused as JAX refuses it outside ``shard_map`` — never run as the
    dense MoE."""
    x = np.random.RandomState(0).randn(1, 4, 8).astype(np.float32)
    layer = tmoe.MoEMLP(8, 16, 4, ep_axis="ep")
    layer.reset_parameters(torch.Generator().manual_seed(0))
    with pytest.raises(NameError, match="unbound axis name: ep"):
        layer(torch.from_numpy(x))
    with pytest.raises(NameError, match="unbound axis name: ep"):
        jmoe.MoEMLP(8, 16, 4, ep_axis="ep").init(jax.random.PRNGKey(0),
                                                 jnp.asarray(x))
    lm = tt.TransformerLM(vocab_size=8, d_model=8, n_heads=2, moe_experts=4,
                          ep_axis="ep")
    with pytest.raises(NameError, match="unbound axis name: ep"):
        lm(torch.zeros((1, 4), dtype=torch.int64))


def _lm_pair(cfg, seed=2):
    jm = jt.TransformerLM(**cfg, dtype=jnp.float32)
    rng = np.random.RandomState(seed)
    # `jt.build_lm`'s init, jitted (eager flax init is slow).
    variables = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                                 jnp.zeros((1, 8), jnp.int32))
    jp = {n: (np.asarray(p) + 0.05 * rng.randn(*p.shape)).astype(np.float32)
          for n, p in named_params(variables["params"]).items()}
    tm = tt.TransformerLM(**cfg, dtype=torch.float32)
    tp, _ = params_from_jax(jp)
    return jm, jp, tm, tp


def test_moe_lm_loss_and_gradients_match_jax():
    cfg = dict(vocab_size=29, d_model=16, n_heads=2, n_layers=2, d_ff=32,
               max_len=32, moe_experts=4, moe_capacity=1.0)
    jm, jp, tm, tp = _lm_pair(cfg)
    toks = np.random.RandomState(5).randint(0, 29, size=(2, 13))
    batch = jt.lm_batch(toks)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        jt.make_lm_loss(jm, aux_weight=0.1)))(jp, batch)
    _, jextras = jax.jit(lambda p, b: jm.apply(
        {"params": unflatten_params(p)}, b["tokens"], b["positions"],
        mutable=["losses"]))(jp, batch)
    jaux = sum(jax.tree.leaves(jextras["losses"]))
    leaves = {n: p.clone().requires_grad_() for n, p in tp.items()}
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    _, taux = torch.func.functional_call(
        tm, leaves, (tb["tokens"], tb["positions"]), {"return_aux": True})
    np.testing.assert_allclose(taux.item(), float(jaux), **F32_TOL)
    loss = tt.make_lm_loss(tm, aux_weight=0.1)(leaves, tb)
    np.testing.assert_allclose(loss.item(), float(jloss), **F32_TOL)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    want, _ = params_from_jax({n: np.asarray(g) for n, g in jgrads.items()})
    assert set(want) == set(leaves)
    for n, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), err_msg=n,
                                   **F32_TOL)
    # aux_weight = 0 is the plain cross-entropy of the same logits.
    plain = tt.make_lm_loss(tm, aux_weight=0.0)(leaves, tb)
    np.testing.assert_allclose(loss.item() - plain.item(),
                               0.1 * taux.item(), rtol=1e-4)


def test_params_from_jax_carries_the_moe_leaves():
    cfg = dict(vocab_size=11, d_model=8, n_heads=2, n_layers=2, d_ff=16,
               max_len=16, moe_experts=3)
    jm, jp, tm, tp = _lm_pair(cfg)
    assert set(tp) == {n for n, _ in tm.named_parameters()}
    for i in range(2):
        for leaf in LEAVES:
            jn, tn = f"block_{i}/moe/{leaf}", f"block_{i}.moe.{leaf}"
            np.testing.assert_array_equal(tp[tn].numpy(), jp[jn])
            # Expert-major in both packages: no permutation on the wire.
            assert jax_order(tn, tuple(tp[tn].shape)) is None
        assert f"block_{i}.fc1.weight" not in tp
    assert tuple(tp["block_0.moe.w1"].shape) == (3, 8, 16)
    assert tuple(tp["block_0.moe.router"].shape) == (8, 3)


# ---------------------------------------------------------------------------
# The CLI's --moe-experts on the three roles
# ---------------------------------------------------------------------------

LM = ["--model", "transformer", "--moe-experts", "4", "--seq-len", "16",
      "--vocab", "31", "--batch-size", "2", "--n-examples", "8",
      "--codec", "blockq"]
CPU = ["--force-cpu-devices", "1"]


def test_cli_moe_sync_and_async_ps(capsys):
    opt = ttrain.main(LM + CPU + ["--steps", "2"])
    assert any(".moe.w1" in n for n in opt.params)
    err = capsys.readouterr().err
    assert re.search(r"^done: 2 steps, [\d,]+ tokens/sec", err, re.M), err
    ttrain.main(LM + ["--async-ps", "--force-cpu-devices", "3",
                      "--quota", "2", "--steps", "2"])
    err = capsys.readouterr().err
    assert re.search(r"^done: 2 updates, \d+ grads", err, re.M), err


def test_cli_moe_serve_and_bucket_streaming_connect():
    from test_torch_multihost_cli import DONE, _check_worker_lines, _run

    sres, wres, port = _run(
        LM + ["--quota", "2", "--steps", "3"],
        LM + ["--async-bucket-bytes", "16384", "--fused-encode"], 2)
    rc, _out, err = sres
    assert rc == 0, err
    assert DONE.search(err).group(1) == "3"
    assert re.search(r"buckets_filled=\d+", err), err
    _check_worker_lines(wres, port)
    for _rc, _out, werr in wres:
        assert "bucket streaming on (fused encode)" in werr
        assert re.search(r"fused_encodes=\d+", werr), werr
