"""Sequence parallelism: the port's ring and Ulysses attention against the
JAX package's, forward and gradients.

One gloo world of 4 spawned ranks runs every case
(`torch_mesh_helpers.attention_cases`) on its sequence shard over the sp
axis of a ``(1, sp)`` mesh; the JAX side runs the same function under
``shard_map`` over the first ``sp`` virtual CPU devices and
differentiates ``sum(out * do)`` with respect to the global q, k and v,
whose sequence slices each rank's gradients are compared with.

Cases: the ring at sp 2 and 4, causal and not, with both ``loop``
values; 3 heads (which no head split would take) with a scale override;
Ulysses at sp 2 with the dense inner attention and with the flash
attention's plain path (the JAX side runs its Pallas kernels in interpret
mode); the bound forms (`make_ring_attention`, `make_ulysses_attention`);
Ulysses' refusal of ``H % sp`` in JAX's words; and its two all-to-alls
inverting each other bitwise.

Tolerance: ``rtol=1e-5, atol=1e-6`` on the f32 outputs and gradients (the
streaming softmax and the einsums sum in other orders than XLA's).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from pytorch_ps_mpi_tpu.ops.flash_attention import flash_attention as jflash
from pytorch_ps_mpi_tpu.parallel import mesh as JM
from pytorch_ps_mpi_tpu.parallel.ring_attention import ring_attention as jring
from pytorch_ps_mpi_tpu.parallel.ulysses import ulysses_attention as julysses

from torch_dist_helpers import run_world

TOL = dict(rtol=1e-5, atol=1e-6)
B, S, H, D = 2, 16, 4, 8


def _qkv(seed, h=H):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, S, h, D).astype(np.float32) for _ in range(4))


# name -> (kind, sp, seed, heads, kwargs)
CASES = {
    "ring_sp2_causal_unrolled": ("ring", 2, 0, H,
                                 dict(causal=True, loop="unrolled")),
    "ring_sp2_scan": ("ring", 2, 1, H, dict(causal=False, loop="scan")),
    "ring_sp4_causal_auto": ("ring", 4, 2, H, dict(causal=True)),
    "ring_sp4_scan_causal": ("ring", 4, 3, H, dict(causal=True,
                                                   loop="scan")),
    "ring_sp4_unrolled": ("ring", 4, 4, H, dict(loop="unrolled")),
    "ring_sp2_3heads_scale": ("ring", 2, 5, 3, dict(causal=True,
                                                    scale=0.3)),
    "ring_bound_sp2": ("ring_bound", 2, 6, H, dict(causal=True)),
    "ulysses_sp2_dense": ("ulysses", 2, 7, H, dict(causal=True)),
    "ulysses_sp2_flash": ("ulysses", 2, 8, H, dict(causal=True,
                                                   flash=True)),
    "ulysses_sp2_scale": ("ulysses", 2, 9, H, dict(scale=0.2)),
    "ulysses_bound_sp2": ("ulysses_bound", 2, 10, H, dict(causal=True)),
}


def _jax_fn(kind, kw):
    kw = dict(kw)
    if kind.startswith("ring"):
        return functools.partial(jring, axis="sp", **kw)
    inner = jflash if kw.pop("flash", False) else None
    return functools.partial(julysses, axis="sp", inner=inner, **kw)


def _jax_case(kind, n, q, k, v, do, kw):
    mesh = JM.make_dp_sp_mesh(1, n, devices=jax.devices()[:n])
    spec = P(None, "sp")
    fn = jax.shard_map(_jax_fn(kind, kw), mesh=mesh,
                       in_specs=(spec, spec, spec), out_specs=spec,
                       check_vma=False)

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v) * do)

    out = jax.jit(fn)(q, k, v)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(x) for x in (out,) + tuple(grads)]


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    cases, inputs = {}, {}
    for name, (kind, n, seed, h, kw) in CASES.items():
        q, k, v, do = _qkv(seed, h)
        inputs[name] = (kind, n, q, k, v, do, kw)
        cases[name] = (kind, n, q, k, v, do, kw)
    q, k, v, _ = _qkv(11, 3)
    cases["refuse_3heads"] = ("refuse", 2, q, k, v, None, {})
    ranks = run_world("torch_mesh_helpers:attention_cases", 4,
                      tmp_path_factory.mktemp("attn"), cases, timeout=180)
    return inputs, ranks


@pytest.mark.parametrize("name", list(CASES))
def test_sequence_parallel_attention_matches_jax(world4, name):
    inputs, ranks = world4
    kind, n, q, k, v, do, kw = inputs[name]
    want = _jax_case(kind.replace("_bound", ""), n, q, k, v, do, kw)
    s = S // n
    for r, out in enumerate(ranks):
        got = out[name]
        if r >= n:
            assert got is None  # not in the (1, n) mesh
            continue
        assert got["dtype"] == "torch.float32"
        for key, w in zip(("o", "dq", "dk", "dv"), want):
            np.testing.assert_allclose(got[key], w[:, r * s:(r + 1) * s],
                                       err_msg=f"{name} rank {r} {key}",
                                       **TOL)


def test_ulysses_refuses_heads_that_do_not_split_like_jax(world4):
    _, ranks = world4
    q, k, v, _ = _qkv(11, 3)
    mesh = JM.make_dp_sp_mesh(1, 2, devices=jax.devices()[:2])
    spec = P(None, "sp")
    with pytest.raises(ValueError) as e:
        jax.shard_map(functools.partial(julysses, axis="sp"), mesh=mesh,
                      in_specs=(spec,) * 3, out_specs=spec,
                      check_vma=False)(q, k, v)
    for r in range(2):
        assert ranks[r]["refuse_3heads"] == str(e.value)
    assert "do not split across 2-way" in str(e.value)


def test_ulysses_all_to_alls_round_trip_bitwise(world4):
    _, ranks = world4
    assert [r.get("round_trip") for r in ranks] == [True, True, None, None]
