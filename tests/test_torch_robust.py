"""The port's robust reducers and admission policy (`ops/robust.py`,
`utils/timing.py::RankLatency`, `utils/faults.py`'s Byzantine maps,
`ps.tree_all_finite`, `transport.Deadline`) against the JAX package's.

Tolerances:

* `robust_reduce`: the median bitwise (a sort and the middle pair's
  mean: the same float32 operations); ``rtol 1e-6, atol 1e-6`` for the
  mean and the trimmed mean (bitwise up to 4 contributions; XLA
  associates a sum of 5 otherwise, an ulp of values up to ~150);
  ``rtol 1e-6`` on the contribution norms (each a sum of squares in
  another order than XLA's); ``rtol 1e-5, atol 1e-6`` for norm_clip,
  whose clip factor divides by those norms before the sum;
* `RankScoreboard`, `RankLatency`, the Byzantine maps and the finite
  check: exact (host numpy in both packages; elementwise float32 maps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu import ps as jps
from pytorch_ps_mpi_tpu import transport as jtransport
from pytorch_ps_mpi_tpu.ops import robust as jr
from pytorch_ps_mpi_tpu.utils import faults as jfaults
from pytorch_ps_mpi_tpu.utils import timing as jtiming
from pytorch_ps_mpi_tpu_torch import ps as tps
from pytorch_ps_mpi_tpu_torch import transport as ttransport
from pytorch_ps_mpi_tpu_torch.ops import robust as tr
from pytorch_ps_mpi_tpu_torch.utils import faults as tfaults
from pytorch_ps_mpi_tpu_torch.utils import timing as ttiming

SHAPES = {"w": (7, 5), "b": (5,), "k": (2, 3, 4)}
NORM_TOL = dict(rtol=1e-6, atol=0)
SUM_TOL = {"mean": dict(rtol=1e-6, atol=1e-6),
           "trimmed_mean": dict(rtol=1e-6, atol=1e-6),
           "norm_clip": dict(rtol=1e-5, atol=1e-6)}

# (aggregate, trim_k, clip_norm): trim_k only acts on trimmed_mean (2
# clamps to (n-1)//2 on small fills), clip_norm only on norm_clip (NaN:
# this fill's median).
REDUCERS = {
    "mean": ("mean", None, float("nan")),
    "trimmed_mean": ("trimmed_mean", None, float("nan")),
    "trimmed_mean_k1": ("trimmed_mean", 1, float("nan")),
    "trimmed_mean_k2": ("trimmed_mean", 2, float("nan")),
    "median": ("median", None, float("nan")),
    "norm_clip_batch": ("norm_clip", None, float("nan")),
    "norm_clip_rolling": ("norm_clip", None, 3.0),
}


def _weights(kind, n):
    if kind == "ones":
        return np.ones(n, np.float32)
    if kind == "staleness":
        s = np.arange(n, dtype=np.float32) % 3
        return (1.0 / (1.0 + s)).astype(np.float32)
    # mixed: staleness damping x a suspect's 0.25 x a multiplicity of 4
    w = (1.0 / (1.0 + np.arange(n, dtype=np.float32))).astype(np.float32)
    w[0] *= np.float32(0.25)
    w[-1] *= np.float32(4.0)
    return w


def _stack(n, seed):
    rng = np.random.RandomState(seed)
    out = {k: rng.randn(n, *s).astype(np.float32) for k, s in SHAPES.items()}
    out["w"][0] *= 50.0  # one outlier contribution
    return out


@pytest.mark.parametrize("n", [3, 4, 5])
@pytest.mark.parametrize("wkind", ["ones", "staleness", "mixed"])
@pytest.mark.parametrize("case", list(REDUCERS))
def test_robust_reduce_matches_jax(case, wkind, n):
    aggregate, trim_k, clip = REDUCERS[case]
    stacked = _stack(n, seed=n)
    w = _weights(wkind, n)
    n_target = n + 1  # a quorum short fill renormalized to its target
    jout, jinfo = jr.robust_reduce(
        aggregate, {k: jnp.asarray(v) for k, v in stacked.items()},
        jnp.asarray(w), n_target=jnp.float32(n_target), trim_k=trim_k,
        clip_norm=jnp.float32(clip))
    tout, tinfo = tr.robust_reduce(
        aggregate, {k: torch.from_numpy(v) for k, v in stacked.items()},
        torch.from_numpy(w), n_target=float(n_target), trim_k=trim_k,
        clip_norm=clip)
    np.testing.assert_allclose(tinfo["contrib_norms"].numpy(),
                               np.asarray(jinfo["contrib_norms"]),
                               **NORM_TOL)
    assert int(tinfo["clipped"]) == int(jinfo["clipped"])
    for k in SHAPES:
        got, want = tout[k].numpy(), np.asarray(jout[k])
        assert got.dtype == want.dtype == np.float32
        if aggregate == "median":
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, err_msg=k,
                                       **SUM_TOL[aggregate])


@pytest.mark.parametrize("n", [2, 3, 4, 5, 6])
def test_median_averages_the_middle_pair_like_jnp(n):
    """``torch.median`` takes the lower middle value of an even count;
    the port's median is ``jnp.median``'s (the mean of the middle pair),
    NaN-propagating."""
    x = np.random.RandomState(n).randn(n, 9).astype(np.float32)
    x[:, 3] = np.nan if n % 2 else x[:, 3]
    got = tr._median0(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.median(x, axis=0)))
    if n % 2 == 0:
        assert not np.array_equal(got, torch.median(
            torch.from_numpy(x), dim=0).values.numpy())


def test_trim_k_eff_matches_jax():
    for k in (None, 0, 1, 2, 5):
        for n in range(1, 9):
            assert tr._trim_k_eff(k, n) == jr._trim_k_eff(k, n)
    assert tr.ROBUST_REDUCERS == jr.ROBUST_REDUCERS


def _observations():
    """A fleet of 4 ranks: three honest (norms ~1, slowly decaying) and
    rank 3 a 100x attacker from its 10th submission, then honest again."""
    rng = np.random.RandomState(11)
    obs = []
    for i in range(60):
        for r in range(4):
            norm = float(np.exp(rng.randn() * 0.1) * (0.99 ** i))
            if r == 3 and 10 <= i < 30:
                norm *= 100.0
            obs.append((r, norm))
    return obs


@pytest.mark.parametrize("z", [2.0, 4.0])
def test_rank_scoreboard_matches_jax(z):
    jb, tb = jr.RankScoreboard(z), tr.RankScoreboard(z)
    for r, norm in _observations():
        assert tb.observe(r, norm) == jb.observe(r, norm)
        assert tb.state(r) == jb.state(r)
        assert tb.weight(r) == jb.weight(r)
        assert tb.quarantined_ranks() == jb.quarantined_ranks()
    assert tb.snapshot() == jb.snapshot()
    assert tb.quarantine_events == jb.quarantine_events >= 1
    assert tb.recoveries == jb.recoveries
    with pytest.raises(ValueError, match="z_threshold"):
        tr.RankScoreboard(0.0)


def test_rank_latency_matches_jax():
    """One sequence of submissions with fixed timestamps: rank 2 a
    persistent straggler from t=5 s, rank 1 with one outage spike."""
    jl, tl = jtiming.RankLatency(), ttiming.RankLatency()
    t = {0: 0.0, 1: 0.0, 2: 0.0, 3: 0.0}
    rng = np.random.RandomState(2)
    for step in range(40):
        for r in range(4):
            dt = 0.1 + 0.01 * rng.rand()
            if r == 2 and t[r] > 5.0:
                dt *= 4.0
            if r == 1 and step == 20:
                dt += 3.0
            t[r] += dt
            jl.observe(r, now=t[r])
            tl.observe(r, now=t[r])
        assert tl.fleet_p95() == jl.fleet_p95()
        for r in range(4):
            assert tl.speed_weight(r) == jl.speed_weight(r)
    assert tl.snapshot() == jl.snapshot()
    tl.observe(None)
    tl.forget(2)
    jl.forget(2)
    assert tl.snapshot() == jl.snapshot()
    assert tl.speed_weight(2) == jl.speed_weight(2) == 1.0
    req_t, req_j = ttiming.RequestLatency(8), jtiming.RequestLatency(8)
    assert req_t.snapshot() == req_j.snapshot() == {}
    for x in rng.rand(20):
        req_t.observe(x)
        req_j.observe(x)
    assert req_t.snapshot() == req_j.snapshot()
    assert req_t.recent_median() == req_j.recent_median()


@pytest.mark.parametrize("mode", ["sign_flip", "scale", "constant"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_byzantine_maps_match_jax(mode, dtype):
    plan = dict(byzantine_rank=1, byzantine_mode=mode, byzantine_scale=3.3)
    jp, tp = jfaults.FaultPlan(**plan), tfaults.FaultPlan(**plan)
    assert tp.byzantine_transform(0) is None
    g = np.random.RandomState(0).randn(5, 6).astype(np.float32)
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    jg = jnp.asarray(g).astype(getattr(jnp, dtype))
    got = tp.byzantine_transform(1)({"g": tg})["g"]
    want = jp.byzantine_transform(1)({"g": jg})["g"]
    assert str(got.dtype).endswith(dtype)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    with pytest.raises(ValueError, match="byzantine_mode"):
        tfaults.FaultPlan(byzantine_rank=0,
                          byzantine_mode="bogus").byzantine_transform(0)


@pytest.mark.parametrize("poison", [None, "nan", "inf", "bf16_nan"])
def test_tree_all_finite_matches_jax(poison):
    rng = np.random.RandomState(0)
    tree = {"q": rng.randint(-5, 5, (4, 8)).astype(np.int8),
            "scales": rng.rand(4).astype(np.float32),
            "b": rng.rand(6).astype(np.float32)}
    if poison == "nan":
        tree["scales"][2] = np.nan
    elif poison == "inf":
        tree["b"][0] = np.inf
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    if poison == "bf16_nan":
        jtree["w"] = jnp.asarray([1.0, np.nan], jnp.bfloat16)
        ttree["w"] = torch.tensor([1.0, float("nan")], dtype=torch.bfloat16)
    assert tps.tree_all_finite(ttree, {}) == jps.tree_all_finite(jtree, {}) \
        == (poison is None)


def test_deadline_matches_jax():
    for cls in (ttransport.Deadline, jtransport.Deadline):
        d = cls(None)
        assert not d.expired() and d.remaining() == float("inf")
        assert d.timeout(cap=0.5) == 0.5 and d.timeout() is None
        d = cls(0.0)
        assert d.expired() and d.timeout(floor=0.001) == 0.001
        assert cls(10.0).timeout(cap=0.5) == 0.5
        with pytest.raises(ValueError, match="budget must be >= 0"):
            cls(-1.0)
