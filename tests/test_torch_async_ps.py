"""The port's async PS (`pytorch_ps_mpi_tpu_torch.async_ps`) against the
JAX package's (`pytorch_ps_mpi_tpu.async_ps`), on the CPU.

A threaded run's fills depend on timing, so the JAX `AsyncPS` is an
oracle only where the result does not:

* **the PS apply without threads**: the same numpy gradients of Q
  contributors, encoded by each package's codec (blockq bitwise, in
  flax's element order), stacked and applied by `_apply_weighted` —
  weight-free, staleness-weighted, quorum-renormalized (with and without
  staleness weights), and through every robust reducer.  Tolerance ``rtol
  1e-6, atol 2e-6``: the weighted decode sums are bitwise
  (`test_torch_codecs.py`), but XLA contracts the rules' multiply-adds
  into FMAs under ``jit``, a rounding or two from torch's separate ops on
  values up to ~16 (a few ulps); the robust path's contribution norms
  also sum in another order than XLA's;
* **a lockstep single worker** (``_lockstep=True``, one device: sequential
  SGD), against the JAX one: the CLI's MLP with ``rtol 1e-5, atol 1e-6``
  (XLA and PyTorch sum each matmul in other orders) for 6 updates with
  the identity codec and 2 with bf16 and blockq, whose codes cascade
  (`test_lockstep_mlp_matches_jax`); a 2-layer LM with
  flash attention (the port's plain versions against the Pallas kernels
  in interpret mode) for 3 updates with ``rtol 1e-4, atol 1e-5``, the
  LM's f32 tolerance (`test_torch_transformer.py`);
* **the batch functions**, bitwise: the same ``SeedSequence`` draws.

The fill machinery itself runs threaded on ``[cpu] * 4`` (a PS and 3
workers): quota fills, quorum short fills and late folds, staleness
drops, the bounded queue, the non-finite gate, worker failure, the
fleet's death and the PS's planned crash — each with deadlines under
0.2 s and every thread joined before `run` returns or raises.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu import async_ps as ja
from pytorch_ps_mpi_tpu.models import mlp as jmlp
from pytorch_ps_mpi_tpu.models import transformer as jt
from pytorch_ps_mpi_tpu.ops import codecs as jcodecs
from pytorch_ps_mpi_tpu_torch import async_ps as ta
from pytorch_ps_mpi_tpu_torch.errors import (FleetDeadError, NotCompiledError,
                                             WorkerFailedError)
from pytorch_ps_mpi_tpu_torch.models import mlp as tmlp
from pytorch_ps_mpi_tpu_torch.models import transformer as tt
from pytorch_ps_mpi_tpu_torch.ops import codecs as tcodecs
from pytorch_ps_mpi_tpu_torch.utils.faults import FaultPlan, SimulatedCrash
from pytorch_ps_mpi_tpu_torch.utils.interop import (params_from_jax,
                                                    to_jax_order)

from test_torch_transformer import _pair, _tokens

CPU = torch.device("cpu")
MLP_TOL = dict(rtol=1e-5, atol=1e-6)
LM_TOL = dict(rtol=1e-4, atol=1e-5)
APPLY_TOL = dict(rtol=1e-6, atol=2e-6)


def _np(t):
    return (t.detach().to(torch.float32).numpy()
            if isinstance(t, torch.Tensor) else np.asarray(t))


# ---------------------------------------------------------------------------
# The PS apply, without threads
# ---------------------------------------------------------------------------

# flax names and layouts; the port's come through `params_from_jax`.  The
# Dense kernel spans three 1,024-element blockq tiles, so the element
# order decides which elements share a scale.
JSHAPES = {"Dense_0/kernel": (64, 48), "Dense_0/bias": (48,),
           "Conv_0/kernel": (3, 3, 4, 8), "LayerNorm_0/scale": (48,)}


def _codecs(name):
    if name == "blockq":
        return (jcodecs.BlockQuantizeCodec(block_rows=8),
                tcodecs.BlockQuantizeCodec(block_rows=8))
    return jcodecs.get_codec(name), tcodecs.get_codec(name)


def _pair_ps(optim, codec, **kw):
    rng = np.random.RandomState(0)
    jparams = {n: (0.1 * rng.randn(*s)).astype(np.float32)
               for n, s in JSHAPES.items()}
    tparams, _ = params_from_jax(jparams)
    jcode, tcode = _codecs(codec)
    hyper = (dict(lr=0.05, momentum=0.9) if optim == "sgd"
             else dict(lr=1e-2))
    jopt = ja.AsyncPS(list(jparams.items()), optim=optim, code=jcode,
                      devices=[jax.devices()[0]], **kw, **hyper)
    topt = ta.AsyncPS(list(tparams.items()), optim=optim, code=tcode,
                      devices=[CPU], **kw, **hyper)
    jopt.compile_step(lambda p, b: jnp.float32(0.0))
    topt.compile_step(lambda p, b: torch.zeros(()))
    return jopt, topt


def _fill(jopt, topt, n, seed):
    """Encode ``n`` contributors' numpy gradients (flax layout) with each
    package's codec and stack them."""
    rng = np.random.RandomState(seed)
    jcodes, tcodes = [], []
    for _ in range(n):
        g = {name: rng.randn(*s).astype(np.float32)
             for name, s in JSHAPES.items()}
        jcodes.append({k: jopt.code.encode(jnp.asarray(v))
                       for k, v in g.items()})
        tg, _ = params_from_jax(g)
        tcodes.append({k: topt.code.encode(to_jax_order(
            v, topt._orders.get(k))) for k, v in tg.items()})
    jstacked = {k: jax.tree.map(lambda *xs: jnp.stack(xs),
                                *[c[k] for c in jcodes]) for k in JSHAPES}
    tstacked = {k: ta._stack_codes([c[k] for c in tcodes])
                for k in tcodes[0]}
    return jstacked, tstacked


def _in_port_layout(jname, a):
    """A flax-layout array of leaf ``jname`` -> (port name, port layout)."""
    (name, t), = params_from_jax({jname: np.asarray(a)})[0].items()
    return name, t.numpy()


def _assert_state_close(jopt, topt, **tol):
    for jn, p in jopt.params.items():
        n, want = _in_port_layout(jn, p)
        np.testing.assert_allclose(_np(topt.params[n]), want, err_msg=n,
                                   **tol)
        for key, v in jopt.state[jn].items():
            got = _np(topt.state[n][key])
            if np.ndim(v) == 0:  # the step counter
                assert int(got) == int(v), (n, key)
                continue
            np.testing.assert_allclose(got, _in_port_layout(jn, v)[1],
                                       err_msg=f"{n}/{key}", **tol)


def _apply_twice(jopt, topt, n, stal, ranks, n_target=None):
    for seed in (1, 2):
        js, ts = _fill(jopt, topt, n, seed)
        jopt.params, jopt.state = jopt._apply_weighted(
            js, stal, ranks, {}, n_target=n_target)
        topt.params, topt.state = topt._apply_weighted(
            ts, stal, ranks, {}, n_target=n_target)


LINEAR = {
    "full": (dict(quota=3), 3, [1, 0, 2], None),
    "staleness": (dict(quota=3, staleness_weighting=True), 3, [0, 2, 1],
                  None),
    "quorum": (dict(quota=3, quorum=2, fill_deadline=0.05), 2, [0, 1], 3),
    "staleness_quorum": (dict(quota=3, quorum=2, fill_deadline=0.05,
                              staleness_weighting=True), 2, [1, 3], 3),
}


@pytest.mark.parametrize("optim", ["sgd", "adam"])
@pytest.mark.parametrize("codec", ["identity", "bf16", "blockq"])
@pytest.mark.parametrize("case", list(LINEAR))
def test_linear_apply_matches_jax(case, codec, optim):
    kw, n, stal, n_target = LINEAR[case]
    jopt, topt = _pair_ps(optim, codec, **kw)
    assert not topt._itemwise
    _apply_twice(jopt, topt, n, stal, list(range(n)), n_target)
    _assert_state_close(jopt, topt, **APPLY_TOL)


ROBUST = {
    "trimmed_mean": (dict(aggregate="trimmed_mean", trim_k=1, quota=3), 3),
    "trimmed_mean_k2": (dict(aggregate="trimmed_mean", trim_k=2, quota=5),
                        5),
    "median_even": (dict(aggregate="median", quota=4), 4),
    "median_odd": (dict(aggregate="median", quota=3), 3),
    "norm_clip": (dict(aggregate="norm_clip", quota=3), 3),
    "mean_scored": (dict(anomaly_z=4.0, quota=3), 3),
}


@pytest.mark.parametrize("optim", ["sgd", "adam"])
@pytest.mark.parametrize("codec", ["identity", "blockq"])
@pytest.mark.parametrize("case", list(ROBUST))
def test_robust_apply_matches_jax(case, codec, optim):
    kw, n = ROBUST[case]
    jopt, topt = _pair_ps(optim, codec, staleness_weighting=True, **kw)
    assert topt._itemwise
    _apply_twice(jopt, topt, n, list(range(n)), list(range(n)))
    _assert_state_close(jopt, topt, **APPLY_TOL)
    assert topt.fault_stats["robust_clipped"] == \
        jopt.fault_stats["robust_clipped"]
    np.testing.assert_allclose(list(topt._norm_window),
                               list(jopt._norm_window), rtol=1e-6)


def test_norm_probe_matches_jax():
    jopt, topt = _pair_ps("sgd", "blockq", quota=3)
    js, ts = _fill(jopt, topt, 1, 3)
    jcodes = {k: jax.tree.map(lambda x: x[0], v) for k, v in js.items()}
    tcodes = {k: {kk: vv[0] for kk, vv in v.items()} for k, v in ts.items()}
    np.testing.assert_allclose(float(topt._norm_fn(tcodes)),
                               float(jopt._norm_fn(jcodes)), rtol=1e-6)


# ---------------------------------------------------------------------------
# Lockstep single worker: sequential SGD, against the JAX PS
# ---------------------------------------------------------------------------

def _mlp_problem():
    """The CLI's MLP (784-128-10, 101,770 elements)."""
    rng = np.random.RandomState(0)
    params = jmlp.init_mlp(rng, sizes=(784, 128, 10))
    x = rng.rand(256, 784).astype(np.float32)
    y = rng.randint(0, 10, 256).astype(np.int32)
    return params, x, y


def _lockstep(opt, loss, batch_fn, steps):
    opt._lockstep = True
    opt.compile_step(loss)
    return opt.run(batch_fn, steps=steps)


@pytest.mark.parametrize("codec,steps", [("identity", 6), ("bf16", 2),
                                         ("blockq", 2)])
def test_lockstep_mlp_matches_jax(codec, steps):
    """Sequential SGD through the async pipeline.  A lossy wire cascades:
    a gradient element within float32 noise of a bf16 rounding (or blockq
    quantum) boundary lands one step apart, which moves its weight by
    ``lr`` times that step and the next gradients past float32 noise —
    bf16: 2 of 101,770 elements outside ``MLP_TOL`` after one update, 8
    after 2, 21 after 3, 79 after 6 (blockq: 0 after 2, 2 after 6).  So
    the lossy codecs run 2 updates, and at most one element in 10,000
    may fall outside ``MLP_TOL`` (all within ``rtol 1e-2, atol 1e-3``),
    the allowance of `test_torch_train_cli.py`."""
    params, x, y = _mlp_problem()
    kw = dict(lr=0.1, momentum=0.9, quota=1, code=codec)
    jopt = ja.AsyncSGD(list(params.items()), devices=[jax.devices()[0]],
                       **kw)
    jh = _lockstep(jopt, jmlp.mlp_loss_fn,
                   ja.dataset_batch_fn(x, y, 64, seed=3), steps)
    topt = ta.AsyncSGD(list(params.items()), devices=[CPU], **kw)
    th = _lockstep(topt, tmlp.mlp_loss_fn,
                   ta.dataset_batch_fn(x, y, 64, seed=3), steps)
    assert th["staleness"] == [0.0] * steps
    assert th["versions"] == list(range(1, steps + 1))
    np.testing.assert_allclose(th["losses"], jh["losses"], **MLP_TOL)
    outside = sum(int((~np.isclose(_np(p), np.asarray(jopt.params[n]),
                                   **MLP_TOL)).sum())
                  for n, p in topt.params.items())
    allowed = 0 if codec == "identity" else 1e-4 * 101_770
    assert outside <= allowed, outside
    for n, p in topt.params.items():
        np.testing.assert_allclose(_np(p), np.asarray(jopt.params[n]),
                                   err_msg=n, rtol=1e-2, atol=1e-3)


def test_lockstep_flash_lm_matches_jax():
    """A 2-layer LM with flash attention: 3 lockstep updates, the losses
    and params against the JAX PS (the LM's f32 tolerance)."""
    cfg = dict(vocab_size=17, d_model=16, n_heads=2, n_layers=2, d_ff=32,
               max_len=64)
    jm, jp, tm, tp = _pair(cfg, seed=7)
    toks = _tokens(17, 16, 16, seed=5)
    kw = dict(lr=0.05, momentum=0.9, quota=1)
    jopt = ja.AsyncSGD(list(jp.items()), devices=[jax.devices()[0]], **kw)
    jh = _lockstep(jopt, jt.make_lm_loss(jm),
                   ja.lm_batch_fn(toks, 4, seed=1), 3)
    topt = ta.AsyncSGD(list(tp.items()), devices=[CPU], **kw)
    th = _lockstep(topt, tt.make_lm_loss(tm),
                   ta.lm_batch_fn(toks, 4, seed=1), 3)
    np.testing.assert_allclose(th["losses"], jh["losses"], **LM_TOL)
    want, _ = params_from_jax({n: np.asarray(p)
                               for n, p in jopt.params.items()})
    for n, p in topt.params.items():
        np.testing.assert_allclose(_np(p), want[n].numpy(), err_msg=n,
                                   **LM_TOL)


@pytest.mark.parametrize("seed,rank,it", [(0, 0, 0), (3, 2, 7),
                                          (2**40, 1, 123)])
def test_batch_fns_draw_jax_indices(seed, rank, it):
    x = np.arange(50 * 3, dtype=np.float32).reshape(50, 3)
    y = np.arange(50, dtype=np.int32)
    jb = ja.dataset_batch_fn(x, y, 8, seed=seed)(rank, it)
    tb = ta.dataset_batch_fn(x, y, 8, seed=seed)(rank, it)
    for k in ("x", "y"):
        np.testing.assert_array_equal(tb[k], jb[k])
    toks = _tokens(31, 40, 9, seed=2)
    jb = ja.lm_batch_fn(toks, 6, seed=seed)(rank, it)
    tb = ta.lm_batch_fn(toks, 6, seed=seed)(rank, it)
    assert set(tb) == set(jb) == {"tokens", "targets", "positions"}
    for k in jb:
        np.testing.assert_array_equal(tb[k], np.asarray(jb[k]))


# ---------------------------------------------------------------------------
# The fill machinery, threaded on the CPU
# ---------------------------------------------------------------------------

def _problem(seed=0, d_in=6, d_out=3, n=256):
    rng = np.random.RandomState(seed)
    w_true = rng.randn(d_in, d_out).astype(np.float32)
    x = rng.randn(n, d_in).astype(np.float32)
    y = (x @ w_true + 0.01 * rng.randn(n, d_out)).astype(np.float32)
    params = [("w", (0.1 * rng.randn(d_in, d_out)).astype(np.float32)),
              ("b", np.zeros(d_out, np.float32))]
    return params, x, y


def _loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return torch.mean((pred - batch["y"]) ** 2)


def _async(quota=3, workers=3, **kw):
    params, x, y = _problem()
    opt = ta.AsyncSGD(params, lr=0.02, quota=quota,
                      devices=[CPU] * (workers + 1), **kw)
    opt.compile_step(_loss)
    return opt, ta.dataset_batch_fn(x, y, 32)


def _no_worker_threads():
    return not any(t.name.startswith("async-ps-worker")
                   for t in threading.enumerate())


def test_quota_fills_converge_and_join():
    opt, bf = _async()
    hist = opt.run(bf, steps=25)
    assert hist["grads_consumed"] == 75
    assert all(len(c) == 3 for c in hist["contributors"])
    assert hist["versions"] == list(range(1, 26))
    assert all(s >= 0 for s in hist["staleness"])
    assert np.mean(hist["losses"][-5:]) < 0.5 * np.mean(hist["losses"][:3])
    assert len(opt.timings) == 25 and opt.timings[0]["msg_bytes"] > 0
    assert set(opt.fault_stats) == set(ja.AsyncPS(
        [("a", np.zeros(2, np.float32))], devices=[jax.devices()[0]]
    ).fault_stats)
    assert _no_worker_threads()


def test_quorum_short_fills_fold_the_straggler():
    """Rank 0 sleeps 0.15 s before each gradient.  norm_clip's fills are
    rank-distinct, so the healthy rank holds one of quota 2's slots and
    the other must come from the straggler: quorum 1 with a 0.01 s
    deadline closes fills short, and the straggler's late frames fold
    into later fills (the JAX package's test of the same)."""
    params, x, y = _problem()
    opt = ta.AsyncSGD(params, lr=0.05, quota=2, quorum=1,
                      fill_deadline=0.01, aggregate="norm_clip",
                      devices=[CPU] * 3,
                      fault_plan=FaultPlan(slow_rank=0, slow_delay_s=0.15))
    opt.compile_step(_loss)
    hist = opt.run(ta.dataset_batch_fn(x, y, 32), steps=10)
    fs = hist["fault_stats"]
    assert len(hist["losses"]) == 10
    assert fs["quorum_fills"] >= 1
    assert any(len(c) == 1 for c in hist["contributors"])
    if any(0 in c for c in hist["contributors"]):
        assert fs["late_folded"] >= 1
    assert 1 in fs["rank_latency"]
    assert _no_worker_threads()


def test_max_staleness_drops():
    opt, bf = _async(quota=1, max_staleness=0)
    hist = opt.run(bf, steps=12)
    assert hist["fault_stats"]["stale_dropped"] >= 1
    assert all(s == 0 for s in hist["staleness"])
    assert _no_worker_threads()


def test_bounded_queue_under_credit_window():
    """A slow consumer (10 ms a frame) against 3 workers: the queue
    holds at most max(quota, workers, credit_window) gradients, so
    staleness stays bounded by that many updates plus one a worker."""
    opt, bf = _async(quota=1, credit_window=5,
                     fault_plan=FaultPlan(slow_consumer=0.01))
    hist = opt.run(bf, steps=15)
    assert hist["fault_stats"]["slow_consumed"] >= 15
    assert max(hist["staleness"]) <= 5 + 3
    assert _no_worker_threads()


def test_skip_nonfinite_drops_poisoned_gradients():
    params, x, y = _problem()
    opt = ta.AsyncSGD(params, lr=0.02, quota=2, devices=[CPU] * 4,
                      skip_nonfinite=True)
    opt.compile_step(_loss)
    good = ta.dataset_batch_fn(x, y, 32)

    def batch_fn(rank, it):
        b = good(rank, it)
        if rank == 1:
            b = dict(b, x=np.full_like(b["x"], np.nan))
        return b

    hist = opt.run(batch_fn, steps=6)
    assert hist["fault_stats"]["nonfinite_dropped"] >= 1
    assert all(1 not in c for c in hist["contributors"])
    assert all(torch.isfinite(p).all() for p in opt.params.values())
    assert _no_worker_threads()


def test_worker_failure_surfaces():
    opt, _ = _async()

    def bad_batch_fn(rank, it):
        raise RuntimeError("data pipeline exploded")

    with pytest.raises(WorkerFailedError, match="worker") as e:
        opt.run(bad_batch_fn, steps=1)
    assert isinstance(e.value.__cause__, RuntimeError)
    assert _no_worker_threads()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_fleet_death_surfaces():
    """Workers that exit without an exception (a BaseException ends the
    thread outside the error channel) and without a gradient: the PS
    raises FleetDeadError instead of waiting forever."""
    opt, _ = _async()

    def leaving_batch_fn(rank, it):
        raise SystemExit  # ends the worker thread silently

    with pytest.raises(FleetDeadError, match="exited"):
        opt.run(leaving_batch_fn, steps=1)
    assert _no_worker_threads()


def test_kill_ps_at_raises_simulated_crash():
    opt, bf = _async(fault_plan=FaultPlan(kill_ps_at=2))
    with pytest.raises(SimulatedCrash, match="before update 2"):
        opt.run(bf, steps=5)
    assert len(opt.timings) == 2
    assert _no_worker_threads()


def test_byzantine_rank_is_trimmed():
    """Rank 0 sign-flips and scales its gradient x100; a trimmed mean (k=1)
    of the 3 workers' fills keeps the loss falling."""
    params, x, y = _problem()
    opt = ta.AsyncSGD(params, lr=0.01, quota=3, devices=[CPU] * 4,
                      aggregate="trimmed_mean", trim_k=1,
                      fault_plan=FaultPlan(byzantine_rank=0,
                                           byzantine_mode="scale",
                                           byzantine_scale=-100.0))
    opt.compile_step(_loss)
    hist = opt.run(ta.dataset_batch_fn(x, y, 32), steps=20)
    assert all(sorted(c) == [0, 1, 2] for c in hist["contributors"])
    assert np.mean(hist["losses"][-4:]) < np.mean(hist["losses"][:3])
    assert _no_worker_threads()


def test_async_state_dict_round_trip():
    opt, bf = _async()
    opt.run(bf, steps=3)
    sd = opt.state_dict()
    assert sd["aux"] == {} and sd["optim"] == "sgd"
    other, _ = _async()
    other.load_state_dict(sd)
    for n in opt.params:
        np.testing.assert_array_equal(_np(other.params[n]),
                                      _np(opt.params[n]))
        assert int(other.state[n]["step"]) == 3
    with pytest.raises(ValueError, match="name mismatch"):
        other.load_state_dict(dict(sd, params={"zz": np.zeros(1)}))


def test_default_devices_are_the_cards():
    """No device list: every visible card, and an error (no fall back to
    the CPU) when there is none."""
    if torch.cuda.is_available():
        opt = ta.AsyncSGD([("a", np.zeros(2, np.float32))], lr=0.1)
        assert opt.ps_device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ta.AsyncSGD([("a", np.zeros(2, np.float32))], lr=0.1)


# ---------------------------------------------------------------------------
# Validation: the JAX package's errors and messages
# ---------------------------------------------------------------------------

P = [("a", np.zeros((2,), np.float32))]

INIT_CASES = {
    "aggregate": dict(aggregate="bogus"),
    "trim_k": dict(trim_k=0),
    "quorum": dict(quorum=0),
    "fill_deadline": dict(fill_deadline=-1.0),
    "adaptive_deadline": dict(adaptive_deadline=True),
    "max_staleness": dict(max_staleness=-1),
    "credit_window": dict(credit_window=-1),
    "quota": dict(quota=0),
    "quorum_over_quota": dict(quota=2, quorum=3),
    "trimmed_mean_floor": dict(aggregate="trimmed_mean", quota=2),
    "trimmed_mean_k2_floor": dict(aggregate="trimmed_mean", trim_k=2,
                                  quota=4),
    "median_floor": dict(aggregate="median", quota=3, quorum=2),
    "deadline_without_quorum": dict(fill_deadline=0.1),
    "unique": dict(named=P + P),
    "hyper": dict(betas=(0.9, 0.99)),
    "optim": dict(optim="lamb"),
}


def _build_both(kw, workers=1):
    kw = dict(kw)
    named = kw.pop("named", P)
    kw.setdefault("optim", "sgd")
    out = []
    for mod, devs in ((ja, jax.devices()[:workers + 1]),
                      (ta, [CPU] * (workers + 1))):
        try:
            out.append(mod.AsyncPS(named, lr=0.1, devices=devs, **kw))
        except (ValueError, TypeError) as e:
            out.append(e)
    return out


@pytest.mark.parametrize("case", list(INIT_CASES))
def test_constructor_refusals_match_jax(case):
    jerr, terr = _build_both(INIT_CASES[case], workers=4)
    assert isinstance(jerr, Exception) and type(terr) is type(jerr)
    assert str(terr) == str(jerr)


RUN_CASES = {
    "lockstep": (dict(quota=5), True),
    "rank_distinct": (dict(aggregate="norm_clip", quota=3), False),
}


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_run_refusals_match_jax(case):
    kw, lockstep = RUN_CASES[case]
    jopt, topt = _build_both(kw, workers=1)
    msgs = []
    for opt, loss in ((jopt, lambda p, b: jnp.sum(p["a"] ** 2)),
                      (topt, lambda p, b: torch.sum(p["a"] ** 2))):
        opt._lockstep = lockstep
        opt.compile_step(loss)
        with pytest.raises(ValueError) as e:
            opt.run(lambda r, i: {}, steps=1)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_run_before_compile_refused():
    opt = ta.AsyncSGD(P, lr=0.1, devices=[CPU])
    with pytest.raises(NotCompiledError, match="compile_step"):
        opt.run(lambda r, i: {}, steps=1)


@pytest.mark.parametrize("anomaly_z", [None, 3.0])
@pytest.mark.parametrize("aggregate", ["mean", "trimmed_mean", "median",
                                       "norm_clip"])
def test_itemwise_path_choice_matches_jax(aggregate, anomaly_z):
    """A non-linear reducer, or anomaly scoring (which needs each
    contribution's norm), takes the decode-then-reduce path; plain mean
    takes the fused decode-sum."""
    jopt, topt = _build_both(dict(aggregate=aggregate, anomaly_z=anomaly_z,
                                  quota=3), workers=4)
    jopt.compile_step(lambda p, b: jnp.sum(p["a"] ** 2))
    topt.compile_step(lambda p, b: torch.sum(p["a"] ** 2))
    assert topt._itemwise == jopt._itemwise == (
        aggregate != "mean" or anomaly_z is not None)
