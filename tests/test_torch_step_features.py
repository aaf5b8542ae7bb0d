"""The step's features in the port against the JAX package's, end to end.

World-2 runs: the JAX optimizer on the ``mesh2`` fixture (two virtual CPU
devices), the port's on two spawned gloo ranks, from the same numpy
parameters and global batches (one spawn serves every MLP run, one every
ResNet run).  Each feature is held to the JAX package:

* error feedback with topk and with blockq (the residual, all-gathered to
  ``[world, ...]``, against JAX's ``ef_state``), and with skip-on-NaN
  rolling it back;
* ZeRO with the identity codec (the bucketed reduce-scatter), with blockq
  (a slice of the decoded sum) and with Adam and a clip across ranks;
* the topk, quantize and sign codecs, EMA (with skip-on-NaN), an lr
  schedule, and the profiled phases of ZeRO + EF + EMA (held bitwise to
  the same run unprofiled);
* on the narrow ResNet (BatchNorm statistics as aux): ``accum_steps=2``
  (the statistics thread through the microbatches in order) and remat;
* the replica-consensus guard: its fingerprint against the JAX guard's
  for the same parameters, and a world-2 run with one replica corrupted
  under each policy;
* checkpoint state: elastic resume 2 -> 1 and 1 -> 2 of ZeRO + EF state
  with the JAX package's refusals, and a state crossing JAX -> port ->
  JAX.

Tolerances: ``rtol=1e-5, atol=1e-6`` on the MLP (float32; one matmul per
layer, gradients ulps apart; the codes then come out the same), and
``rtol=1e-4, atol=1e-5`` on the ResNet (XLA and PyTorch sum convolutions in
other orders, and a few steps of momentum carry that forward).  Within the
port, a profiled run equals the unprofiled one bitwise.
"""

from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu import SGD as JSGD
from pytorch_ps_mpi_tpu import Adam as JAdam
from pytorch_ps_mpi_tpu import models as jmodels
from pytorch_ps_mpi_tpu.ops import codecs as jcodecs
from pytorch_ps_mpi_tpu.optim import schedules as jschedules
from pytorch_ps_mpi_tpu.parallel.mesh import make_ps_mesh
from pytorch_ps_mpi_tpu.ps import ElasticResumeError as JElasticResumeError
from pytorch_ps_mpi_tpu_torch import ElasticResumeError, SGD
from pytorch_ps_mpi_tpu_torch.ops import codecs as tcodecs
from pytorch_ps_mpi_tpu_torch.ps import param_fingerprints
from pytorch_ps_mpi_tpu_torch.utils.interop import (params_from_jax,
                                                    state_from_jax,
                                                    state_to_jax)

from torch_dist_helpers import (build_codec, build_schedule, run_spec,
                                run_world)

WORLD = 2
MLP_TOL = dict(rtol=1e-5, atol=1e-6)
RESNET_TOL = dict(rtol=1e-4, atol=1e-5)


def _batches(seed, shape, steps=3, n=8, nan_at=None):
    rng = np.random.RandomState(seed)
    out = [{"x": rng.randn(n, *shape).astype(np.float32),
            "y": rng.randint(0, 10, n).astype(np.int32)}
           for _ in range(steps)]
    if nan_at is not None:
        out[nan_at]["x"][0, 0] = np.nan
    return out


MLP = jmodels.init_mlp(np.random.RandomState(2), (48, 32, 10))
MLP_BATCHES = _batches(3, (4, 4, 3))
NAN_BATCHES = _batches(4, (4, 4, 3), steps=4, nan_at=1)

TOPK = ("TopKCodec", {"fraction": 0.25})
# name -> (optimizer, hyper, constructor kwargs, batches)
MLP_RUNS = {
    "ef_topk": ("sgd", {}, dict(code=TOPK, error_feedback=True), None),
    "ef_blockq": ("sgd", {}, dict(code="blockq", error_feedback=True), None),
    "ef_topk_skip": ("sgd", {}, dict(code=TOPK, error_feedback=True,
                                     skip_nonfinite=True), "nan"),
    "zero_identity": ("sgd", {}, dict(zero=True), None),
    "zero_blockq": ("sgd", {}, dict(zero=True, code="blockq"), None),
    "zero_adam_clip": ("adam", dict(lr=1e-2), dict(zero=True, clip_norm=0.5),
                       None),
    "zero_overlap_clip": ("sgd", {}, dict(zero=True, sync_mode="overlap",
                                          clip_norm=0.5), None),
    "topk": ("sgd", {}, dict(code="topk"), None),
    "topk_approx": ("sgd", {}, dict(code="topk_approx"), None),
    "quantize": ("sgd", {}, dict(code="quantize"), None),
    "sign": ("sgd", dict(lr=0.01), dict(code="sign"), None),
    "ema": ("sgd", {}, dict(ema_decay=0.9), None),
    "ema_skip": ("sgd", {}, dict(ema_decay=0.9, skip_nonfinite=True), "nan"),
    "cosine": ("sgd", dict(lr=("cosine", (0.2, 3), dict(warmup_steps=1))),
               {}, None),
    "zero_ef_ema": ("sgd", {}, dict(zero=True, code="blockq",
                                    error_feedback=True, ema_decay=0.9),
                    None),
    "zero_ef_ema_profiled": ("sgd", {}, dict(zero=True, code="blockq",
                                             error_feedback=True,
                                             ema_decay=0.9, profile=True),
                             None),
}


def _spec(optim, hyper, kwargs, batches):
    return {"kind": "mlp", "named": dict(MLP), "optim": optim,
            "hyper": {**dict(lr=0.1, momentum=0.9), **hyper}
            if optim == "sgd" else hyper,
            "kwargs": kwargs,
            "batches": NAN_BATCHES if batches == "nan" else MLP_BATCHES}


def _jax_optimizer(mesh, spec):
    cls = {"sgd": JSGD, "adam": JAdam}[spec.get("optim", "sgd")]
    hyper = dict(spec.get("hyper", dict(lr=0.1, momentum=0.9)))
    hyper["lr"] = build_schedule(jschedules, hyper["lr"])
    kw = dict(spec.get("kwargs", {}))
    kw["code"] = build_codec(jcodecs, kw.get("code"))
    opt = cls(list(spec["named"].items()), mesh=mesh, **hyper, **kw)
    if spec["kind"] == "mlp":
        opt.compile_step(jmodels.mlp_loss_fn, **spec.get("compile", {}))
    else:
        jmodel = jmodels.ResNet((1, 1), num_classes=10, dtype=jnp.float32)
        loss_fn, _ = jmodels.make_classifier_loss(jmodel, has_aux=True)
        opt.compile_step(loss_fn, has_aux=True, aux=spec["aux"],
                         **spec.get("compile", {}))
    return opt


def _jax_run(mesh, spec):
    opt = _jax_optimizer(mesh, spec)
    if spec.get("load") is not None:
        opt.load_state_dict(spec["load"])
    out = {"losses": [], "saved": None}
    for i, b in enumerate(spec["batches"]):
        loss, m = opt.step(b)
        out["losses"].append(loss)
        if spec.get("save_after") == i + 1:
            out["saved"] = opt.state_dict()
    out["state_dict"] = opt.state_dict()
    ef = opt.ef_state
    out["ef"] = None if ef is None else {n: np.asarray(v)
                                         for n, v in ef.items()}
    return out


@pytest.fixture(scope="module")
def mlp_runs(tmp_path_factory):
    specs = {name: _spec(*run) for name, run in MLP_RUNS.items()}
    specs.update(_elastic_specs())
    return run_world("ps_runs", WORLD, tmp_path_factory.mktemp("mlp"),
                     specs, timeout=300)


def _close(ours, ref, tol, what):
    for n, v in ref.items():
        np.testing.assert_allclose(np.asarray(ours[n]), np.asarray(v),
                                   err_msg=f"{what}: {n}", **tol)


def _check_run(ranks, ref, tol, what):
    out = ranks[0]["state_dict"]
    for r in ranks[1:]:  # replicated params and EMA on every rank
        for n, p in out["params"].items():
            np.testing.assert_array_equal(r["state_dict"]["params"][n], p)
    np.testing.assert_allclose(ranks[0]["losses"], ref["losses"],
                               err_msg=what, **tol)
    sd = ref["state_dict"]
    _close(out["params"], sd["params"], tol, what)
    for n, st in sd["state"].items():
        for k, v in st.items():
            np.testing.assert_allclose(out["state"][n][k], np.asarray(v),
                                       err_msg=f"{what}: {n}.{k}", **tol)
    if sd["ema"] is not None:
        _close(out["ema"], sd["ema"], tol, what)
    if ref["ef"] is not None:
        _close(ranks[0]["ef"], ref["ef"], tol, what)
        _close(out["ef"], sd["ef"], tol, what)


@pytest.mark.parametrize("name", list(MLP_RUNS))
def test_world2_mlp_feature_matches_jax(mesh2, mlp_runs, name):
    spec = _spec(*MLP_RUNS[name])
    ref = _jax_run(mesh2, spec)
    ranks = [r[name] for r in mlp_runs]
    _check_run(ranks, ref, MLP_TOL, name)
    if "skip" in name:
        assert [m["nonfinite_skip"] for m in ranks[0]["metrics"]] == [
            0.0, 1.0, 0.0, 0.0]


def test_profiled_features_match_unprofiled_bitwise(mlp_runs):
    a = mlp_runs[0]["zero_ef_ema"]
    b = mlp_runs[0]["zero_ef_ema_profiled"]
    assert a["losses"] == b["losses"]
    for key in ("params", "ema", "ef"):
        for n, v in a["state_dict"][key].items():
            np.testing.assert_array_equal(b["state_dict"][key][n], v)
    m = b["metrics"][-1]
    assert m["optim_step_time"] > 0 and m["ema_time"] > 0
    assert m["code_wait"] > 0 and m["comm_wait"] > 0


def test_zero_state_is_sharded_and_ef_is_rank_local():
    """In one process: a ZeRO optimizer's elementwise state holds this
    rank's chunk only (the whole, at world 1), and the EF residual is a
    ``[1, ...]`` float32 leaf."""
    opt = SGD(list(MLP.items()), lr=0.1, momentum=0.9, device="cpu",
              zero=True, code="blockq", error_feedback=True)
    for n, p in opt.params.items():
        assert opt.state[n]["momentum_buffer"].shape == (p.numel(),)
        assert opt.extras["ef"][n].shape == (1, *p.shape)
        assert opt.extras["ef"][n].dtype == torch.float32


# ---------------------------------------------------------------------------
# accum_steps with BatchNorm aux, and remat, on the narrow ResNet
# ---------------------------------------------------------------------------

BLOCKQ8 = ("BlockQuantizeCodec", {"block_rows": 8})
# name -> (compile_step kwargs, constructor kwargs)
RESNET_RUNS = {
    "accum2": (dict(accum_steps=2), {}),
    "remat": (dict(remat=True), {}),
    "accum2_remat_blockq": (dict(accum_steps=2, remat=True),
                            dict(code="blockq")),
    # The overlap engine in the JAX package's element order: 1,024-element
    # tiles, per leaf and fused per bucket (tiles straddle the leaves).
    "overlap_blockq": ({}, dict(code=BLOCKQ8, sync_mode="overlap")),
    "overlap_fused_blockq": ({}, dict(code=BLOCKQ8, sync_mode="overlap",
                                      fused_encode=True)),
    "remat_overlap_fused_blockq": (dict(remat=True), dict(
        code=BLOCKQ8, sync_mode="overlap", fused_encode=True)),
}


@pytest.fixture(scope="module")
def resnet():
    jmodel = jmodels.ResNet((1, 1), num_classes=10, dtype=jnp.float32)
    named, aux = jmodels.build_model(jmodel, (1, 8, 8, 3), seed=1)
    named = {n: np.asarray(p) for n, p in named.items()}
    aux = jax.tree.map(np.asarray, aux)
    return named, aux, _batches(0, (8, 8, 3), steps=2)


def _resnet_spec(named, aux, batches, name, port):
    compile_kw, kwargs = RESNET_RUNS[name]
    if port:
        tp, ta = params_from_jax(named, aux)
        named = {n: t.numpy() for n, t in tp.items()}
        aux = {n: t.numpy() for n, t in ta.items()}
    return {"kind": "resnet11", "named": named, "aux": aux,
            "compile": compile_kw, "kwargs": kwargs,
            "batches": batches}


@pytest.fixture(scope="module")
def resnet_runs(resnet, tmp_path_factory):
    specs = {name: _resnet_spec(*resnet, name, port=True)
             for name in RESNET_RUNS}
    return run_world("ps_runs", WORLD, tmp_path_factory.mktemp("resnet"),
                     specs, timeout=300)


@pytest.mark.parametrize("name", list(RESNET_RUNS))
def test_world2_resnet_accum_and_remat_match_jax(mesh2, resnet, resnet_runs,
                                                 name):
    """Gradient accumulation threads the BatchNorm statistics through the
    microbatches (aux compared); remat recomputes the forward in backward
    with the same result; the overlap engine quantizes in flax's element
    order, per leaf and fused, with remat too (the hooks fire once a
    leaf).  The blockq runs are held at the flip allowance of
    ``tests/test_torch_ps.py``'s blockq ResNet (one element in 10,000)."""
    ref = _jax_run(mesh2, _resnet_spec(*resnet, name, port=False))
    out = resnet_runs[0][name]["state_dict"]
    np.testing.assert_allclose(resnet_runs[0][name]["losses"], ref["losses"],
                               **RESNET_TOL)
    jp, jaux = params_from_jax(ref["state_dict"]["params"],
                               ref["state_dict"]["aux"])
    outside = sum(int((~np.isclose(out["params"][n], p.numpy(),
                                   **RESNET_TOL)).sum())
                  for n, p in jp.items())
    total = sum(p.numel() for p in jp.values())
    assert outside <= (1e-4 * total if name.endswith("blockq") else 0)
    if "fused" in name:
        fs = resnet_runs[0][name]["fault_stats"]
        assert fs["fused_sync_encodes"] == len(resnet[2])
    for n, a in jaux.items():
        np.testing.assert_allclose(out["aux"][n], a.numpy(), err_msg=n,
                                   **RESNET_TOL)


def test_accum_refusals_match_jax(mesh2):
    named = list(MLP.items())
    for opt in (SGD(named, lr=0.1, device="cpu", sync_mode="overlap"),
                JSGD(named, lr=0.1, mesh=mesh2, sync_mode="overlap")):
        with pytest.raises(ValueError, match="does not compose with "
                           "accum_steps"):
            opt.compile_step(lambda p, b: 0.0, accum_steps=2)
    batch = _batches(0, (4, 4, 3), steps=1, n=6)[0]
    from pytorch_ps_mpi_tpu_torch.models import mlp_loss_fn
    ours = SGD(named, lr=0.1, device="cpu")
    ours.compile_step(mlp_loss_fn, accum_steps=4)
    ref = JSGD(named, lr=0.1, mesh=mesh2)
    ref.compile_step(jmodels.mlp_loss_fn, accum_steps=4)
    for opt in (ours, ref):
        with pytest.raises(ValueError, match="does not split"):
            opt.step(batch)


def test_feature_refusals_match_jax(mesh2):
    named = list(MLP.items())
    cases = [(dict(error_feedback=True), "needs a lossy codec"),
             (dict(ema_decay=1.0), "ema_decay must be in"),
             (dict(ema_decay=0.0), "ema_decay must be in"),
             (dict(consensus_every=-1), "consensus_every must be"),
             (dict(consensus_policy="heal"), "consensus_policy must be")]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            JSGD(named, lr=0.1, mesh=mesh2, **kw)
        with pytest.raises(ValueError, match=match):
            SGD(named, lr=0.1, device="cpu", **kw)


# ---------------------------------------------------------------------------
# Replica consensus
# ---------------------------------------------------------------------------


def _jax_fingerprints(params):
    """The JAX guard's fingerprint vector (`MPI_PS._make_consensus_fn`'s
    body, without the cross-replica compare): per leaf a wrapping uint32
    sum, then per leaf an xor-fold of the bit pattern."""
    from jax import lax
    bits = {1: jnp.uint8, 2: jnp.uint16, 4: jnp.uint32}
    sums, xors = [], []
    for p in params.values():
        u = lax.bitcast_convert_type(p, bits[p.dtype.itemsize])
        u = u.astype(jnp.uint32).reshape(-1)
        sums.append(jnp.sum(u))
        xors.append(lax.reduce(u, jnp.uint32(0), lax.bitwise_xor, (0,)))
    return np.asarray(jax.jit(lambda: jnp.stack(sums + xors))())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fingerprints_match_jax(resnet, dtype):
    """The port's fingerprints equal the JAX guard's for the same
    parameters (the ResNet's, in each package's layout: a sum and an xor
    do not see the element order), bitwise."""
    named, _, _ = resnet
    extra = {"odd": np.arange(7, dtype=np.float32) - 3.0,
             "neg_zero": np.array([-0.0, 0.0], np.float32)}
    tp, _ = params_from_jax(named)
    jparams = OrderedDict(
        (n, jnp.asarray(a, jnp.dtype(dtype)))
        for n, a in [*named.items(), *extra.items()])
    tparams = OrderedDict(
        (n, t.to(getattr(torch, dtype)))
        for n, t in [*tp.items(), *((n, torch.from_numpy(a))
                                    for n, a in extra.items())])
    want = _jax_fingerprints(jparams)
    got = param_fingerprints(tparams).numpy()
    assert got.shape == (2 * len(tparams),) and got.max() < 2 ** 32
    np.testing.assert_array_equal(got.astype(np.uint32), want)


def _consensus_specs():
    base = {"kind": "mlp", "named": dict(MLP), "batches": MLP_BATCHES}
    return {
        "cadence": {**base, "kwargs": dict(consensus_every=2)},
        "abort": {**base, "corrupt": (2, 1, "dense1/kernel"),
                  "check": True},
        "rebroadcast": {**base, "kwargs": dict(
            consensus_policy="rebroadcast"),
            "corrupt": (2, 1, "dense1/kernel"), "check": True},
    }


@pytest.fixture(scope="module")
def consensus_runs(tmp_path_factory):
    return run_world("ps_runs", WORLD, tmp_path_factory.mktemp("sdc"),
                     _consensus_specs(), timeout=300)


def test_world2_consensus_cadence_is_clean(consensus_runs):
    for r in consensus_runs:
        fs = r["cadence"]["fault_stats"]
        assert fs["sdc_checks"] == 1 and fs["sdc_mismatches"] == 0
        assert r["cadence"]["metrics"][1]["sdc_mismatch"] == 0.0


@pytest.mark.parametrize("policy", ["abort", "rebroadcast"])
def test_world2_corrupted_replica_is_caught(consensus_runs, policy):
    """Rank 1's copy of one leaf gets a bit flipped: every rank's guard
    names the leaf; "abort" raises `SDCDetectedError` on every rank,
    "rebroadcast" restores rank 0's copy (bitwise, on both ranks) and the
    next check passes."""
    for r in consensus_runs:
        run = r[policy]
        fs = run["fault_stats"]
        assert fs["sdc_mismatches"] == 1
        assert fs["sdc_first_leaf"] == "dense1/kernel"
        if policy == "abort":
            assert "dense1/kernel" in run["sdc"]
        else:
            assert run["check"]["first_leaf"] == "dense1/kernel"
            assert fs["sdc_rebroadcasts"] == 1
    if policy == "rebroadcast":
        p0 = consensus_runs[0][policy]["state_dict"]["params"]
        p1 = consensus_runs[1][policy]["state_dict"]["params"]
        for n in p0:
            np.testing.assert_array_equal(p0[n], p1[n])


# ---------------------------------------------------------------------------
# Checkpoint state: elastic N -> M, and across packages
# ---------------------------------------------------------------------------

ELASTIC = dict(kwargs=dict(zero=True, code=TOPK, error_feedback=True))
ELASTIC_BATCHES = _batches(6, (4, 4, 3), steps=5)


def _elastic_base():
    return {"kind": "mlp", "named": dict(MLP), **ELASTIC}


def _world1_source():
    """The 1 -> 2 source: three steps of the port at world 1, in this
    process (memoized: the world-2 spawn needs it before the tests)."""
    if not hasattr(_world1_source, "out"):
        _world1_source.out = run_spec(
            {**_elastic_base(), "batches": ELASTIC_BATCHES[:3],
             "save_after": 3})
    return _world1_source.out


def _elastic_specs():
    return {
        # 2 -> 1: the world-2 source, saved after 3 steps.
        "elastic_src2": {**_elastic_base(), "batches": ELASTIC_BATCHES[:3],
                         "save_after": 3},
        "elastic_src2_raw": {**_elastic_base(),
                             "batches": ELASTIC_BATCHES[:3],
                             "save_after": 3, "raw_shards": True},
        # 1 -> 2: the world-1 source's state, two more steps at world 2.
        "elastic_to2": {**_elastic_base(), "batches": ELASTIC_BATCHES[3:],
                        "load": _world1_source()["saved"]},
    }


def _jax_elastic(src_mesh, dst_mesh):
    src = _jax_run(src_mesh, {**_elastic_base(), "hyper": dict(
        lr=0.1, momentum=0.9), "batches": ELASTIC_BATCHES[:3],
        "save_after": 3})
    return _jax_run(dst_mesh, {**_elastic_base(), "hyper": dict(
        lr=0.1, momentum=0.9), "batches": ELASTIC_BATCHES[3:],
        "load": src["saved"]})


@pytest.mark.parametrize("src,dst", [(2, 1), (1, 2)])
def test_elastic_resume_zero_ef_matches_jax(mesh2, mlp_runs, src, dst):
    """ZeRO + EF(topk) state saved at one world size continues at the
    other: the ZeRO state de-chunks and re-chunks, the EF residual's sum
    splits evenly over the new ranks, as in the JAX package."""
    ref = _jax_elastic(make_ps_mesh(src), make_ps_mesh(dst))
    if src == 2:
        saved = mlp_runs[0]["elastic_src2"]["saved"]
        assert saved["topology"]["world_size"] == 2
        assert saved["ef"]["dense0/kernel"].shape == (2, 48, 32)
        out = run_spec({**_elastic_base(), "batches": ELASTIC_BATCHES[3:],
                        "load": saved})
        ranks = [out]
    else:
        ranks = [r["elastic_to2"] for r in mlp_runs]
    _check_run(ranks, ref, MLP_TOL, f"elastic {src}->{dst}")


def test_elastic_refusals_name_the_component(mesh2):
    """The JAX package's refusals (`tests/test_elastic.py`), each naming
    the component, in both packages."""
    named = list(MLP.items())
    jsrc = JSGD(named, lr=0.05, momentum=0.9, mesh=mesh2)
    jsrc.compile_step(jmodels.mlp_loss_fn)
    jsrc.step(MLP_BATCHES[0])
    src = run_spec({"kind": "mlp", "named": dict(MLP),
                    "hyper": dict(lr=0.05, momentum=0.9),
                    "batches": MLP_BATCHES[:1]})["state_dict"]
    other = dict(MLP, **{"dense0/kernel": np.zeros((48, 31), np.float32)})
    bad_state = {**src, "state": {**src["state"], "dense0/kernel": {
        **src["state"]["dense0/kernel"],
        "momentum_buffer": np.zeros((5, 7), np.float32)}}}
    ef_src = run_spec({"kind": "mlp", "named": dict(MLP),
                       "kwargs": dict(code=("TopKCodec", {"k": 3}),
                                      error_feedback=True),
                       "batches": MLP_BATCHES[:1]})["state_dict"]
    bad_ef = {**ef_src, "ef": {**ef_src["ef"],
                               "dense0/kernel": np.zeros((8, 3, 3),
                                                         np.float32)}}
    for errors, mk in (
            (JElasticResumeError, lambda named, **kw: JSGD(
                named, lr=0.05, momentum=0.9, mesh=mesh2, **kw)),
            (ElasticResumeError, lambda named, **kw: SGD(
                named, lr=0.05, momentum=0.9, device="cpu", **kw))):
        with pytest.raises(errors, match="'dense0/kernel'.*model"):
            mk(list(other.items())).load_state_dict(src)
        with pytest.raises(errors,
                           match="optimizer state for 'dense0/kernel'"):
            mk(named).load_state_dict(bad_state)
        lib = jcodecs if errors is JElasticResumeError else tcodecs
        with pytest.raises(errors, match="error-feedback.*'dense0/kernel'"):
            mk(named, code=build_codec(lib, ("TopKCodec", {"k": 3})),
               error_feedback=True).load_state_dict(bad_ef)
    assert issubclass(ElasticResumeError, ValueError)


def test_state_crosses_jax_port_jax(resnet):
    """A JAX state_dict (ResNet, SGD momentum, EMA, world 1) loads into the
    port through `state_from_jax`, two port steps later the port's loads
    back into JAX through `state_to_jax`, and a last JAX step: the
    trajectory of five JAX steps in one run, within the ResNet
    tolerance."""
    named, aux, _ = resnet
    batches = _batches(9, (8, 8, 3), steps=5)
    mesh1 = make_ps_mesh(1)
    jspec = {"kind": "resnet11", "named": named, "aux": aux,
             "hyper": dict(lr=0.1, momentum=0.9),
             "kwargs": dict(ema_decay=0.9)}
    whole = _jax_run(mesh1, {**jspec, "batches": batches})
    first = _jax_run(mesh1, {**jspec, "batches": batches[:2]})
    tp, ta = params_from_jax(named, aux)
    port = run_spec({"kind": "resnet11",
                     "named": {n: t.numpy() for n, t in tp.items()},
                     "aux": {n: t.numpy() for n, t in ta.items()},
                     "kwargs": dict(ema_decay=0.9), "batches": batches[2:4],
                     "load": state_from_jax(first["state_dict"])})
    back = state_to_jax(port["state_dict"])
    last = _jax_run(mesh1, {**jspec, "batches": batches[4:], "load": back})
    np.testing.assert_allclose(
        first["losses"] + port["losses"] + last["losses"], whole["losses"],
        **RESNET_TOL)
    for key in ("params", "ema"):
        _close(last["state_dict"][key], whole["state_dict"][key],
               RESNET_TOL, key)
    for n, st in whole["state_dict"]["state"].items():
        np.testing.assert_allclose(
            last["state_dict"]["state"][n]["momentum_buffer"],
            st["momentum_buffer"], err_msg=n, **RESNET_TOL)
        assert int(last["state_dict"]["state"][n]["step"]) == 5
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, **RESNET_TOL), last["state_dict"]["aux"],
        whole["state_dict"]["aux"])


def test_rescale_lr_matches_jax(mesh2):
    """`rescale_lr` on a float lr and on a schedule: the same lrs as the
    JAX package's, bitwise, and a scheduled lr still checkpoints as the
    schedule marker; a scale that is not positive is refused."""
    from pytorch_ps_mpi_tpu_torch.optim import schedules as tschedules
    named = list(MLP.items())
    for lr in (0.1, ("exponential", (0.1, 0.9), {})):
        ours = SGD(named, lr=build_schedule(tschedules, lr), device="cpu")
        ref = JSGD(named, lr=build_schedule(jschedules, lr), mesh=mesh2)
        for opt in (ours, ref):
            opt.rescale_lr(0.3)
            with pytest.raises(ValueError, match="positive"):
                opt.rescale_lr(0.0)
        if callable(ours.hyper["lr"]):
            got = np.asarray([ours.hyper["lr"](s) for s in range(12)],
                             np.float32)
            want = np.asarray([ref.hyper["lr"](jnp.int32(s))
                               for s in range(12)], np.float32)
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))
            assert ours.state_dict()["hyper"]["lr"] == \
                ref.state_dict()["hyper"]["lr"]
        else:
            assert ours.hyper["lr"] == ref.hyper["lr"]


def test_raw_zero_shards_resume_on_another_world(mlp_runs):
    """A raw-shard save (``(world, chunk)`` rows, recorded topology)
    resumes at world 1 to the same bits as the de-chunked save."""
    raw = mlp_runs[0]["elastic_src2_raw"]["saved"]
    assert raw["topology"]["raw_zero_shards"]
    assert raw["state"]["dense0/kernel"]["momentum_buffer"].shape == (
        2, 48 * 32 // 2)
    outs = [run_spec({**_elastic_base(), "batches": ELASTIC_BATCHES[3:],
                      "load": mlp_runs[0][key]["saved"]})
            for key in ("elastic_src2_raw", "elastic_src2")]
    for n, p in outs[1]["state_dict"]["params"].items():
        np.testing.assert_array_equal(outs[0]["state_dict"]["params"][n], p)
