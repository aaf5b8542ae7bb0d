"""The port's overlap engine (`parallel/overlap.py`) and the step options
that compose with it, against the JAX package's.

World-2 cases run the port on two spawned gloo ranks (a few spawns for the
whole file, each running several cases) and the JAX package on the
``mesh2`` fixture, from the same numpy inputs.  Tolerances:

* none (bitwise) for the bucket plans, `auto_bucket_bytes`, the identity
  bucket sync (a sum of two float32 values is exact in either order), the
  fused blockq bucket against its staged composition of plain versions,
  and a profiled step against an unprofiled one;
* ``rtol=1e-6, atol=0`` for the fused blockq bucket against JAX's
  `_sync_blockq_fused`, which differs from its own staged programs by one
  ulp of a sum on the CPU, and for the per-leaf codec sync against JAX's
  `_sync_codec`;
* ``rtol=1e-5, atol=1e-6`` for MLP trajectories, as in
  ``tests/test_torch_ps.py``: XLA and PyTorch matmuls differ in the last
  bits.
"""

import json
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pytorch_ps_mpi_tpu import SGD as JSGD, Adam as JAdam
from pytorch_ps_mpi_tpu import models as jmodels
from pytorch_ps_mpi_tpu.parallel import overlap as JOV
from pytorch_ps_mpi_tpu.utils import timing as jtiming
from pytorch_ps_mpi_tpu_torch import SGD
from pytorch_ps_mpi_tpu_torch.models import build_model, mlp_loss_fn, resnet18
from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck
from pytorch_ps_mpi_tpu_torch.ops.codecs import BlockQuantizeCodec
from pytorch_ps_mpi_tpu_torch.parallel import overlap as OV
from pytorch_ps_mpi_tpu_torch.utils import timing

from torch_dist_helpers import run_world, scaled_bucket

WORLD = 2

# ---------------------------------------------------------------------------
# Plans, the tuner, the schedule record (one process)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def leaf_sets():
    named, _ = build_model(resnet18())
    mlp = jmodels.init_mlp(np.random.RandomState(0), (784, 128, 64, 10))
    return {"resnet18": named,
            "mlp": OrderedDict((n, torch.from_numpy(v))
                               for n, v in mlp.items())}


@pytest.mark.parametrize("bucket_bytes", [4 << 20, 1 << 20, 64 << 10])
def test_plan_overlap_matches_jax(leaf_sets, bucket_bytes):
    for name, named in leaf_sets.items():
        ours = OV.plan_overlap(named, bucket_bytes, record=False)
        ref = JOV.plan_overlap(
            OrderedDict((n, jnp.zeros(tuple(t.shape), jnp.float32))
                        for n, t in named.items()),
            bucket_bytes, record=False)
        assert ours.buckets == ref.buckets, name
        assert ours.describe() == ref.describe(), name
    assert OV.plan_overlap(leaf_sets["resnet18"], 4 << 20,
                           record=False).n_buckets == 12


def _roofline(tmp_path, hbm):
    path = tmp_path / "roofline.json"
    path.write_text(json.dumps({"peaks": {"hbm_bytes_per_s": hbm}}))
    return str(path)


@pytest.mark.parametrize("world", [1, 2, 8])
def test_auto_bucket_bytes_matches_jax(tmp_path, world):
    """The same formula on the same explicit roofline file, at totals
    below, inside and above the clamp, and with a latency floor that
    binds."""
    for hbm in (819e9, 3.35e12, 40e12):
        path = _roofline(tmp_path, hbm)
        for total in (10, 44_695_848, 256 << 20, 877_387_776, 100 << 30):
            assert (OV.auto_bucket_bytes(total, world=world,
                                         roofline_path=path)
                    == JOV.auto_bucket_bytes(total, world=world,
                                             roofline_path=path))
        named = OrderedDict(w=torch.zeros(3_000_000), b=torch.zeros(10))
        jnamed = OrderedDict(w=jnp.zeros(3_000_000), b=jnp.zeros(10))
        assert OV.plan_overlap(
            named, None, world=world, record=False,
            roofline_path=path).describe() == JOV.plan_overlap(
            jnamed, None, world=world, record=False,
            roofline_path=path).describe()


def test_auto_bucket_bytes_default_is_the_h100_rate(tmp_path):
    """No roofline file is read unless one is named: the default is the
    published H100 HBM rate, and an unreadable file falls back to it."""
    path = _roofline(tmp_path, OV.H100_HBM_BYTES_PER_S)
    for total, world in ((10, 8), (44_695_848, 2), (3 << 30, 64)):
        want = OV.auto_bucket_bytes(total, world=world, roofline_path=path)
        assert OV.auto_bucket_bytes(total, world=world) == want
        assert OV.auto_bucket_bytes(
            total, world=world,
            roofline_path=str(tmp_path / "missing.json")) == want
    # 4 ranks: the latency floor binds, 3.35e11 B/s x 10 us x 3 hops.
    assert OV.auto_bucket_bytes(1 << 20, world=4) == int(
        3.35e12 / 10.0 * OV.PER_HOP_LATENCY_S * 3) == 10_050_000


def _named():
    return list(jmodels.init_mlp(np.random.RandomState(0),
                                 (16, 32, 4)).items())


def test_constructing_overlap_optimizer_records_schedule():
    timing.clear_overlap_schedules()
    opt = SGD(_named(), lr=0.1, device="cpu", code="blockq",
              sync_mode="overlap", bucket_mb=0, overlap_reducer="psum")
    recs = timing.overlap_schedules()
    assert len(recs) == 1
    assert recs[0] == {**opt.overlap_plan.describe(), "reducer": "psum",
                       "codec": "blockq", "world": 1, "zero": False}
    assert recs[0]["auto_tuned"] is True
    assert opt.overlap_plan.bucket_bytes == OV.auto_bucket_bytes(
        opt.overlap_plan.total_bytes, world=1) == 3_350_000
    timing.clear_overlap_schedules()
    assert timing.overlap_schedules() == []


def test_format_fault_stats_matches_jax():
    opt = SGD(_named(), lr=0.1, device="cpu")
    assert set(opt.fault_stats) == {
        "sdc_checks", "sdc_mismatches", "sdc_rebroadcasts",
        "sdc_first_leaf", "sdc_events", "fused_sync_encodes", "rollbacks"}
    busy = dict(opt.fault_stats, fused_sync_encodes=3, sdc_checks=2,
                sdc_first_leaf="w", rollbacks=[{"step": 1}])
    for fs in (opt.fault_stats, busy):
        assert (timing.format_fault_stats(fs)
                == jtiming.format_fault_stats(fs))
    assert timing.format_fault_stats(opt.fault_stats) == "clean"


def test_refusals_match_jax(mesh2):
    """Each bad combination is refused with the JAX package's error."""
    named = _named()
    cases = [
        (dict(code="blockq", fused_encode=True), "fused_encode requires"),
        (dict(code="blockq", sync_mode="overlap", skip_nonfinite=True),
         "needs the\\s+identity codec"),
        (dict(sync_mode="overlap", overlap_reducer="ring"),
         "overlap_reducer must be"),
        (dict(clip_norm=0.0), "clip_norm must be positive"),
        (dict(clip_norm=float("nan")), "clip_norm must be positive"),
        (dict(code="blockq", sync_mode="overlap", error_feedback=True),
         "does not compose with\\s+error_feedback"),
    ]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            JSGD(named, lr=0.1, mesh=mesh2, **kw)
        with pytest.raises(ValueError, match=match):
            SGD(named, lr=0.1, device="cpu", **kw)
    # Checked where the step is built, in both packages.
    for jopt, opt, kw, match in (
            (JSGD(named, lr=0.1, mesh=mesh2, code="bf16",
                  sync_mode="overlap", fused_encode=True),
             SGD(named, lr=0.1, device="cpu", code="bf16",
                 sync_mode="overlap", fused_encode=True), {},
             "fused_encode supports the identity and blockq codecs"),
            (JSGD(named, lr=0.1, mesh=mesh2, sync_mode="overlap"),
             SGD(named, lr=0.1, device="cpu", sync_mode="overlap"),
             dict(accum_steps=2), "does not compose with accum_steps")):
        with pytest.raises(ValueError, match=match):
            jopt.compile_step(jmodels.mlp_loss_fn, **kw)
        with pytest.raises(ValueError, match=match):
            opt.compile_step(mlp_loss_fn, **kw)
    with pytest.raises(ValueError, match="unknown overlap reducer"):
        OV.make_bucket_sync_fn(group=None, world=1, reducer="ring")


# ---------------------------------------------------------------------------
# The bucket syncs at world 2
# ---------------------------------------------------------------------------

# The JAX fused-blockq test's bucket (421 elements: one 8-row tile), and a
# bucket of 78,008 elements: 512-row tiles, the first of which straddles
# the first two leaves, and an odd size, so rs_ag pads.
BUCKETS = {"small": ([(40, 7), (111,), (5, 3, 2)], 3),
           "large": ([(300, 250), (7,), (1000, 3)], 5)}


@pytest.fixture(scope="module")
def sync_runs(tmp_path_factory):
    return run_world("overlap_sync_case", WORLD,
                     tmp_path_factory.mktemp("sync"), BUCKETS)


def _jax_sync(mesh, fn, key):
    shapes, seed = BUCKETS[key]
    base = OrderedDict((n, jnp.asarray(t.numpy()))
                       for n, t in scaled_bucket(0, shapes, seed).items())

    def body(scale):
        return fn(OrderedDict((n, b * scale[0]) for n, b in base.items()))

    ranks = np.arange(1, WORLD + 1, dtype=np.float32)
    out = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("ps"),
                                out_specs=P(), check_vma=False))(ranks)
    return {n: np.asarray(v) for n, v in out.items()}


@pytest.mark.parametrize("reducer", ["rs_ag", "psum"])
def test_sync_identity_matches_jax(mesh2, sync_runs, reducer):
    for key in BUCKETS:
        ref = _jax_sync(mesh2, lambda c: JOV._sync_identity(
            c, "ps", WORLD, reducer), key)
        for r in sync_runs:
            ours = r[key][reducer]
            assert list(ours) == list(ref)
            for n in ref:
                np.testing.assert_array_equal(ours[n], ref[n], err_msg=n)


def _staged(key, bits):
    """The fused bucket's contract: each rank's concatenated bucket through
    `block_quantize_ref`, stacked in rank order, `block_dequant_sum_ref`,
    sliced back."""
    shapes, seed = BUCKETS[key]
    flats = [torch.cat([g.reshape(-1) for g in
                        scaled_bucket(r, shapes, seed).values()])
             for r in range(WORLD)]
    n = flats[0].numel()
    rows = BlockQuantizeCodec()._rows_for(n)
    codes = [ck.block_quantize_ref(ck.pad_to_blocks(f, rows)[0], bits=bits,
                                   block_rows=rows) for f in flats]
    summed = ck.block_dequant_sum_ref(
        torch.stack([q for q, _ in codes]),
        torch.stack([s for _, s in codes]), block_rows=rows).view(-1)[:n]
    out, off = {}, 0
    for i, s in enumerate(shapes):
        size = int(np.prod(s))
        out[f"g{i}"] = summed[off:off + size].reshape(s).numpy()
        off += size
    return out, rows


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("key", list(BUCKETS))
def test_sync_blockq_fused_equals_staged_composition(sync_runs, key, bits):
    ref, rows = _staged(key, bits)
    assert rows == (8 if key == "small" else 512)
    for r in sync_runs:
        for n in ref:
            np.testing.assert_array_equal(r[key][f"fused{bits}"][n], ref[n],
                                          err_msg=n)


@pytest.mark.parametrize("key", list(BUCKETS))
def test_sync_blockq_fused_matches_jax(mesh2, sync_runs, key):
    from pytorch_ps_mpi_tpu.ops.codecs import BlockQuantizeCodec as JBQ

    ref = _jax_sync(mesh2, lambda c: JOV._sync_blockq_fused(c, "ps", JBQ()),
                    key)
    for n in ref:
        np.testing.assert_allclose(sync_runs[0][key]["fused8"][n], ref[n],
                                   rtol=1e-6, atol=0, err_msg=n)


@pytest.mark.parametrize("code", ["blockq", "bf16"])
def test_sync_codec_matches_jax(mesh2, sync_runs, code):
    """The per-leaf codec bucket sync: each leaf encoded, the bucket's codes
    gathered, decode-summed (``rtol=1e-6``, as for the fused path: the JAX
    decode runs in XLA)."""
    from pytorch_ps_mpi_tpu.ops.codecs import get_codec as jget_codec

    for key in BUCKETS:
        ref = _jax_sync(mesh2, lambda c: JOV._sync_codec(
            c, "ps", jget_codec(code)), key)
        for r in sync_runs:
            for n in ref:
                np.testing.assert_allclose(r[key][f"codec_{code}"][n],
                                           ref[n], rtol=1e-6, atol=0,
                                           err_msg=n)


# ---------------------------------------------------------------------------
# The hooks: each bucket starts inside backward; leaves outside the loss
# ---------------------------------------------------------------------------

# Buckets of the MLP (16, 32, 32, 4) plus two leaves outside the loss at
# 2,200 bytes: [dense0 kernel+bias], [dense1 kernel],
# [dense1 bias, dense2, unused] (partly used), [unused_bf16] (unused).
HOOK_BUCKET_BYTES = 2200


@pytest.fixture(scope="module")
def hook_runs(tmp_path_factory):
    rng = np.random.RandomState(8)
    batch = {"x": rng.randn(16, 16).astype(np.float32),
             "y": rng.randint(0, 4, 16).astype(np.int32)}
    return run_world("overlap_hooks_case", WORLD,
                     tmp_path_factory.mktemp("hooks"), batch,
                     HOOK_BUCKET_BYTES)


def test_buckets_start_inside_backward(hook_runs):
    for r in hook_runs:
        assert r["buckets"] == (
            ("dense0/kernel", "dense0/bias"), ("dense1/kernel",),
            ("dense1/bias", "dense2/kernel", "dense2/bias", "unused"),
            ("unused_bf16",))
        # When the first layer's activation gradient was computed, the
        # bucket of dense1's kernel had started.
        assert r["started"] == [1]


def test_hooked_grads_are_cross_rank_summed(hook_runs):
    """`BucketHooks.finish` and `wrap_loss` give the all-reduce of the raw
    gradients, zeros for the leaves outside the loss (bitwise: a sum of
    two float32 values is exact)."""
    for r in hook_runs:
        assert list(r["summed"]) == list(r["ref"])
        for n, g in r["ref"].items():
            np.testing.assert_array_equal(r["summed"][n], g, err_msg=n)
            np.testing.assert_array_equal(r["wrap"][n], g, err_msg=n)
        for n in ("unused", "unused_bf16"):
            assert not r["ref"][n].any()
        assert all(r["ref"][n].any() for n in r["ref"] if "dense" in n)


def test_param_outside_the_loss_gets_zero_gradient(hook_runs):
    """An overlap SGD step over params with two leaves outside the loss
    finishes (no rank waits for a collective the other never issues), and
    leaves them as they were; the others move, alike on both ranks."""
    for r in hook_runs:
        for n in ("unused", "unused_bf16"):
            np.testing.assert_array_equal(r["stepped"][n], r["params"][n])
        for n in r["params"]:
            if "dense" in n:
                assert not np.array_equal(r["stepped"][n], r["params"][n])
            np.testing.assert_array_equal(r["stepped"][n],
                                          hook_runs[0]["stepped"][n])


# ---------------------------------------------------------------------------
# MLP trajectories at world 2 against JAX; profile; the fused counter
# ---------------------------------------------------------------------------

SMALL_MB = 0.002  # 2,097 bytes: the MLP's leaves in three buckets
VARIANTS = {
    "identity_rs_ag": ("sgd", dict(lr=0.1, momentum=0.9,
                                   sync_mode="overlap"), "clean"),
    "identity_psum": ("sgd", dict(lr=0.1, momentum=0.9, sync_mode="overlap",
                                  overlap_reducer="psum",
                                  bucket_mb=SMALL_MB), "clean"),
    "blockq": ("sgd", dict(lr=0.1, momentum=0.9, code="blockq",
                           sync_mode="overlap", bucket_mb=SMALL_MB), "clean"),
    "blockq_fused": ("sgd", dict(lr=0.1, momentum=0.9, code="blockq",
                                 sync_mode="overlap", fused_encode=True,
                                 bucket_mb=SMALL_MB), "clean"),
    "bf16": ("sgd", dict(lr=0.1, momentum=0.9, code="bf16",
                         sync_mode="overlap"), "clean"),
    "adam_clip_skip": ("adam", dict(lr=0.1, clip_norm=0.5,
                                    skip_nonfinite=True,
                                    sync_mode="overlap"), "poisoned"),
}
# The port only: each profiled run against its unprofiled twin above or
# here, bitwise.
PROFILED = {
    "blockq_fused_profile": ("blockq_fused", dict(profile=True)),
    "adam_clip_skip_profile": ("adam_clip_skip", dict(profile=True)),
    "bucketed_blockq": ("blockq", dict(sync_mode="bucketed",
                                       bucket_mb=4.0)),
    "bucketed_blockq_profile": ("blockq", dict(sync_mode="bucketed",
                                               bucket_mb=4.0, profile=True)),
}


def _mlp_batches():
    rng = np.random.RandomState(0)
    clean = [{"x": rng.randn(64, 16).astype(np.float32),
              "y": rng.randint(0, 4, 64).astype(np.int32)}
             for _ in range(3)]
    poisoned = [dict(b, x=b["x"].copy()) for b in clean]
    poisoned[1]["x"][3, :] = np.nan  # rank 0's shard of step 2
    return {"clean": clean, "poisoned": poisoned}


def _port_variants():
    out = dict(VARIANTS)
    for name, (base, extra) in PROFILED.items():
        optim, kw, key = VARIANTS[base]
        out[name] = (optim, {**kw, **extra}, key)
    return out


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory):
    named = jmodels.init_mlp(np.random.RandomState(0), (16, 32, 4))
    return run_world("overlap_trajectories", WORLD,
                     tmp_path_factory.mktemp("traj"), dict(named),
                     _port_variants(), _mlp_batches())


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_world2_overlap_trajectory_matches_jax(mesh2, trajectories,
                                               variant):
    optim, kw, key = VARIANTS[variant]
    named = jmodels.init_mlp(np.random.RandomState(0), (16, 32, 4))
    jopt = {"sgd": JSGD, "adam": JAdam}[optim](list(named.items()),
                                               mesh=mesh2, **kw)
    jopt.compile_step(jmodels.mlp_loss_fn)
    jl, jm = zip(*(jopt.step(b) for b in _mlp_batches()[key]))
    tol = dict(rtol=1e-5, atol=1e-6)
    out = trajectories[0][variant]
    np.testing.assert_allclose(out["losses"], jl, **tol)
    for m, j in zip(out["metrics"], jm):
        for k in ("msg_bytes", "packaged_bytes", "nonfinite_skip"):
            assert m[k] == j[k], k
    for n, p in jopt.params.items():
        np.testing.assert_allclose(out["params"][n], np.asarray(p),
                                   err_msg=n, **tol)
        np.testing.assert_array_equal(trajectories[1][variant]["params"][n],
                                      out["params"][n])
    if key == "poisoned":
        assert [m["nonfinite_skip"] for m in out["metrics"]] == [0, 1, 0]


@pytest.mark.parametrize("name", [n for n in PROFILED if "profile" in n])
def test_profiled_step_matches_unprofiled(trajectories, name):
    base = PROFILED[name][0]
    if name.startswith("bucketed"):
        base = "bucketed_blockq"
    for r in trajectories:
        ours, ref = r[name], r[base]
        np.testing.assert_array_equal(ours["losses"], ref["losses"])
        for n, p in ref["params"].items():
            np.testing.assert_array_equal(ours["params"][n], p, err_msg=n)
        for m, rm in zip(ours["metrics"], ref["metrics"]):
            assert m["nonfinite_skip"] == rm["nonfinite_skip"]
            if m["nonfinite_skip"]:
                continue
            assert m["backward_time"] > 0 and m["optim_step_time"] > 0
            assert m["isend_time"] >= 0 and m["comm_wait"] >= 0
            if name.startswith("bucketed"):  # an encode and a decode phase
                assert m["code_wait"] > 0
                assert m["decode_time"] == m["comm_wait"]


def test_fused_sync_encodes_counts_steps(trajectories):
    for r in trajectories:
        assert r["blockq_fused"]["fault_stats"]["fused_sync_encodes"] == 3
        assert r["blockq_fused_profile"]["fault_stats"][
            "fused_sync_encodes"] == 3
        for name in ("blockq", "identity_rs_ag", "bucketed_blockq"):
            assert r[name]["fault_stats"]["fused_sync_encodes"] == 0
