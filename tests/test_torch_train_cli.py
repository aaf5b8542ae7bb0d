"""The port's training CLI (`pytorch_ps_mpi_tpu_torch.train`) against the
JAX package's (`pytorch_ps_mpi_tpu.train`), both run in-process on the CPU.

The JAX CLI runs with ``--n-devices 1`` (or 2 for the world-2 case): under
the 8-device test mesh its step would otherwise sum 8 ranks' gradients.
The port runs with ``--force-cpu-devices 1`` (gloo, one process), and at
world 2 in two spawned gloo ranks (`torch_dist_helpers.cli_runs`).

Tolerances:

* the MLP (one set of numpy weights, the same batches from the same
  resumable loader): final params within ``rtol=1e-5, atol=1e-6`` — XLA
  and PyTorch sum each matmul in other orders.  With blockq a code can
  land one quantum apart where a gradient sits within float32 noise of a
  rounding boundary, so at most one element in 10,000 may fall outside
  (the allowance of `test_world2_resnet_blockq_in_jax_order_matches_jax`).
  Such a flip moves one weight by ``lr * quantum``, which moves the next
  step's gradients of its whole row and column by more than float32
  noise, so flips cascade: after 6 steps 165 of the MLP's 101,770
  elements lie outside the tolerance (one flipped code after step 1, 4
  elements after step 2).  The blockq comparisons against JAX therefore
  run 2 steps;
* LeNet (conv layers): the models' tolerance, ``rtol=2e-4, atol=2e-5``
  (`test_torch_models.py`), with the same blockq allowance; its weights
  come from the JAX CLI's ``--steps 0 --save`` file, carried across by
  the JAX checkpoint reader, `utils.interop.state_from_jax` and the
  port's `save_optimizer`;
* a run's own resume, preemption and rollback against its straight run:
  bitwise.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from pytorch_ps_mpi_tpu import train as jtrain
from pytorch_ps_mpi_tpu.utils import checkpoint as jckpt
from pytorch_ps_mpi_tpu_torch import SGD, PSRuntimeError
from pytorch_ps_mpi_tpu_torch import models as tmodels
from pytorch_ps_mpi_tpu_torch import train as ttrain
from pytorch_ps_mpi_tpu_torch.utils import checkpoint as tckpt
from pytorch_ps_mpi_tpu_torch.utils.interop import (params_from_jax,
                                                    state_from_jax)

from torch_dist_helpers import run_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MLP = ["--model", "mlp", "--steps", "6", "--batch-size", "64",
       "--n-examples", "256"]
MLP_TOL = dict(rtol=1e-5, atol=1e-6)
CONV_TOL = dict(rtol=2e-4, atol=2e-5)
FLIPS = 1e-4


def jax_cli(argv, world=1):
    return jtrain.main(list(argv) + ["--n-devices", str(world)])


def port_cli(argv):
    return ttrain.main(list(argv) + ["--force-cpu-devices", "1"])


def _np(tree):
    return {n: np.asarray(torch.as_tensor(p).float()) if torch.is_tensor(p)
            else np.asarray(p) for n, p in tree.items()}


def assert_params_close(got, want, tol, flips=0.0):
    """``got`` (port) against ``want`` (the port's names and layouts);
    ``flips``: the share of elements allowed outside ``tol``."""
    got, want = _np(got), _np(want)
    assert set(got) == set(want)
    if flips:
        outside = sum(int((~np.isclose(got[n], want[n], **tol)).sum())
                      for n in want)
        total = sum(a.size for a in want.values())
        assert outside <= flips * total, (outside, total)
        for n in want:
            np.testing.assert_allclose(got[n], want[n], rtol=1e-2, atol=1e-3,
                                       err_msg=n)
    else:
        for n in want:
            np.testing.assert_allclose(got[n], want[n], err_msg=n, **tol)


def assert_params_equal(a, b):
    a, b = _np(a), _np(b)
    assert set(a) == set(b)
    for n in a:
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)


@pytest.mark.parametrize("extra", [
    [],
    ["--codec", "blockq"],
    ["--zero"],
    ["--lr", "0.05", "--lr-schedule", "cosine", "--warmup-steps", "2"],
    ["--lr", "0.05", "--lr-schedule", "linear-warmup"],
    ["--lr", "0.05", "--lr-schedule", "step"],
    ["--accum-steps", "2", "--clip-norm", "1.0"],
    ["--sync-mode", "overlap", "--skip-nonfinite"],
], ids=["identity", "blockq", "zero", "cosine", "linear-warmup", "step",
        "accum-clip", "overlap"])
def test_cli_mlp_matches_jax(extra):
    steps = "2" if "blockq" in extra else "6"  # see the module docstring
    argv = MLP[:2] + ["--steps", steps] + MLP[4:] + extra
    jopt = jax_cli(argv)
    topt = port_cli(argv)
    assert len(topt.timings) == len(jopt.timings) == int(steps)
    assert callable(topt.hyper["lr"]) == callable(jopt.hyper["lr"])
    assert topt.zero == jopt.zero and topt.sync_mode == jopt.sync_mode
    assert_params_close(topt.params, jopt.params, MLP_TOL,
                        flips=FLIPS if "blockq" in extra else 0.0)


def test_cli_lenet_blockq_from_shared_weights_matches_jax(tmp_path):
    base = ["--model", "lenet", "--codec", "blockq", "--batch-size", "32",
            "--n-examples", "128"]
    jpath, tpath = str(tmp_path / "j.psz"), str(tmp_path / "t.psz")
    jax_cli(base + ["--steps", "0", "--save", jpath])
    arrays, meta = jckpt.load(jpath, with_meta=True)
    sd = state_from_jax({**meta["state_dict_meta"], **arrays})
    params, _ = tmodels.build_model(tmodels.LeNet5())
    carrier = SGD(list(params.items()), lr=0.01, momentum=0.9,
                  code="blockq", device="cpu")
    carrier.load_state_dict(sd)
    tckpt.save_optimizer(tpath, carrier, step=meta["step"],
                         extra=meta["extra"])
    jopt = jax_cli(base + ["--steps", "4", "--resume", jpath])
    topt = port_cli(base + ["--steps", "4", "--resume", tpath])
    assert len(topt.timings) == len(jopt.timings) == 4
    want, _ = params_from_jax({n: np.asarray(p)
                               for n, p in jopt.params.items()})
    assert_params_close(topt.params, want, CONV_TOL, flips=FLIPS)


def test_cli_world2_matches_jax(tmp_path):
    """At world 2 (two gloo ranks, each with its half of every batch):
    the MLP with blockq against the JAX CLI on 2 devices; a replica
    corrupted by ``--chaos sdc_at_step`` found and re-broadcast as the
    JAX CLI does; and a preemption (exit 75 on every rank, the
    collective state gathered, one file written) resumed to the end,
    equal to the straight run bitwise."""
    ck = str(tmp_path / "w2.psz")
    blockq = MLP + ["--codec", "blockq"]
    blockq2 = MLP[:2] + ["--steps", "2"] + MLP[4:] + ["--codec", "blockq"]
    sdc = MLP + ["--steps", "8", "--sdc-check-every", "2", "--sdc-policy",
                 "rebroadcast", "--chaos",
                 json.dumps({"sdc_at_step": 4, "sdc_rank": 1})]
    runs = {
        "blockq2": blockq2,
        "sdc": sdc,
        "straight": blockq,
        "preempt": blockq + ["--save", ck, "--save-every", "2", "--chaos",
                             json.dumps({"preempt_at_step": 3})],
        "resume": blockq + ["--resume", ck],
    }
    runs = {k: v + ["--force-cpu-devices", "2"] for k, v in runs.items()}
    ranks = run_world("cli_runs", 2, tmp_path, runs, timeout=240)
    for r in ranks:
        assert r["preempt"] == {"exit": 75}
        assert r["straight"]["exit"] is None and r["resume"]["exit"] is None
    for name in ("blockq2", "sdc", "straight", "resume"):
        assert_params_equal(ranks[1][name]["params"],
                            ranks[0][name]["params"])
    assert_params_equal(ranks[0]["resume"]["params"],
                        ranks[0]["straight"]["params"])
    assert os.path.exists(tckpt.step_path(ck, 4))
    assert not tckpt.is_resumable(tckpt.step_path(ck, 4))  # consumed

    jopt = jax_cli(blockq2, world=2)
    assert_params_close(ranks[0]["blockq2"]["params"], jopt.params, MLP_TOL,
                        flips=FLIPS)
    jsdc = jax_cli(sdc, world=2)
    fs, jfs = ranks[0]["sdc"]["fault_stats"], jsdc.fault_stats
    for key in ("sdc_checks", "sdc_mismatches", "sdc_rebroadcasts",
                "sdc_first_leaf"):
        assert fs[key] == jfs[key], key
    assert fs["sdc_mismatches"] == 1
    assert [e["step"] for e in fs["sdc_events"]] == \
        [e["step"] for e in jfs["sdc_events"]]
    assert_params_close(ranks[0]["sdc"]["params"], jsdc.params, MLP_TOL)


def test_cli_save_resume_and_line_formats(tmp_path, capsys):
    """--save then --resume at the same --steps trains no further step
    and keeps the params (the JAX `test_cli_save_resume`); a resume from
    step 4 to 8 replays the loader's stream and equals the straight run
    bitwise; stderr has the JAX CLI's lines."""
    ck = str(tmp_path / "cli.psz")
    a = port_cli(MLP[:2] + ["--steps", "4"] + MLP[4:] + ["--save", ck])
    b = port_cli(MLP[:2] + ["--steps", "4"] + MLP[4:] + ["--resume", ck])
    assert len(b.timings) == 0
    assert_params_equal(a.params, b.params)
    ref = port_cli(MLP[:2] + ["--steps", "8"] + MLP[4:])
    c = port_cli(MLP[:2] + ["--steps", "8"] + MLP[4:] + ["--resume", ck])
    assert len(c.timings) == 4
    assert_params_equal(c.params, ref.params)
    err = capsys.readouterr().err
    assert "mesh: 1 x cpu" in err
    assert re.search(r"^step     1  loss \d+\.\d{4}  comm_wait \d+\.\d{2}ms$",
                     err, re.M)
    assert re.search(r"^done: 4 steps, [\d.]+ images/sec \([\d.]+/device\)$",
                     err, re.M)
    assert f"checkpoint -> {ck} (step 4)" in err
    assert f"resumed from {ck} at step 4" in err


def test_cli_eval_every_with_ema_matches_jax(capsys):
    argv = ["--model", "mlp", "--eval-every", "3", "--steps", "7",
            "--ema-decay", "0.9", "--batch-size", "16", "--n-examples", "64",
            "--eval-examples", "64"]
    jax_cli(argv)
    jlines = [ln for ln in capsys.readouterr().err.splitlines()
              if "eval @" in ln]
    opt = port_cli(argv)
    lines = [ln for ln in capsys.readouterr().err.splitlines()
             if "eval @" in ln]
    assert opt.ema_params is not None
    assert lines == jlines
    assert [ln.split(":")[0] for ln in lines] == [
        "eval @ step 3", "eval @ step 6", "final eval @ step 7"]
    assert all("(ema, n=64)" in ln for ln in lines)


def test_cli_preempt_exits_75_and_resumes_bitwise(tmp_path):
    """--chaos preempt_at_step raises a real SIGTERM; the loop finishes
    the step, writes a RESUMABLE step-tagged checkpoint (ZeRO raw shards)
    and exits 75; --resume picks it up, consumes the marker and ends
    where the straight run ends."""
    ck = str(tmp_path / "pre.psz")
    argv = MLP + ["--zero", "--codec", "blockq"]
    with pytest.raises(SystemExit) as exc:
        port_cli(argv + ["--save", ck, "--save-every", "2", "--chaos",
                         json.dumps({"preempt_at_step": 3})])
    assert exc.value.code == ttrain.PREEMPTED_EXIT_CODE == 75
    assert not os.path.exists(ck)  # no final save: the run was preempted
    latest = tckpt.latest_checkpoint(ck)
    assert latest == tckpt.step_path(ck, 4)
    assert tckpt.is_resumable(latest)
    assert tckpt.load(latest, with_meta=True)[1]["step"] == 4
    resumed = port_cli(argv + ["--save", ck, "--resume", ck])
    assert len(resumed.timings) == 2
    assert not tckpt.is_resumable(latest)
    assert tckpt.load(ck, with_meta=True)[1]["step"] == 6
    assert_params_equal(resumed.params, port_cli(argv).params)


def test_cli_guard_rolls_back_on_spike_like_jax(tmp_path):
    """A loss spike injected after the guard's 8-loss history trips the
    median+MAD guard; the run restores the last good checkpoint with its
    loader position, halves lr and completes — the JAX CLI's events, lr
    and (within tolerance) params."""
    plan = json.dumps({"spike_at_step": 9, "spike_scale": 1e6})
    outs = []
    for tag, cli in (("j", jax_cli), ("t", port_cli)):
        ck = str(tmp_path / f"{tag}.psz")
        outs.append((cli(MLP[:2] + ["--steps", "14"] + MLP[4:] + [
            "--save", ck, "--save-every", "2", "--guard-spike-mad", "8",
            "--guard-window", "16", "--rollback-lr-scale", "0.5",
            "--chaos", plan]), ck))
    (jopt, jck), (topt, tck) = outs
    events = topt.fault_stats["rollbacks"]
    assert [(e["step"], e["reason"], e["restored_step"]) for e in events] \
        == [(e["step"], e["reason"], e["restored_step"])
            for e in jopt.fault_stats["rollbacks"]] == [(10, "spike", 8)]
    assert topt.hyper["lr"] == jopt.hyper["lr"] == pytest.approx(0.005)
    assert tckpt.load(tck, with_meta=True)[1]["step"] == 14
    assert_params_close(topt.params, jopt.params, MLP_TOL)


def test_cli_transformer_lm_resumes_bitwise(tmp_path, capsys):
    """The CLI's LM (4 layers, d_model 256, flash attention's plain
    versions on the CPU) at --seq-len 32: losses finite, the tokens/sec
    line, and a resume that replays the index draws equals the straight
    run bitwise."""
    ck = str(tmp_path / "lm.psz")
    lm = ["--model", "transformer", "--attn", "flash", "--seq-len", "32",
          "--vocab", "64", "--batch-size", "4", "--n-examples", "16"]
    ref = port_cli(lm + ["--steps", "3"])
    port_cli(lm + ["--steps", "2", "--save", ck])
    res = port_cli(lm + ["--steps", "3", "--resume", ck])
    assert len(res.timings) == 1
    assert_params_equal(res.params, ref.params)
    err = capsys.readouterr().err
    assert "mesh: dp=1 sp=1 tp=1 pp=1 ep=1 x cpu" in err
    assert re.search(r"^done: 3 steps, [\d,]+ tokens/sec", err, re.M)


# (id, argv, what the refusal starts with).  Every role of the JAX CLI is
# ported: each case holds a misplaced flag refused in the JAX CLI's
# words.  Since the hierarchy is ported, the "--serve" and "--connect"
# cases hold the hierarchy's (``--aggregators`` without a group size;
# ``--fallback`` with two aggregator endpoints); since the multi-rank LM
# paths are, the sp/tp/pp/ep cases hold their compositions' (``--attn
# flash`` with the ring, a sequence that does not split over ``--sp``,
# ``--pp`` with MoE blocks, ``--ep`` without experts, experts that do not
# split over ``--ep``).  The JAX CLI runs on 2 devices: on 1 it refuses
# ``--sp 2`` for its device count first.
UNPORTED = [
    ("--serve", ["--serve", "0", "--aggregators", "2"],
     "--aggregators needs --group-size N"),
    ("--connect", ["--connect", "h:1,h:3", "--fallback", "h:2"],
     "--fallback needs --connect to name ONE aggregator endpoint"),
    ("--sp 2", ["--model", "transformer", "--sp", "2", "--attn", "flash"],
     "--attn flash composes with dp/tp/ep or with --sp-attn ulysses"),
    ("--tp 2", ["--model", "transformer", "--tp", "2", "--sp", "3",
                "--seq-len", "32"], "--seq-len 32 must divide by --sp 3"),
    ("--pp 2", ["--model", "transformer", "--pp", "2", "--moe-experts",
                "4"], "--pp composes with dp and --tp only"),
    ("--ep 2", ["--model", "transformer", "--ep", "2"],
     "--ep needs --moe-experts"),
    ("--moe-experts", ["--model", "transformer", "--moe-experts", "4",
                       "--ep", "3"], "--moe-experts 4 must divide by --ep 3"),
]


@pytest.mark.parametrize("argv,flag", [u[1:] for u in UNPORTED],
                         ids=[u[0] for u in UNPORTED])
def test_cli_refuses_unported_roles_by_name(argv, flag):
    with pytest.raises(SystemExit) as e:
        port_cli(argv + ["--steps", "1"])
    with pytest.raises(SystemExit) as j:
        jax_cli(argv + ["--steps", "1"], world=2)
    assert str(e.value) == str(j.value)
    assert str(e.value).startswith(flag)


SYNC_REFUSALS = [
    ["--chaos", json.dumps({"kill_ps_at": 3})],
    ["--chaos", json.dumps({"preempt_at_step": 1, "drop_every": 2})],
    ["--guard-spike-mad", "5"],
    ["--model", "transformer", "--guard-spike-mad", "5", "--save", "x"],
    ["--model", "transformer", "--eval-every", "2"],
    ["--staleness-weighting"],
    ["--infer-serve"],
    ["--read-window", "2"],
    ["--wire-codec", "bf16"],
    ["--delta-parm"],
    ["--model", "transformer", "--dataset", "cifar10"],
    ["--dataset", "lm"],
    ["--shards", "2"],
    ["--partition-rules", "[]"],
    ["--replicas", "1"],
    ["--snapshot-every", "2"],
    ["--aggregators", "2"],
    ["--group-quorum", "1"],
    ["--fallback", "h:1"],
    ["--group", "1"],
    ["--adaptive-deadline"],
    ["--latency-weighting"],
    ["--max-staleness", "2"],
    ["--credit-window", "4"],
    ["--op-deadline", "1.0"],
    ["--async-bucket-bytes", "0"],
    ["--fused-encode"],
    ["--quorum", "2"],
    ["--checkpoint-every", "2"],
    ["--pp-microbatches", "2"],
    ["--sp-attn", "ulysses"],
]


def test_cli_sync_refusals_match_jax():
    """Every flag that would be inert on the sync trainer is refused with
    the JAX CLI's message."""
    for argv in SYNC_REFUSALS:
        msgs = []
        for cli in (jax_cli, port_cli):
            with pytest.raises(SystemExit) as e:
                cli(["--steps", "1"] + argv)
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0], argv
        assert "not ported" not in msgs[1]


def test_cli_device_selection():
    """No card and no --force-cpu-devices: the port's "no CUDA device"
    error, no fall back to the CPU; --force-cpu-devices and --n-devices
    must name the world the CLI was launched with."""
    if not torch.cuda.is_available():
        with pytest.raises(PSRuntimeError, match="no CUDA device"):
            ttrain.main(["--model", "mlp", "--steps", "1"])
    with pytest.raises(SystemExit, match="must equal the world"):
        ttrain.main(["--model", "mlp", "--steps", "1",
                     "--force-cpu-devices", "2"])
    with pytest.raises(SystemExit, match="--n-devices 2"):
        port_cli(["--model", "mlp", "--steps", "1", "--n-devices", "2"])


def test_cli_help_has_every_jax_flag(capsys):
    with pytest.raises(SystemExit):
        jtrain.main(["--help"])
    usage = capsys.readouterr().out.split("\n\n")[0]
    jflags = set(re.findall(r"(?<![\w-])--[a-z][a-z0-9-]*", usage))
    tflags = {s for a in ttrain.make_parser()._actions
              for s in a.option_strings}
    assert len(jflags) > 90
    assert tflags - {"-h", "--help"} == jflags


def test_cli_module_entry_runs_on_the_cpu():
    """``python -m pytorch_ps_mpi_tpu_torch.train --force-cpu-devices 1
    --model mlp --steps 5``: the JAX CLI's lines, exit 0, and the process
    group left cleanly on the way out."""
    out = subprocess.run(
        [sys.executable, "-m", "pytorch_ps_mpi_tpu_torch.train",
         "--force-cpu-devices", "1", "--model", "mlp", "--steps", "5",
         "--n-examples", "256", "--summary"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "step     1  loss" in out.stderr
    assert "done: 5 steps" in out.stderr
    assert "terminate called" not in out.stderr
    assert "comm_wait" in out.stdout  # --summary


def test_cli_trace_dir_writes_a_chrome_trace(tmp_path):
    """--trace-dir records the run with torch.profiler and writes a Chrome
    trace into the directory."""
    port_cli(["--model", "mlp", "--steps", "2", "--batch-size", "64",
              "--n-examples", "128", "--trace-dir", str(tmp_path)])
    traces = list(tmp_path.glob("trace-*.json"))
    assert len(traces) == 1
    trace = json.loads(traces[0].read_text())
    assert trace["traceEvents"]


def test_cli_under_torchrun_matches_jax(tmp_path):
    """``torchrun --nproc-per-node 2`` (standalone, on this host): the CLI
    joins the group from torchrun's environment, rank 0 alone prints and
    writes the checkpoint, and the params equal the JAX CLI's on 2
    devices."""
    ck = str(tmp_path / "tr.psz")
    argv = MLP[:2] + ["--steps", "4"] + MLP[4:]
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "pytorch_ps_mpi_tpu_torch.train",
         "--force-cpu-devices", "2", "--save", ck, *argv],
        cwd=REPO, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stderr.count("mesh: 2 x cpu") == 1
    assert out.stderr.count(f"checkpoint -> {ck} (step 4)") == 1
    params = tckpt.load(ck)["params"]
    assert_params_close(params, jax_cli(argv, world=2).params, MLP_TOL)


# ---------------------------------------------------------------------------
# --async-ps: the in-process async PS
# ---------------------------------------------------------------------------


def test_cli_async_ps_mlp_lines_save_and_resume(tmp_path, capsys):
    """``--async-ps --force-cpu-devices 3`` (a PS and 2 workers, quota 2)
    on the MLP: the JAX CLI's ``async PS:`` and ``done:`` lines (JAX on 3
    CPU devices), a falling loss, and ``--save`` then ``--resume`` from
    the saved update (the run draws fresh batches: seed + step)."""
    ck = str(tmp_path / "async.psz")

    def async_mlp(steps):
        return (MLP[:2] + ["--steps", str(steps)] + MLP[4:]
                + ["--async-ps", "--lr", "0.05"])

    argv = async_mlp(8)
    jtrain.main(argv + ["--n-devices", "3"])
    jerr = capsys.readouterr().err
    topt = ttrain.main(argv + ["--force-cpu-devices", "3", "--save", ck])
    err = capsys.readouterr().err
    for text in (jerr, err):
        assert "async PS: 2 workers, quota 2" in text
        assert re.search(r"^done: 8 updates, 16 grads, [\d.]+ images/sec, "
                         r"mean staleness \d+\.\d{2}$", text, re.M)
    assert f"checkpoint -> {ck} (step 8)" in err
    assert len(topt.timings) == 8
    assert tckpt.load(ck, with_meta=True)[1]["step"] == 8
    saved = tckpt.load(ck)["params"]
    res = ttrain.main(async_mlp(10) + ["--force-cpu-devices", "3",
                                       "--resume", ck])
    err = capsys.readouterr().err
    assert f"resumed from {ck} at step 8" in err
    assert "done: 2 updates, 4 grads" in err
    assert len(res.timings) == 2
    assert int(res.state["dense0/kernel"]["step"]) == 10
    assert not all(np.array_equal(_np(res.params)[n], saved[n])
                   for n in saved)
    nothing = ttrain.main(argv + ["--force-cpu-devices", "3", "--resume",
                                  ck])
    assert len(nothing.timings) == 0
    assert "nothing to do" in capsys.readouterr().err


def test_cli_async_ps_flash_lm_runs_on_the_cpu(capsys):
    """The async LM path (`_build_lm_async`, `--attn flash`, the plain
    flash versions on the CPU) with blockq: finite losses, every update
    consumed."""
    opt = ttrain.main(["--async-ps", "--model", "transformer", "--attn",
                       "flash", "--codec", "blockq", "--seq-len", "16",
                       "--vocab", "32", "--batch-size", "2", "--n-examples",
                       "8", "--steps", "3", "--force-cpu-devices", "2"])
    err = capsys.readouterr().err
    assert "async PS: 1 workers, quota 1" in err
    assert "done: 3 updates, 3 grads" in err
    assert all(torch.isfinite(p).all() for p in opt.params.values())


def test_cli_async_ps_runs_on_the_card_or_raises():
    """``--async-ps`` takes the visible cards (the first ``--n-devices``)
    and, with none, raises the port's "no CUDA device" error: no fall
    back to the CPU."""
    for extra in ([], ["--n-devices", "2"]):
        argv = ["--async-ps", "--model", "mlp", "--steps", "1"] + extra
        if torch.cuda.is_available():
            assert ttrain.main(argv).ps_device.type == "cuda"
            continue
        with pytest.raises(PSRuntimeError, match="no CUDA device"):
            ttrain.main(argv)


ASYNC_REFUSALS = [
    ["--model", "resnet18", "--dataset", "cifar10"],
    ["--save", "x.psz", "--save-every", "2"],
    ["--zero"],
    ["--sdc-check-every", "2"],
    ["--eval-every", "2"],
    ["--guard-spike-mad", "5"],
    ["--clip-norm", "1.0"],
    ["--accum-steps", "2"],
    ["--ema-decay", "0.9"],
    ["--sync-mode", "overlap"],
    ["--trim-k", "1"],
    ["--fill-deadline", "0.1"],
    ["--adaptive-deadline"],
    ["--credit-window", "-1"],
    ["--op-deadline", "1.0"],
    ["--async-bucket-bytes", "0"],
    ["--fused-encode"],
    ["--checkpoint-every", "2"],
    ["--shards", "2"],
    ["--partition-rules", "[]"],
    ["--replicas", "1"],
    ["--snapshot-every", "2"],
    ["--aggregators", "2"],
    ["--group-quorum", "1"],
    ["--fallback", "h:1"],
    ["--group", "1"],
    ["--infer-serve"],
    ["--read-window", "2"],
    ["--wire-codec", "bf16"],
    ["--delta-parm"],
    ["--model", "transformer", "--dataset", "cifar10"],
    ["--dataset", "lm"],
    ["--pp-microbatches", "2"],
    ["--sp-attn", "ulysses"],
    # The async roles run the LM dense per worker.
    ["--model", "transformer", "--tp", "2"],
    ["--model", "transformer", "--sp", "2"],
    ["--model", "transformer", "--pp", "2"],
    ["--model", "transformer", "--moe-experts", "4", "--ep", "2"],
    ["--chaos", json.dumps({"kill_shard_at": {"0": 1}})],
    ["--chaos", json.dumps({"partition_links": [[0, 0, 0, 1]]})],
    ["--chaos", json.dumps({"byzantine_agg": 0})],
]


def test_cli_async_refusals_match_jax():
    """Every flag that would be inert on the in-process async PS (or that
    names a role not ported yet) is refused on ``--async-ps`` with the
    JAX CLI's message; a model with BatchNorm statistics and
    ``--save-every`` too."""
    for argv in ASYNC_REFUSALS:
        msgs = []
        for cli in (jax_cli, port_cli):
            with pytest.raises(SystemExit) as e:
                cli(["--steps", "1", "--async-ps"] + argv)
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0], argv
        assert "not ported" not in msgs[1]
