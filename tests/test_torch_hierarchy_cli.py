"""The training CLI's hierarchy (``--serve --aggregators G --group-size
N``, ``--connect AGG --group g --fallback ROOT``) on the CPU
(``--force-cpu-devices 1``).

* Misplaced hierarchy flags are refused in the JAX CLI's words
  (``tests/test_hierarchy.py:730``), each case against the JAX CLI's own
  message.
* A root with two aggregators (a single PS, and a 2-shard fleet) and two
  failover-capable group workers, as processes: the server prints
  ``serving on port(s) ...`` and ``aggregators on ports ...`` on stdout,
  the JAX CLI's ``done:`` lines on stderr.

Every process has a timeout of at most 60 s, its stderr goes to a file,
and its stdout is drained by ``communicate``.
"""

import os
import re
import sys

import pytest
from procs import first_line, reap, spawn

from pytorch_ps_mpi_tpu import train as jtrain
from pytorch_ps_mpi_tpu_torch import train as ttrain
from pytorch_ps_mpi_tpu_torch.utils.faults import FaultPlan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 60
CPU = ["--force-cpu-devices", "1"]
ENV = {**os.environ, "OMP_NUM_THREADS": "2"}
MLP = ["--model", "mlp", "--n-examples", "256", "--batch-size", "32"]
CHAOS = FaultPlan(kill_agg_at={0: 3}).to_json()

# (id, argv, a piece of the JAX CLI's message).
REFUSALS = [
    ("aggregators-without-serve",
     ["--model", "mlp", "--aggregators", "2", "--group-size", "2"],
     "--serve"),
    ("aggregators-without-group-size",
     ["--model", "mlp", "--serve", "0", "--aggregators", "2"],
     "--group-size"),
    ("group-quorum-without-aggregators",
     ["--model", "mlp", "--serve", "0", "--group-quorum", "2"],
     "GROUP level"),
    ("group-deadline-without-group-quorum",
     ["--model", "mlp", "--serve", "0", "--aggregators", "2",
      "--group-size", "2", "--group-fill-deadline", "0.1"],
     "--group-quorum"),
    ("fallback-on-serve",
     ["--model", "mlp", "--serve", "0", "--fallback", "127.0.0.1:1"],
     "--fallback"),
    ("fallback-with-two-aggregators",
     ["--model", "mlp", "--connect", "127.0.0.1:1,127.0.0.1:2",
      "--fallback", "127.0.0.1:3"],
     "ONE aggregator endpoint"),
    ("group-without-fallback",
     ["--model", "mlp", "--connect", "127.0.0.1:1", "--group", "1"],
     "--group tags"),
    ("adaptive-deadline-without-quorum",
     ["--model", "mlp", "--serve", "0", "--adaptive-deadline"], "QUORUM"),
    ("adaptive-deadline-on-sync",
     ["--model", "mlp", "--adaptive-deadline"], "adaptive-deadline"),
    ("latency-weighting-on-sync",
     ["--model", "mlp", "--latency-weighting"], "latency-weighting"),
    ("latency-weighting-on-connect",
     ["--model", "mlp", "--connect", "127.0.0.1:1", "--latency-weighting"],
     "PS-side"),
    ("agg-chaos-on-serve", ["--model", "mlp", "--chaos", CHAOS,
                            "--serve", "0"], "kill_agg_at"),
    ("agg-chaos-on-connect", ["--model", "mlp", "--chaos", CHAOS,
                              "--connect", "127.0.0.1:1"], "kill_agg_at"),
    ("agg-chaos-on-async-ps", ["--model", "mlp", "--chaos", CHAOS,
                               "--async-ps"], "kill_agg_at"),
    ("bucket-stream-with-fallback",
     ["--model", "mlp", "--connect", "127.0.0.1:1", "--async-bucket-bytes",
      "0", "--fallback", "127.0.0.1:2"], "hierarchy failover worker"),
]


@pytest.mark.parametrize("argv,piece", [r[1:] for r in REFUSALS],
                         ids=[r[0] for r in REFUSALS])
def test_cli_refuses_misplaced_hierarchy_flags(argv, piece):
    msgs = []
    for run in (lambda a: jtrain.main(a + ["--n-devices", "1"]),
                lambda a: ttrain.main(a + CPU)):
        with pytest.raises(SystemExit) as e:
            run(argv + ["--steps", "1"])
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]
    assert piece in msgs[1]
    assert "not ported" not in msgs[1]


def test_hierarchy_flags_reach_the_multihost_roles(monkeypatch):
    """``--chaos kill_agg_at`` with ``--group-*`` policy on ``--serve
    --aggregators``, and ``--group --fallback`` on ``--connect``, pass
    every refusal to the multihost roles (stubbed here) with the plan."""
    seen = []
    monkeypatch.setattr(ttrain, "run_multihost",
                        lambda args, plan=None: seen.append((args, plan)))
    ttrain.main(["--model", "mlp", "--chaos", CHAOS, "--serve", "0",
                 "--aggregators", "2", "--group-size", "3",
                 "--group-aggregate", "trimmed_mean", "--group-quorum", "3",
                 "--group-anomaly-z", "4.0", "--adaptive-deadline",
                 "--steps", "1"] + CPU)
    ttrain.main(["--model", "mlp", "--connect", "127.0.0.1:1", "--group",
                 "1", "--fallback", "127.0.0.1:2,127.0.0.1:3",
                 "--steps", "1"] + CPU)
    (serve, plan), (connect, none) = seen
    assert plan.kill_agg_at == {0: 3} and none is None
    assert serve.aggregators == 2 and serve.group_quorum == 3
    assert ttrain._resolve_group_deadline(serve) == 0.05
    assert connect.group == 1 and connect.fallback.count(",") == 1


def _cli(argv):
    return spawn([sys.executable, "-m", "pytorch_ps_mpi_tpu_torch.train",
                  *argv, *CPU], cwd=REPO, env=ENV)


@pytest.mark.parametrize("shards", [1, 2])
def test_cli_hierarchy_trains_with_group_workers(shards):
    steps = 5
    serve = MLP + ["--serve", "0", "--aggregators", "2", "--group-size",
                   "1", "--steps", str(steps), "--codec", "blockq"]
    if shards > 1:
        serve += ["--shards", str(shards)]
    srv = _cli(serve)
    workers = []
    try:
        lines = [first_line(srv, "serving on port", TIMEOUT),
                 first_line(srv, "aggregators on ports", TIMEOUT)]
        assert len(lines) == 2, lines
        m = re.match(r"serving on ports? ([\d ]+)$", lines[0])
        assert m, lines
        roots = [int(p) for p in m.group(1).split()]
        assert len(roots) == shards
        m = re.match(r"aggregators on ports (\d+) (\d+)$", lines[1])
        assert m, lines
        aggs = [int(m.group(1)), int(m.group(2))]
        fallback = ",".join(f"127.0.0.1:{p}" for p in roots)
        for g, port in enumerate(aggs):
            workers.append(_cli(
                MLP + ["--connect", f"127.0.0.1:{port}", "--group", str(g),
                       "--fallback", fallback, "--codec", "blockq",
                       "--reconnect-retries", "2"]))
    finally:
        results = reap(workers, TIMEOUT)
        (rc, _, err), = reap([srv], TIMEOUT)
    assert rc == 0, err[-3000:]
    done = re.search(r"^done: (\d+) root updates, (\d+) group fills across "
                     r"2 aggregators in [\d.]+s$", err, re.M)
    assert done, err[-3000:]
    assert int(done.group(1)) == steps and int(done.group(2)) >= steps
    assert re.search(r"^fault stats: .*agg_frames=\d+.*groups=\['0', '1'\]",
                     err, re.M), err[-3000:]
    assert re.search(r"^aggregator tier: .*agg_forwards=", err, re.M)
    for g, (wrc, _, werr) in enumerate(results):
        assert wrc == 0, werr[-3000:]
        assert f"group {g} worker local rank 0 connected to aggregator" \
            in werr
        m = re.search(r"^group worker done: (\d+) gradients pushed$", werr,
                      re.M)
        assert m and int(m.group(1)) >= 1, werr[-3000:]
        assert "agg_failovers" not in werr
