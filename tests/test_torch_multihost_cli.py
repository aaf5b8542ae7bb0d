"""The training CLI's multihost roles, ``--serve`` and ``--connect``, on
the CPU (``--force-cpu-devices 1``).

A server process prints ``serving on port N`` on stdout (read from its
first line) and worker processes connect to it; they print the JAX CLI's
lines.  ``--save`` with ``--checkpoint-every`` and then ``--resume``
continue the served version.  The hierarchy's flags are taken on their
roles (the CLI run itself is in tests/test_torch_hierarchy_cli.py); the
multihost refusals carry the JAX CLI's messages.  Every process has a timeout of at most 60 s, its
stderr goes to a file, and its stdout is drained by ``communicate``.
"""

import json
import os
import re
import socket
import sys

import pytest
from procs import first_line, reap, spawn, stderr_of

from pytorch_ps_mpi_tpu import train as jtrain
from pytorch_ps_mpi_tpu_torch import train as ttrain
from pytorch_ps_mpi_tpu_torch.native import serializer as tser

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 60
CPU = ["--force-cpu-devices", "1"]
# Two intra-op threads a process: a server and its workers share the
# host's cores, and torch's default (every core each) oversubscribes them.
ENV = {**os.environ, "OMP_NUM_THREADS": "2"}
MLP = ["--model", "mlp", "--n-examples", "256", "--batch-size", "32"]
LM = ["--model", "transformer", "--attn", "flash", "--codec", "blockq",
      "--seq-len", "16", "--vocab", "31", "--batch-size", "2",
      "--n-examples", "8"]
DONE = re.compile(r"^done: (\d+) updates, (\d+) grads, ([\d.]+) images/sec, "
                  r"mean staleness ([\d.]+)$", re.M)


def _cli(argv):
    return spawn([sys.executable, "-m", "pytorch_ps_mpi_tpu_torch.train",
                  *argv, *CPU], cwd=REPO, env=ENV)


def _run(server_argv, worker_argv, workers):
    """One server and ``workers`` worker processes to completion:
    ``(server result, [worker results], port)``."""
    srv = _cli(server_argv + ["--serve", "0"])
    ws = []
    try:
        line = first_line(srv, "serving on port ", TIMEOUT)
        m = re.match(r"serving on port (\d+)$", line)
        assert m, f"no port line: {line!r}\n{stderr_of(srv)}"
        port = int(m.group(1))
        # A worker whose push races the server's exit redials: two
        # attempts, not the CLI's 30.
        ws = [_cli(worker_argv + ["--connect", f"127.0.0.1:{port}",
                                  "--reconnect-retries", "2"])
              for _ in range(workers)]
    finally:
        wres = reap(ws, TIMEOUT)
        sres, = reap([srv], TIMEOUT)
    return sres, wres, port


def _check_worker_lines(wres, port):
    ranks = []
    for rc, out, err in wres:
        assert rc == 0, err
        m = re.search(rf"^worker rank (\d+) connected to 127.0.0.1:{port}$",
                      err, re.M)
        assert m, err
        r = int(m.group(1))
        assert re.search(rf"^worker rank {r} done: \d+ gradients pushed$",
                         err, re.M), err
        ranks.append(r)
    assert len(set(ranks)) == len(wres)


# The server consumes a gradient every half second at most, so the run
# outlasts the second worker's start (a fast worker alone would fill every
# quota before it connects).
SLOW_PS = ["--chaos", json.dumps({"slow_consumer": 0.5})]


@pytest.mark.parametrize("model", ["mlp", "lm"])
def test_serve_and_connect_print_the_jax_lines(model):
    argv = MLP if model == "mlp" else LM
    steps = 6 if model == "mlp" else 4
    (rc, out, err), wres, port = _run(
        argv + ["--quota", "2", "--steps", str(steps)] + SLOW_PS, argv, 2)
    assert rc == 0, err
    m = DONE.search(err)
    assert m, err
    assert int(m.group(1)) == steps and int(m.group(2)) == 2 * steps
    assert float(m.group(3)) > 0
    _check_worker_lines(wres, port)


def _extra(path):
    with open(path, "rb") as f:
        _, meta = tser.loads(f.read(), with_meta=True)
    return meta["step"], meta["extra"]


def test_save_checkpoint_every_then_resume_continues_the_version(tmp_path):
    ck, ck2 = str(tmp_path / "ps.psz"), str(tmp_path / "ps2.psz")
    (rc, _, err), wres, port = _run(
        MLP + ["--steps", "4", "--save", ck, "--checkpoint-every", "2"],
        MLP, 1)
    assert rc == 0, err
    _check_worker_lines(wres, port)
    step, extra = _extra(ck)
    assert step == 4 and extra["served_version"] == 4
    (rc, _, err), wres, port = _run(
        MLP + ["--steps", "6", "--resume", ck, "--save", ck2], MLP, 1)
    assert rc == 0, err
    assert f"resumed from {ck} at step 4" in err
    assert DONE.search(err).group(1) == "2"
    _check_worker_lines(wres, port)
    step, extra = _extra(ck2)
    assert step == 6 and extra["served_version"] == 6
    assert extra["next_rank"] >= 2  # the rank allocation carried over


# The hierarchy's flags on the roles that once refused them by name (the
# ids are kept): ``--aggregators`` without ``--group-size`` is refused in
# the JAX CLI's words, and ``--fallback`` on a worker or a reader gets
# past every refusal to the dial, here at a port that does not listen
# (the JAX CLI's reader takes it too).
STILL_UNPORTED = [
    (["--serve", "0", "--aggregators", "2"], "--aggregators"),
    (["--connect", "h:1", "--fallback", "h:2"], "--fallback"),
    (["--subscribe", "h:1", "--fallback", "h:2"], "--fallback"),
]


@pytest.mark.parametrize("argv,flag", STILL_UNPORTED,
                         ids=[" ".join(a) for a, _ in STILL_UNPORTED])
def test_unported_multihost_flags_are_refused_by_name(argv, flag):
    if flag == "--aggregators":
        msgs = []
        for run in (lambda a: jtrain.main(a + ["--n-devices", "1"]),
                    lambda a: ttrain.main(a + CPU)):
            with pytest.raises(SystemExit) as e:
                run(argv + ["--steps", "1"])
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0]
        assert msgs[1].startswith("--aggregators needs --group-size N")
        return
    with socket.socket() as closed:
        closed.bind(("127.0.0.1", 0))
        port = closed.getsockname()[1]
        local = [a.replace("h:", "127.0.0.1:").replace(
            "127.0.0.1:1", f"127.0.0.1:{port}") for a in argv]
        with pytest.raises(ConnectionRefusedError):
            ttrain.main(local + ["--steps", "1"] + CPU)


def test_op_deadline_is_refused_on_serve_and_taken_on_connect():
    """The PS spends ``--op-deadline`` on its REPL round trips (replication
    is ported): a non-positive budget is refused on ``--serve`` with the
    JAX CLI's message, a positive one taken by the server, as a worker's
    pulls run under it."""
    msgs = []
    for run in (lambda a: jtrain.main(a + ["--n-devices", "1"]),
                lambda a: ttrain.main(a + CPU)):
        with pytest.raises(SystemExit) as e:
            run(["--serve", "0", "--op-deadline", "0", "--steps", "1"])
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0] == "--op-deadline must be > 0, got 0.0"
    srv = ttrain.main(["--serve", "0", "--op-deadline", "1.0", "--steps",
                       "0"] + CPU)
    assert srv.op_deadline == 1.0
    # A worker takes the flag: it gets past every refusal to the dial,
    # here at a bound port that does not listen.
    with socket.socket() as closed:
        closed.bind(("127.0.0.1", 0))
        with pytest.raises(ConnectionRefusedError):
            ttrain.main(["--connect", f"127.0.0.1:{closed.getsockname()[1]}",
                         "--op-deadline", "1.0", "--steps", "1"] + CPU)


MULTIHOST_REFUSALS = [
    ["--serve", "0", "--connect", "h:1"],
    ["--connect", "h:1", "--quorum", "2"],
    ["--connect", "h:1", "--skip-nonfinite"],
    ["--connect", "h:1", "--wire-codec", "bf16"],
    ["--connect", "h:1", "--checkpoint-every", "2"],
    ["--connect", "h:1", "--adaptive-deadline", "--quorum", "1"],
    ["--connect", "h:1", "--latency-weighting"],
    ["--serve", "0", "--checkpoint-every", "2"],
    ["--serve", "0", "--chaos", json.dumps({"flood_rank": 0})],
    ["--connect", "h:1", "--chaos", json.dumps({"slow_consumer": 0.1})],
    ["--serve", "0", "--chaos", json.dumps({"kill_shard_at": {"0": 1}})],
    ["--serve", "0", "--zero"],
    ["--serve", "0", "--sdc-check-every", "2"],
    ["--connect", "h:1", "--fused-encode"],
    ["--serve", "0", "--model", "transformer", "--dataset", "cifar10"],
]


@pytest.mark.parametrize("argv", MULTIHOST_REFUSALS,
                         ids=[" ".join(a) for a in MULTIHOST_REFUSALS])
def test_multihost_refusals_match_jax(argv):
    msgs = []
    for run in (lambda a: jtrain.main(a + ["--n-devices", "1"]),
                lambda a: ttrain.main(a + CPU)):
        with pytest.raises(SystemExit) as e:
            run(argv + ["--steps", "1"])
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]
    assert "not ported" not in msgs[1]
