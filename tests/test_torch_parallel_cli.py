"""The training CLI's multi-rank LM paths (``--tp``, ``--sp`` with the
ring and with Ulysses, ``--pp`` with ``--pp-microbatches``, ``--ep`` with
``--moe-experts``) against the JAX CLI on the same flags.

The port runs at world 2: two spawned gloo ranks, each the CLI
in-process with ``--force-cpu-devices 2``
(`torch_mesh_helpers.cli_mesh_runs`); the JAX CLI runs with ``--n-devices
2``.  Both start from the JAX CLI's weights: its ``--steps 0 --save``
file, carried across by the JAX checkpoint reader,
`utils.interop.state_from_jax` and the port's `save_optimizer` (the CLI's
LM draws its weights from ``--seed`` in each package's own way).  Held:
the ``mesh:`` line, the first step's loss as printed (4 decimals) and
the final parameters after 2 steps, ``rtol=1e-5, atol=1e-6`` (f32; XLA
and PyTorch sum in other orders), equal on both ranks.
"""

import re

import numpy as np
import pytest

from pytorch_ps_mpi_tpu import train as jtrain
from pytorch_ps_mpi_tpu.utils import checkpoint as jckpt
from pytorch_ps_mpi_tpu_torch import SGD
from pytorch_ps_mpi_tpu_torch.models.transformer import TransformerLM, build_lm
from pytorch_ps_mpi_tpu_torch.utils import checkpoint as tckpt
from pytorch_ps_mpi_tpu_torch.utils.interop import (params_from_jax,
                                                    state_from_jax)

from torch_dist_helpers import run_world

TOL = dict(rtol=1e-5, atol=1e-6)
LM = ["--model", "transformer", "--seq-len", "16", "--vocab", "64",
      "--batch-size", "4", "--n-examples", "16"]
# name -> (flags, MoE experts of the weights)
RUNS = {
    "tp": (["--tp", "2"], 0),
    "sp_ring": (["--sp", "2"], 0),
    "sp_ulysses": (["--sp", "2", "--sp-attn", "ulysses"], 0),
    "pp": (["--pp", "2", "--pp-microbatches", "2"], 0),
    "ep": (["--ep", "2", "--moe-experts", "4"], 4),
}
MESH = {"tp": "dp=1 sp=1 tp=2 pp=1 ep=1", "sp_ring": "dp=1 sp=2 tp=1 pp=1 "
        "ep=1", "sp_ulysses": "dp=1 sp=2 tp=1 pp=1 ep=1",
        "pp": "dp=1 sp=1 tp=1 pp=2 ep=1", "ep": "dp=1 sp=1 tp=1 pp=1 ep=2"}


def _carry(tmp, moe):
    """The JAX CLI's initial weights as a JAX and a port checkpoint."""
    extra = ["--moe-experts", str(moe)] if moe else []
    jpath, tpath = str(tmp / f"j{moe}.psz"), str(tmp / f"t{moe}.psz")
    jtrain.main(LM + extra + ["--steps", "0", "--save", jpath,
                              "--n-devices", "1"])
    arrays, meta = jckpt.load(jpath, with_meta=True)
    sd = state_from_jax({**meta["state_dict_meta"], **arrays})
    model = TransformerLM(vocab_size=64, d_model=256, n_heads=8, n_layers=4,
                          d_ff=1024, max_len=2048, moe_experts=moe)
    carrier = SGD(list(build_lm(model).items()), lr=0.01, momentum=0.9,
                  device="cpu")
    carrier.load_state_dict(sd)
    tckpt.save_optimizer(tpath, carrier, step=meta["step"],
                         extra=meta["extra"])
    return jpath, tpath


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    paths = {moe: _carry(tmp, moe) for moe in (0, 4)}
    argv = {name: LM + flags + ["--steps", "2", "--resume",
                                paths[moe][1], "--force-cpu-devices", "2"]
            for name, (flags, moe) in RUNS.items()}
    ranks = run_world("torch_mesh_helpers:cli_mesh_runs", 2,
                      tmp_path_factory.mktemp("world"), argv, timeout=300)
    return paths, ranks


def _step1_loss(log):
    return float(re.search(r"^step +1  loss ([\d.]+)", log, re.M).group(1))


@pytest.mark.parametrize("name", list(RUNS))
def test_cli_model_parallel_run_matches_jax(runs, name, capsys):
    paths, ranks = runs
    flags, moe = RUNS[name]
    capsys.readouterr()
    jopt = jtrain.main(LM + flags + ["--steps", "2", "--resume",
                                     paths[moe][0], "--n-devices", "2"])
    jlog = capsys.readouterr().err
    log = ranks[0][name]["log"]
    line = f"mesh: {MESH[name]} x cpu"
    assert line in log and line in jlog
    assert ranks[1][name]["log"] == ""  # only mesh rank 0 prints
    assert abs(_step1_loss(log) - _step1_loss(jlog)) <= 1e-4
    want, _ = params_from_jax({n: np.asarray(p)
                               for n, p in jopt.params.items()})
    got = ranks[0][name]["params"]
    assert set(got) == set(want)
    for n, p in want.items():
        np.testing.assert_allclose(got[n], np.asarray(p), err_msg=n, **TOL)
        np.testing.assert_array_equal(ranks[1][name]["params"][n], got[n])
