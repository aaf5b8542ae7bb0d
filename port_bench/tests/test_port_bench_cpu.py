"""A whole run on the port's CPU path at a tiny size (the harness's look
for a card skipped): the reference and the program take the same inputs
and agree, and each fault a training cell can have, planted under the
timed path, comes out as not correct."""

import argparse
import dataclasses
import json
import os

import pytest

from port_bench import run, spec

SEED = 2 ** 33 + 12345  # wider than 32 bits, as the driver's seeds are


@pytest.fixture(autouse=True)
def _two_row_chunks(monkeypatch):
    """The LM reference takes its loss in chunks of two rows, so that a
    tiny shard of four still spans more than one chunk."""
    from port_bench.reference import lm

    monkeypatch.setattr(lm, "CHUNK_ROWS", 2)


@pytest.fixture(autouse=True)
def _host_share_restored():
    """A world of more than one rank runs rank 0 in this process and gives
    it a share of the cores and one thread: take them back after."""
    import torch

    cores, threads = os.sched_getaffinity(0), torch.get_num_threads()
    yield
    os.sched_setaffinity(0, cores)
    torch.set_num_threads(threads)


def tiny_cell(model: str, world: int = 1) -> spec.Cell:
    """A cell of the benchmark cut to a CPU test's size, in float32 (the
    program and the reference then agree to rounding), with the limits of
    the benchmark's cell of that model."""
    name = ("gpt2m-blockq-b16x1024" if model == "lm" else
            "r18-blockq-b2048")
    cell = spec.load_cell(name)
    config, traffic = dict(cell.config), dict(cell.traffic)
    config["compute_dtype"] = "float32"
    if model == "lm":
        config.update(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                      d_ff=64, max_len=16)
        traffic.update(batch_per_rank=4, seq_len=16)
    else:
        config.update(image=[8, 8, 3])
        traffic.update(batch_per_rank=8)
    traffic["world"] = world
    return dataclasses.replace(cell, chips=world, config=config,
                               traffic=traffic)


def _args(cell):
    return argparse.Namespace(workload=cell.name, seed=SEED, seconds=0.2,
                              trace=0)


def run_cpu(cell) -> "tuple[dict, dict]":
    args = _args(cell)
    res = run.run_world(args, cell, "cpu")
    line, _ = run.result_line(args, res, spec.benchmark())
    return res, line


@pytest.mark.parametrize("model", ["lm", "resnet18"])
def test_program_and_reference_agree_on_the_cpu(model):
    res, line = run_cpu(tiny_cell(model))
    assert line["correct"], line["checked"]
    assert res["read"]["loss_gap"] < 1e-5
    assert res["read"]["grad_gap"] < 1e-4
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert list(line)[-1] == "checked"
    e2e = {m.name for m in spec.cell_metrics(spec.benchmark(), line_cell(
        model), False)}
    assert set(line["metrics"]) == e2e
    json.dumps(line)
    # The last step's counters ride in the record: a traced line of the
    # cell reads the sync's flat collectives (the CPU traces no spans).
    calls = res["rec"]["step_metrics"]["sync_calls"]
    assert calls >= 1
    args = argparse.Namespace(**{**vars(_args(tiny_cell(model))),
                                 "trace": 1})
    traced, _ = run.result_line(args, res, spec.benchmark())
    suffix = "lm" if model == "lm" else "r18"
    assert traced["metrics"][f"ps.sync.calls.{suffix}"]["value"] == calls
    assert f"ps.grad.host_ms.{suffix}" not in traced["metrics"]


def line_cell(model):
    return tiny_cell(model).name


def _unchanged(monkeypatch):
    from pytorch_ps_mpi_tpu_torch.ps import MPI_PS

    monkeypatch.setattr(MPI_PS, "_phase_update",
                        lambda self, d: self._settle_step_counters())


def _half_batch(monkeypatch):
    from pytorch_ps_mpi_tpu_torch.ps import MPI_PS

    shard = MPI_PS._shard_batch

    def first_half(self, batch):
        return {k: v[:v.shape[0] // 2] for k, v in shard(self,
                                                          batch).items()}

    monkeypatch.setattr(MPI_PS, "_shard_batch", first_half)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch],
                         ids=["state-unchanged", "half-batch"])
@pytest.mark.parametrize("model", ["lm", "resnet18"])
def test_a_fault_under_the_timed_path_is_not_correct(model, fault,
                                                     monkeypatch):
    fault(monkeypatch)
    _, line = run_cpu(tiny_cell(model))
    assert not line["correct"], line["checked"]


def _own_codes_only():
    """The exchange left out: each rank decodes its own codes alone."""
    from pytorch_ps_mpi_tpu_torch.parallel import collectives
    from pytorch_ps_mpi_tpu_torch.utils.flatten import tree_map

    def alone(codes, group, bucket_bytes=None):
        return tree_map(lambda x: x[None], codes)

    collectives.allgather_tree_bucketed = alone


def _faulty_rank(rank, world, init_file, args, cell):
    _own_codes_only()
    return run.rank_main(rank, world, init_file, args, cell, "cpu")


def test_the_exchange_left_out_is_not_correct():
    from pytorch_ps_mpi_tpu_torch.parallel import collectives

    cell = tiny_cell("lm", world=2)
    kept = collectives.allgather_tree_bucketed
    try:
        res = run.run_ranks(2, _faulty_rank, _args(cell), cell)
    finally:
        collectives.allgather_tree_bucketed = kept
    assert not res["correct"], res["compared"]


def test_two_ranks_agree_with_the_reference():
    res, line = run_cpu(tiny_cell("lm", world=2))
    assert line["correct"], line["checked"]
    assert line["device"]["count"] == 2


def _jax_on_rank_1(rank, world, init_file, args, cell):
    """Rank 1 loads a module named ``jax`` (rank 0, this process, does
    not)."""
    import sys
    import types

    if rank == 1:
        sys.modules.setdefault("jax", types.ModuleType("jax"))
    return run.rank_main(rank, world, init_file, args, cell, "cpu")


def test_a_forbidden_module_on_another_rank_is_refused():
    import sys

    assert "jax" not in sys.modules
    cell = tiny_cell("lm", world=2)
    res = run.run_ranks(2, _jax_on_rank_1, _args(cell), cell)
    assert res["forbidden"] == ["jax"]
    assert run.loaded_forbidden(res) == ["jax"]
    assert run.forbidden_modules() == []
