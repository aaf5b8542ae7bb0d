"""Readings that set a cell's limits: the program's and the control's.

    python3 -m port_bench.calibrate --workload <cell> --seeds 11 12 ... [--control-seeds 3]

For each seed, in one process a rank: the program's first steps exactly
as a benchmark run makes them (no window), then on rank 0 the plain
reference, and on the first ``--control-seeds`` seeds also the control
(the reference rounded to float8 wherever the configuration computes in
bfloat16, put in the program's place) and
the faults planted in the reference (half of each rank's shard left out;
on more than one rank, the exchange left out).  A state left unchanged
reads 1 on ``change_gap`` by the comparison's measure and needs no run.
Each seed prints one ``[calibrate]`` JSON line, each reading with
``correct`` as the cell's limits judge it; the benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import run


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    return p.parse_args(argv)


def _numbers(read: dict, limits: dict) -> dict:
    """The readings, and whether they pass the cell's limits as they
    stand (``correct``): the control and each fault must not."""
    from . import check

    out = {k: read[k] for k in (*check.NUMBERS, "grad_leaf",
                                "change_leaf")}
    out["correct"] = check.judge(read, limits)[0]
    return out


def rank_main(rank: int, world: int, init_file: str, args) -> None:
    import torch
    import torch.distributed as dist

    from . import check, harness, reference, spec

    cell = spec.load_cell(args.workload)
    reference.tf32_off()
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    group = harness.program.join(device, rank, world, init_file)
    host_group = dist.new_group(backend="gloo") if world > 1 else group
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        st = harness.prepare(cell, seed, device, world, group, host_group)
        prog = harness.program_readings(st)
        harness.free(st)
        if world > 1:
            dist.barrier(group=host_group)
        if rank != 0:
            if world > 1:
                dist.barrier(group=host_group)
            continue
        ref = harness.reference_readings(st)
        read = check.readings(prog, ref)
        out = {"seed": seed, "program": _numbers(read, cell.limits),
               "losses": prog["losses"], "reference_losses": ref["losses"]}
        if i < args.control_seeds:
            out["control"] = _numbers(check.readings(
                harness.reference_readings(st, precision="fp8"), ref),
                cell.limits)
            faults = ["half"] + (["no_exchange"] if world > 1 else [])
            for fault in faults:
                out[fault] = _numbers(check.readings(
                    harness.reference_readings(st, fault=fault), ref),
                    cell.limits)
        out["seconds"] = time.perf_counter() - t0
        print("[calibrate] " + json.dumps(out), flush=True)
        if world > 1:
            dist.barrier(group=host_group)
    dist.destroy_process_group()


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from . import spec

    world = spec.load_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        print(f"calibrate: needs {world} CUDA card(s)", file=sys.stderr)
        return 3
    run.run_ranks(world, rank_main, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
