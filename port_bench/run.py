"""Run one cell of the port's benchmark once and print its result line.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It needs as many CUDA cards as the cell's ``chips``, and exits with code 3,
printing no result, where it finds fewer.  A cell of more than one chip
runs one process a card (this one is rank 0, which prints); they join
through a store file under ``TMPDIR``.  Earlier lines give the card, its
power limit and clocks (and on more than one card the topology); the last
lines of standard error give each number the comparison checked beside its
limit, and the last line of standard output is the result as one JSON
object.  The kernels build into the port's ``_build/`` directory inside the
checkout, on the first run only.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import multiprocessing  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pytorch_ps_mpi_tpu")
NO_CARD = 3
LOADED_JAX = 4


def forbidden_modules() -> "list[str]":
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def loaded_forbidden(res: dict) -> "list[str]":
    """What this process has loaded of ``FORBIDDEN``, with what every rank
    of the run reported after its window."""
    return sorted(set(forbidden_modules()) | set(res["forbidden"]))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _smi(*args) -> str:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi: not found"
    try:
        out = subprocess.run([exe, *args], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return (out.stdout or out.stderr).strip()


def card_lines(world: int) -> "list[str]":
    import torch

    lines = [f"[card] {torch.cuda.get_device_name(0)}, "
             f"{torch.cuda.device_count()} visible, {world} used; torch "
             f"{torch.__version__}, CUDA {torch.version.cuda}"]
    lines.append("[card] index, name, power.limit, clocks.sm: " + _smi(
        "--query-gpu=index,name,power.limit,clocks.sm",
        "--format=csv,noheader").replace("\n", " | "))
    if world > 1:
        lines.append("[card] topology:\n" + _smi("topo", "-m"))
    return lines


def host_share(rank: int, world: int) -> None:
    """Give rank ``rank`` its own share of the host's cores and one
    intra-op thread (as ``torchrun`` sets ``OMP_NUM_THREADS=1`` for
    several processes a host): the ranks' launching threads then do not
    contend for cores."""
    import torch

    cores = sorted(os.sched_getaffinity(0))
    per = len(cores) // world
    if per:
        os.sched_setaffinity(0, cores[rank * per:(rank + 1) * per])
    torch.set_num_threads(1)


def rank_main(rank: int, world: int, init_file: str, args, cell,
              device_type: str = "cuda") -> "dict | None":
    """Set-up, window, traced stretch and, on rank 0, the comparison.
    Returns rank 0's result (None elsewhere).  ``device_type="cpu"`` runs
    the same on the port's CPU path (the tests' tiny cells)."""
    import torch
    import torch.distributed as dist

    from . import check, harness, reference

    reference.tf32_off()
    if world > 1:
        host_share(rank, world)
    on_card = device_type == "cuda"
    device = torch.device("cuda", rank) if on_card else torch.device("cpu")
    if on_card:
        torch.cuda.set_device(device)
    group = harness.program.join(device, rank, world, init_file)
    host_group = (dist.new_group(backend="gloo") if on_card and world > 1
                  else group)
    st = harness.prepare(cell, args.seed, device, world, group, host_group)
    if world > 1:
        dist.barrier(group=host_group)
    setup_s = time.perf_counter() - T0
    window = harness.measure(st, args.seconds)
    prof = (harness.trace_stretch(st, int(cell.traffic["trace_steps"]))
            if args.trace else None)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    # Each rank's own modules once its window has closed: ranks 1.. are
    # processes of their own, which rank 0's look cannot see.
    mine = {"step_ms": window["step_ms"], "peak": peak, "prof": prof,
            "forbidden": forbidden_modules()}
    if world > 1:
        every = [None] * world
        dist.all_gather_object(every, mine, group=host_group)
    else:
        every = [mine]
    dist.destroy_process_group()
    if rank != 0:
        return None
    window["step_ms"] = [max(ms) for ms in
                         zip(*(e["step_ms"] for e in every))]
    merged = _merge_profiles([e["prof"] for e in every])
    rec = harness.record(st, window, merged)
    rec["setup_s"] = setup_s
    prog = harness.program_readings(st)
    harness.free(st)
    ref = harness.reference_readings(st)
    read = check.readings(prog, ref)
    correct, compared = check.judge(read, cell.limits)
    compared["failed_steps"] = [window["failed"], 0]
    correct = correct and window["failed"] == 0
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    return {"rec": rec, "correct": correct, "compared": compared,
            "read": read, "peak": max(e["peak"] for e in every),
            "kind": kind, "world": world,
            "forbidden": sorted({m for e in every for m in e["forbidden"]})}


def _mean_ms(maps) -> dict:
    """Each key's mean over the dicts ``maps`` (0 where one lacks it)."""
    keys = {k for m in maps for k in m}
    return {k: sum(m.get(k, 0.0) for m in maps) / len(maps) for k in keys}


def _merge_profiles(profs) -> "dict | None":
    """Rank 0's profile, its busy and wall seconds, its per-category device
    ms and each program span's host and device ms replaced by the mean
    over the ranks that traced."""
    got = [p for p in profs if p]
    if not got:
        return None
    out = dict(got[0])
    out["busy_s"] = sum(p["busy_s"] for p in got) / len(got)
    out["wall_s"] = sum(p["wall_s"] for p in got) / len(got)
    out["category_ms"] = _mean_ms([p["category_ms"] for p in got])
    spans = [p["spans"] for p in got if p.get("spans")]
    if spans:
        out["spans"] = dict(spans[0])
        for kind in ("host_ms", "device_ms"):
            out["spans"][kind] = _mean_ms([s[kind] for s in spans])
    return out


def run_ranks(world: int, target, *args):
    """``target(rank, world, init_file, *args)`` for rank 0 here and ranks
    1.. in spawned processes, joined through a store file under
    ``TMPDIR``; rank 0's return value.  Raises if a rank failed."""
    tmp = tempfile.mkdtemp(prefix="port_bench_")
    init_file = os.path.join(tmp, "store")
    ctx = multiprocessing.get_context("spawn")
    children = [ctx.Process(target=target,
                            args=(r, world, init_file, *args))
                for r in range(1, world)]
    for c in children:
        c.start()
    try:
        res = target(0, world, init_file, *args)
    finally:
        for c in children:
            c.join(timeout=600)
            if c.is_alive():
                c.terminate()
                c.join()
        shutil.rmtree(tmp, ignore_errors=True)
    bad = [c.exitcode for c in children if c.exitcode != 0]
    if bad:
        raise RuntimeError(f"a rank exited with {bad}")
    return res


def run_world(args, cell, device_type: str = "cuda") -> dict:
    """A run of ``cell`` on its world; rank 0's result."""
    return run_ranks(cell.chips, rank_main, args, cell, device_type)


def result_line(args, res: dict, bench: dict) -> "tuple[dict, list[str]]":
    """The contract's JSON object and the comparison's lines."""
    from . import check, spec

    rec = res["rec"]
    metrics = {}
    for m in spec.cell_metrics(bench, rec["cell"], bool(args.trace)):
        value = spec.reader(m.name)(rec)
        if value is None:
            if m.kind == "end_to_end":
                raise spec.SpecError(f"end-to-end metric {m.name} read "
                                     "nothing")
            continue
        metrics[m.name] = {"value": float(value), "unit": m.unit}
    device = {"platform": "gpu", "kind": res["kind"], "count": res["world"],
              "memory_peak_bytes": int(res["peak"])}
    line = {"correct": bool(res["correct"]), "attempted": rec["steps"],
            "failed": rec["failed"], "metrics": metrics, "device": device}
    prof = rec["profile"]
    if args.trace and prof:
        device["busy_s"] = prof["busy_s"]
        device["window_s"] = prof["wall_s"]
        line["breakdown"] = {"device_ops": prof["device_ops"],
                             "idle_gaps": prof["idle_gaps"]}
    read = res["read"]
    lines = [f"[check] worst leaves: gradient {read['grad_leaf']}, change "
             f"{read['change_leaf']}; {read['left_out']} leaves left out "
             "of the change (reference gradient under a thousandth of "
             "the median leaf's)"]
    lines += [f"[check] {k} {read[k]!r} (not compared: no limit)"
              for k in check.NUMBERS if k not in res["compared"]]
    lines += [f"[check] {k} {v[0]!r} limit {v[1]!r}"
              for k, v in res["compared"].items()]
    line["checked"] = {k: {"value": v[0], "limit": v[1]}
                       for k, v in res["compared"].items()}
    return line, lines


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from . import spec

    cell = spec.load_cell(args.workload)
    world = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"port_bench: cell {cell.name} needs {world} CUDA card(s), "
              f"found {found}; no result", file=sys.stderr)
        return NO_CARD
    for line in card_lines(world):
        print(line, flush=True)
    res = run_world(args, cell)
    line, lines = result_line(args, res, spec.benchmark())
    found = loaded_forbidden(res)
    if found:
        print(f"port_bench: loaded {found} (JAX or the JAX package); no "
              "result", file=sys.stderr)
        return LOADED_JAX
    print(f"[run] {cell.name} seed {args.seed}: {line['attempted']} steps "
          f"in {res['rec']['window_s']:.3f} s", flush=True)
    for text in lines:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
