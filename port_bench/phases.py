"""Where a one-chip cell's step spends its time, phase by phase: a traced
stretch read by the program's spans.

    python3 -m port_bench.phases --workload <cell> --seed <n> [--seconds 10] [--steps 5]

Set-up as a benchmark run's, a warm window of ``--seconds`` queued steps,
then ``--steps`` steps under ``torch.profiler`` as in a traced run.  Prints
one JSON object: the card and its power limit, the traced stretch's
summary (`trace.from_profiler`), each program span's host and device ms a
step with the unclaimed share and the longest idle gaps by span
(`spans.from_profiler`, None where the program opens no span), the two
checks of the spans' coverage (the phases' device ms over all launched
inside ``ps.step``; the phases' host ms over ``ps.step``'s), the traced
steps' own issue time (``isend_time``) and the last step's
``sync_calls``.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

from . import harness, reference, run, spans, spec, trace


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--steps", type=int, default=None,
                   help="traced steps (default: the traffic's trace_steps)")
    return p.parse_args(argv)


def coverage(sp: dict) -> dict:
    """The phases' share of the device time launched inside ``ps.step``
    and their host ms over ``ps.step``'s."""
    dev = sum(sp["device_ms"].get(n, 0.0) for n in spans.PHASES)
    inside = dev + sp["device_ms"].get("ps.step", 0.0)
    host = sum(sp["host_ms"].get(n, 0.0) for n in spans.PHASES)
    step = sp["host_ms"].get("ps.step")
    return {"phase_device_share": dev / inside if inside else None,
            "phase_host_over_step": host / step if step else None}


def traced(st, steps: int) -> dict:
    """``steps`` queued steps under ``torch.profiler`` after one that
    warms it, from an idle device to a synchronize (as
    `harness.trace_stretch`), read by `trace` and `spans`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    harness.sync(st.device)
    isend = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        harness.step(st)
        harness.sync(st.device)
        with record_function(harness.SPAN):
            for _ in range(steps):
                _, metrics = harness.step(st)
                isend.append(metrics["isend_time"] * 1e3)
            harness.sync(st.device)
    summary = trace.from_profiler(prof, harness.SPAN, steps)
    sp = summary.pop("spans") if summary else None
    return {"trace": summary, "spans": sp,
            "coverage": coverage(sp) if sp else None,
            "isend_ms": isend, "isend_ms_mean": statistics.fmean(isend),
            "sync_calls": metrics.get("sync_calls")}


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    if not torch.cuda.is_available():
        print("port_bench.phases: needs a CUDA card", file=sys.stderr)
        return run.NO_CARD
    cell = spec.load_cell(args.workload)
    if cell.chips != 1:
        print(f"port_bench.phases: {cell.name} runs {cell.chips} chips; "
              "this reads one-chip cells", file=sys.stderr)
        return 2
    reference.tf32_off()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    group = harness.program.join(device, 0, 1, None)
    st = harness.prepare(cell, args.seed, device, 1, group, group)
    window = harness.measure(st, args.seconds)
    out = {"cell": cell.name, "seed": args.seed, "card": run.card_lines(1),
           "window_steps": window["steps"],
           "window_host_ms": statistics.fmean(window["host_ms"]),
           **traced(st, args.steps or int(cell.traffic["trace_steps"]))}
    torch.distributed.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
