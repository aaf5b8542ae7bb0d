"""One run of one cell: set-up, the measured window, the traced stretch and
the comparison, for each rank of the cell's world.

`prepare` builds the program's optimizer from the seed and drives it
through its first steps with the window's own call (``step(batch,
block=False)``), reading what the comparison needs from the optimizer's
state; `measure` runs the window, a CUDA event recorded after each step,
one synchronize at its end, and keeps every number of the last step's
metrics (``sync_calls`` among them); `trace_stretch` profiles a few more
steps, the program's spans read with the rest;
`free` drops the program and `reference_readings` runs the plain
reference.  Nothing here prints; `run` turns rank 0's record into the
result line.
"""

from __future__ import annotations

import gc
import statistics
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from . import data, flops, program, reference, spec, trace

CHECK_STEPS = 3   # the steps the reference follows
WARM_STEPS = 2    # further set-up steps before the window
AGREE_EVERY = 8   # steps between the ranks' checks of the window's end
SPAN = "port_bench.traced"


@dataclass
class State:
    cell: object
    seed: int
    device: torch.device
    world: int
    opt: object
    pool: list
    shapes: dict
    host_group: object = None
    next_batch: int = 0
    first: dict = field(default_factory=dict)


def _norms(tensors) -> "list[torch.Tensor]":
    return [torch.linalg.vector_norm(t.to(torch.float32)) for t in tensors]


def prepare(cell, seed: int, device, world: int = 1, group=None,
            host_group=None) -> State:
    """Weights and batches from the seed, the optimizer, and its first
    ``CHECK_STEPS + WARM_STEPS`` steps (every shape the window uses)."""
    config, traffic = cell.config, cell.traffic
    module, shapes, buffers = program.build_model(config)
    weights = data.init_weights(shapes, config, seed, device)
    aux = data.init_aux(buffers, device)
    pool = spec.family(config["model"]).batch_pool(traffic, config, seed,
                                                   device)
    opt = program.make_optimizer(module, config, traffic, weights, aux,
                                 device, group)
    del weights
    st = State(cell, seed, device, world, opt, pool, shapes, host_group)
    losses = []
    for i in range(CHECK_STEPS):
        loss, _ = step(st)
        losses.append(loss)
        if i == 0:
            grad = torch.stack(_norms(
                opt.state[n]["momentum_buffer"] for n in shapes))
    start = data.init_weights(shapes, config, seed, device)
    change = torch.stack(_norms(opt.params[n] - start[n] for n in shapes))
    del start
    st.first = {"losses": torch.stack([torch.as_tensor(x, device=device)
                                       for x in losses]),
                "grad_norms": grad, "change_norms": change}
    for _ in range(WARM_STEPS):
        step(st)
    sync(device)
    return st


def step(st: State):
    """One queued step on the pool's next batch."""
    batch = st.pool[st.next_batch % len(st.pool)]
    st.next_batch += 1
    return st.opt.step(batch, block=False)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Marks:
    """Step boundaries: CUDA events on a card, host times on the CPU (where
    every operation has finished when its call returns)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []
        self.mark()

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self) -> "list[float]":
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


def _agree(st: State, done: bool) -> bool:
    """Whether any rank's window has run out (every rank stops at the
    same step, or the collectives of the next would never meet)."""
    if st.world == 1:
        return done
    flag = torch.tensor([int(done)])
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=st.host_group)
    return bool(flag.item())


def measure(st: State, seconds: float) -> dict:
    """The window: queued steps until ``seconds`` have passed on the host
    clock, then one synchronize.  Ranks agree on the end every
    ``AGREE_EVERY`` steps: agreeing is a barrier of the hosts, and one a
    step would make every step wait for the slowest host."""
    every = 1 if st.world == 1 else AGREE_EVERY
    marks = _Marks(st.device)
    losses, host_ms = [], []
    t0 = time.perf_counter()
    while True:
        loss, metrics = step(st)
        marks.mark()
        losses.append(loss)
        host_ms.append(metrics["isend_time"] * 1e3)
        if (len(losses) % every == 0
                and _agree(st, time.perf_counter() - t0 >= seconds)):
            break
    sync(st.device)
    window_s = time.perf_counter() - t0
    failed = int((~torch.isfinite(torch.stack(
        [torch.as_tensor(x) for x in losses]))).sum())
    return {"steps": len(losses), "window_s": window_s,
            "step_ms": marks.step_ms(), "host_ms": host_ms,
            "failed": failed, "packaged_bytes": metrics["packaged_bytes"],
            "msg_bytes": metrics["msg_bytes"],
            "step_metrics": {k: float(v) for k, v in metrics.items()
                             if isinstance(v, (int, float))}}


def trace_stretch(st: State, steps: int) -> "dict | None":
    """``steps`` more queued steps under ``torch.profiler`` (host and
    device), from an idle device to a synchronize, after one step that
    warms the profiler; None off the card or where the profiler saw no
    device work."""
    if st.device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile, record_function

    sync(st.device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # The profiler's first step pays its own start-up on the host:
        # it runs outside the stretch that is read.
        step(st)
        sync(st.device)
        with record_function(SPAN):
            for _ in range(steps):
                step(st)
            sync(st.device)
    return trace.from_profiler(prof, SPAN, steps)


def program_readings(st: State) -> dict:
    """What the program's first steps gave, on the host."""
    f = st.first
    return {"losses": [float(x) for x in f["losses"].cpu()],
            "grad_norms": dict(zip(st.shapes, f["grad_norms"].tolist())),
            "change_norms": dict(zip(st.shapes, f["change_norms"].tolist()))}


def free(st: State) -> None:
    """Drop the program's state, so that the reference fits beside what is
    left."""
    st.opt = None
    gc.collect()
    if st.device.type == "cuda":
        torch.cuda.empty_cache()


def reference_readings(st: State, *, precision: str = "f32",
                       fault: "str | None" = None) -> dict:
    """The plain reference's three steps from the same weights and
    batches (the weights made again from the seed)."""
    cell = st.cell
    weights = data.init_weights(st.shapes, cell.config, st.seed, st.device)
    out = reference.run(cell.config, cell.traffic, weights,
                        st.pool[:CHECK_STEPS], steps=CHECK_STEPS,
                        precision=precision, fault=fault)
    del weights
    return out


def record(st: State, window: dict, prof: "dict | None") -> dict:
    """Everything a metric's reader may read (rank 0's view, the step
    times and the profile already merged over ranks)."""
    cell = st.cell
    family = spec.family(cell.config["model"])
    return {"cell": cell.name, "config": cell.config,
            "traffic": cell.traffic, "world": st.world,
            "items_per_step": family.items_per_batch(cell.traffic),
            "step_flops": family.step_flops(cell.config, cell.traffic),
            "leaf_sizes": flops.leaf_sizes(st.shapes),
            **window, "profile": prof}


def p95(values) -> float:
    """The 95th percentile (``statistics.quantiles``, inclusive)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[18]
