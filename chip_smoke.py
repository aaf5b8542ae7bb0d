"""Drive the PyTorch port on one NVIDIA card and check what comes out.

Run from the repository root, on a machine with a CUDA card and ``nvcc``::

    python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit; nothing is caught
and carried on from):

1. Environment: torch/CUDA versions, the card's name and power limit, the
   TF32 settings, and the build of the codec kernels from
   ``pytorch_ps_mpi_tpu_torch/csrc`` (with ``nvcc``'s register report).
2. Each codec kernel against its plain PyTorch version on the card, bitwise,
   at the 62 ResNet-18 parameter sizes (world 1 and 4, bits 8 and 16, bf16
   and f32 wires, an all-zero tile, a NaN tile, ragged tails, unaligned and
   strided inputs), then timed with CUDA events at the main path's shapes
   beside its plain version, a library call where one computes the same
   function, and its bound (bytes over 3.35 TB/s).
3. The slice through its public entry points: a one-rank NCCL group,
   full-width bf16 ResNet-18 and ``SGD(lr=0.1, momentum=0.9)`` on synthetic
   CIFAR-10 at batch 1024 — 3 warm-up and 10 timed steps with the blockq
   codec, then 3 steps each with bf16 and identity — with the kernels'
   launch counts read around each run, a profile of two blockq and two
   bf16 steps (device time by kernel category, busy share), and a small
   MLP run on the card checked against the same run on the CPU (plain
   versions).
4. The card line, one JSON line per the kernels, and the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
SOURCE = "pytorch_ps_mpi_tpu_torch/csrc/codec_kernels.cu"
REPLACES = {
    "block_quantize": "pytorch_ps_mpi_tpu/ops/pallas_kernels.py:91",
    "block_dequant_sum": "pytorch_ps_mpi_tpu/ops/pallas_kernels.py:162",
    "cast_sum": "pytorch_ps_mpi_tpu/ops/pallas_kernels.py:227",
}
BATCH = 1024
WARM, TIMED, SIDE = 3, 10, 3


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def same_bits(a, b) -> bool:
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        ints = {4: torch.int32, 2: torch.int16}[a.element_size()]
        return torch.equal(a.contiguous().view(ints),
                           b.contiguous().view(ints))
    return torch.equal(a, b)


def abs_err(a, b) -> float:
    import torch

    d = (a.to(torch.float64) - b.to(torch.float64)).abs()
    d = torch.where(torch.isnan(a) & torch.isnan(b), torch.zeros_like(d), d)
    return float(d.max()) if d.numel() else 0.0


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean time of ``fn()`` on the card, from CUDA events after warm-up."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_kernels(sizes):
    """Bitwise checks of every kernel against its plain version; returns
    ``{kernel: max_abs_err}`` (0.0 when every check is bitwise)."""
    import torch

    from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck
    from pytorch_ps_mpi_tpu_torch.ops.codecs import BlockQuantizeCodec

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows_for = BlockQuantizeCodec()._rows_for
    errs = {k: 0.0 for k in REPLACES}
    n_checks = {k: 0 for k in REPLACES}

    def record(name, ours, ref, what):
        n_checks[name] += 1
        errs[name] = max(errs[name], abs_err(ours, ref))
        if not same_bits(ours, ref):
            fail(f"{name} differs from its plain version ({what}): "
                 f"max abs err {abs_err(ours, ref)}")

    def grad(n, scale):
        return torch.randn(n, device="cuda", generator=gen) * scale

    # (what, flat gradient, rows per tile): the main path's sizes and
    # tiles, then three 8-row tiles holding a zero tile and a NaN tile, a
    # ragged tail, and a start only 4-byte aligned (the scalar loads).
    cases = [(f"resnet18 #{i} n={n}", grad(n, 10.0 ** (i % 5 - 3)),
              rows_for(n)) for i, n in enumerate(sizes)]
    zero = grad(3 * 1024, 1.0)
    zero[:1024] = 0.0
    cases.append(("zero tile", zero, 8))
    nan = grad(3 * 1024, 1.0)
    nan[1024 + 5] = float("nan")
    cases.append(("nan tile", nan, 8))
    cases.append(("ragged tail", grad(512 * 128 + 77, 1.0), 512))
    cases.append(("unaligned start", grad(70001, 1.0)[1:], 512))

    for bits in (8, 16):
        stacks = []
        for what, x, rows in cases:
            q, s = ck.block_quantize(x, bits=bits, block_rows=rows)
            rq, rs = ck.block_quantize_ref(ck.pad_to_blocks(x, rows)[0],
                                           bits=bits, block_rows=rows)
            record("block_quantize", q, rq, f"{what} bits={bits}")
            record("block_quantize", s, rs, f"{what} bits={bits} scales")
            if what == "nan tile" and not (float(s[1, 0]) == 1.0 and
                                           int(q.view(-1)[1024 + 5]) == 0):
                fail("NaN tile: its scale must be 1.0 and the NaN's code 0")
            if what == "zero tile" and (float(s[0, 0]) != 1.0
                                        or bool(q[:8].any())):
                fail("zero tile: its scale must be 1.0 and its codes 0")
            stacks.append((what, rows, q, s))
        for world in (1, 4):
            for what, rows, q, s in stacks:
                qs = torch.stack([q] * world)
                ss = torch.stack([s * (1 + r) for r in range(world)])
                record("block_dequant_sum",
                       ck.block_dequant_sum(qs, ss, block_rows=rows),
                       ck.block_dequant_sum_ref(qs, ss, block_rows=rows),
                       f"{what} bits={bits} world={world}")
        # Codes as a strided view of a gathered bucket: ranks a bucket
        # apart, each rank's codes starting mid-bucket.
        _, rows, q, s = stacks[1]
        world = 4
        bucket = torch.zeros((world, 2048 + q.numel()), dtype=q.dtype,
                             device="cuda")
        bucket[:, 2048:] = q.view(-1)
        scales = torch.zeros((world, 3 + s.numel()), device="cuda")
        scales[:, 3:] = s.view(-1)
        qv = bucket[:, 2048:].view(world, *q.shape)
        sv = scales[:, 3:].view(world, *s.shape)
        record("block_dequant_sum",
               ck.block_dequant_sum(qv, sv, block_rows=rows),
               ck.block_dequant_sum_ref(qv, sv, block_rows=rows),
               f"strided bucket view bits={bits}")

    for dtype in (torch.bfloat16, torch.float32):
        for world in (1, 4):
            for what, x, _ in cases:
                wire = torch.stack([x * (r + 1) for r in range(world)]).to(
                    dtype)
                record("cast_sum", ck.cast_sum(wire), ck.cast_sum_ref(wire),
                       f"{what} {dtype} world={world}")
            # A leaf at an odd offset of a gathered bucket: the scalar path.
            bucket = torch.stack([grad(4099, 1.0) for _ in range(world)]).to(
                dtype)
            view = bucket[:, 3:]
            record("cast_sum", ck.cast_sum(view), ck.cast_sum_ref(view),
                   f"odd bucket offset {dtype} world={world}")
    torch.cuda.synchronize()
    for k in REPLACES:
        print(f"[kernels] {k}: {n_checks[k]} checks bitwise equal to the "
              f"plain version (max abs err {errs[k]})")
    return errs


def time_kernels(sizes):
    """Time each kernel over one step's worth of calls at the main path's
    shapes (the 62 ResNet-18 tensors, world 1) against its plain version,
    a library call where one computes the same function, and its bound."""
    import torch

    from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck
    from pytorch_ps_mpi_tpu_torch.ops.codecs import BlockQuantizeCodec

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows_for = BlockQuantizeCodec()._rows_for
    grads = [torch.randn(n, device="cuda", generator=gen) * 1e-2
             for n in sizes]
    rows = [rows_for(n) for n in sizes]
    codes = [ck.block_quantize(g, block_rows=r) for g, r in zip(grads, rows)]
    stacked = [(q[None], s[None]) for q, s in codes]
    wires = [g.to(torch.bfloat16)[None] for g in grads]

    q_bytes = sum(g.numel() * 4 + q.numel() + s.numel() * 4
                  for g, (q, s) in zip(grads, codes))
    d_bytes = sum(q.numel() + s.numel() * 4 + q.numel() * 4
                  for q, s in codes)
    c_bytes = sum(w.numel() * 2 + w.shape[1] * 4 for w in wires)
    out = {
        "block_quantize": dict(
            ms=time_ms(lambda: [ck.block_quantize(g, block_rows=r)
                                for g, r in zip(grads, rows)]),
            plain_ms=time_ms(lambda: [
                ck.block_quantize_ref(ck.pad_to_blocks(g, r)[0],
                                      block_rows=r)
                for g, r in zip(grads, rows)]),
            bytes=q_bytes, library_ms=None),
        "block_dequant_sum": dict(
            ms=time_ms(lambda: [ck.block_dequant_sum(q, s, block_rows=r)
                                for (q, s), r in zip(stacked, rows)]),
            plain_ms=time_ms(lambda: [
                ck.block_dequant_sum_ref(q, s, block_rows=r)
                for (q, s), r in zip(stacked, rows)]),
            bytes=d_bytes, library_ms=None),
        "cast_sum": dict(
            ms=time_ms(lambda: [ck.cast_sum(w) for w in wires]),
            plain_ms=time_ms(lambda: [ck.cast_sum_ref(w) for w in wires]),
            bytes=c_bytes,
            library_ms=time_ms(lambda: [w.float().sum(0) for w in wires])),
    }
    for k, v in out.items():
        v["bound_ms"] = v["bytes"] / H100_BYTES_PER_S * 1e3
        lib = ("null" if v["library_ms"] is None
               else f"{v['library_ms']:.4f} ms")
        print(f"[kernels] {k}: {len(sizes)} calls (one step, world 1): "
              f"kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms, "
              f"library {lib}, bound {v['bound_ms']:.4f} ms "
              f"({v['bytes']} bytes at 3.35 TB/s)")
    return out


# ---------------------------------------------------------------------------
# Phase 3: the slice
# ---------------------------------------------------------------------------


def drive(code, named, aux, loss_fn, batch, group, warm, timed):
    """Run ``warm`` blocking steps and ``timed`` queued steps of SGD with
    ``code``; the launch counts are zeroed just before and read just
    after.  Returns (optimizer, losses, counts, seconds of the timed
    steps, last metrics)."""
    import torch

    from pytorch_ps_mpi_tpu_torch import SGD
    from pytorch_ps_mpi_tpu_torch.ops import codec_kernels as ck

    opt = SGD(list(named.items()), lr=0.1, momentum=0.9, code=code,
              device="cuda", group=group)
    opt.compile_step(loss_fn, has_aux=True, aux=aux)
    ck.reset_launch_counts()
    losses = []
    for _ in range(warm):
        loss, metrics = opt.step(batch)
        losses.append(loss)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        loss, metrics = opt.step(batch, block=False)
        losses.append(loss)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(ck.LAUNCHES)
    losses = [float(x) for x in losses]
    return opt, losses, counts, seconds, metrics


_CATEGORIES = (
    ("block_quantize", ("block_quantize_kernel",)),
    ("block_dequant_sum", ("block_dequant_sum_kernel",)),
    ("cast_sum", ("cast_sum_kernel",)),
    ("nccl", ("nccl",)),
    ("batch norm", ("batch_norm", "batchnorm", "bn_")),
    ("conv/matmul", ("conv", "xmma", "gemm", "cudnn", "implicit", "wgrad",
                     "dgrad", "fprop", "sm90")),
)


def profile_steps(opt, batch, steps: int = 2):
    """Device time of ``steps`` queued steps by kernel category, from
    torch.profiler's CUDA events, and the device's busy share of the wall
    time under the profiler (kernel time over host-clock time to
    synchronize).  Returns the device kernel ms per step, or None."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            opt.step(batch, block=False)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print("[profile] the profiler saw no CUDA kernels: device time "
              "not measured")
        return None
    by_cat, by_name = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        name = e.name.lower()
        cat = next((c for c, keys in _CATEGORIES
                    if any(k in name for k in keys)), "elementwise/other")
        by_cat[cat] = by_cat.get(cat, 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    busy = sum(by_cat.values())
    print(f"[profile] {steps} {opt.code.name} steps: wall "
          f"{wall_us / steps / 1e3:.3f} "
          f"ms/step, device kernel time {busy / steps / 1e3:.3f} ms/step, "
          f"busy share under the profiler {busy / wall_us:.3f}, "
          f"{len(kernels) // steps} kernels/step")
    for cat, us in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {cat}: {us / steps / 1e3:.3f} ms/step "
              f"({us / busy:.3f} of device time)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[profile]   top: {us / steps / 1e3:.3f} ms/step  {name[:110]}")
    return busy / steps / 1e3


def check_params_finite(opt, what):
    import torch

    for n, p in opt.params.items():
        if not bool(torch.isfinite(p).all()):
            fail(f"{what}: parameter {n} is not finite")


def small_reference_check(group):
    """A small MLP trained 3 steps with blockq on the card (CUDA kernels)
    and on the CPU (plain versions), from the same numpy init and batches.
    Tolerance rtol=1e-4, atol=1e-5: float32 matmuls (TF32 off) sum in
    other orders on the two devices; the codes then agree, or differ by
    one quantum (lr * scale, ~1e-6 here)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from pytorch_ps_mpi_tpu_torch import SGD
    from pytorch_ps_mpi_tpu_torch.data.datasets import synthetic_mnist
    from pytorch_ps_mpi_tpu_torch.models import init_mlp, mlp_loss_fn

    named = init_mlp(np.random.RandomState(0), (784, 64, 10))
    x, y = synthetic_mnist(256, seed=1)
    batch = {"x": x, "y": y}
    cpu_group = dist.new_group(backend="gloo")
    out = {}
    for device, grp in (("cuda", group), ("cpu", cpu_group)):
        opt = SGD(list(named.items()), lr=0.05, momentum=0.9, code="blockq",
                  device=device, group=grp)
        opt.compile_step(mlp_loss_fn)
        losses = [opt.step(batch)[0] for _ in range(3)]
        out[device] = (losses, {n: p.cpu().numpy()
                                for n, p in opt.params.items()})
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    worst = 0.0
    for n, p in out["cpu"][1].items():
        np.testing.assert_allclose(out["cuda"][1][n], p, rtol=1e-4,
                                   atol=1e-5, err_msg=n)
        worst = max(worst, float(np.abs(out["cuda"][1][n] - p).max()))
    print(f"[slice] small MLP blockq, card vs CPU plain versions: losses "
          f"{out['cuda'][0]} vs {out['cpu'][0]}, max param diff {worst}")


def run_slice():
    import torch

    from pytorch_ps_mpi_tpu_torch import make_ps_group
    from pytorch_ps_mpi_tpu_torch.data.datasets import synthetic_cifar10
    from pytorch_ps_mpi_tpu_torch.models import (build_model,
                                                 make_classifier_loss,
                                                 resnet18)

    group = make_ps_group("cuda")
    model = resnet18(num_classes=10, small_inputs=True, dtype=torch.bfloat16)
    named, aux = build_model(model, seed=0)
    loss_fn, has_aux = make_classifier_loss(model)
    if not has_aux or len(named) != 62 or len(aux) != 40:
        fail(f"ResNet-18 has {len(named)} tensors and {len(aux)} statistics")
    x, y = synthetic_cifar10(BATCH, seed=0)
    # Staged on the card once: the step is measured, not the input copy.
    batch = {"x": torch.from_numpy(x).cuda(), "y": torch.from_numpy(y).cuda()}
    per_step = len(named)

    torch.cuda.reset_peak_memory_stats()
    opt, losses, counts, seconds, metrics = drive(
        "blockq", named, aux, loss_fn, batch, group, WARM, TIMED)
    steps = WARM + TIMED
    print(f"[slice] blockq: {steps} steps, losses {losses}")
    print(f"[slice] blockq launches {counts} (expect {per_step}/step for "
          f"each blockq kernel)")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"blockq losses must be finite and fall: {losses}")
    if (counts["block_quantize"] != per_step * steps
            or counts["block_dequant_sum"] != per_step * steps
            or counts["cast_sum"] != 0):
        fail(f"blockq launch counts {counts}")
    if (metrics["packaged_bytes"] != 11445104
            or metrics["msg_bytes"] != 44695848):
        fail(f"byte metrics {metrics}")
    check_params_finite(opt, "blockq")
    ms = seconds / TIMED * 1e3
    print(f"[slice] blockq ResNet-18 bf16 batch {BATCH}: {ms:.3f} ms/step, "
          f"{BATCH * TIMED / seconds:.1f} images/s per GPU "
          f"({TIMED} queued steps, host clock to synchronize); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    device_ms = profile_steps(opt, batch)
    if device_ms is not None:
        print(f"[slice] blockq device busy share without the profiler: "
              f"{device_ms / ms:.3f} (profiled device ms/step over the "
              f"timed ms/step)")
    main_counts = counts
    del opt

    opt, losses, counts, seconds, _ = drive(
        "bf16", named, aux, loss_fn, batch, group, SIDE, 0)
    print(f"[slice] bf16: losses {losses}, launches {counts}")
    if (not all(math.isfinite(v) for v in losses)
            or counts != {"block_quantize": 0, "block_dequant_sum": 0,
                          "cast_sum": per_step * SIDE}):
        fail(f"bf16 run: losses {losses}, launches {counts}")
    check_params_finite(opt, "bf16")
    profile_steps(opt, batch)
    cast_counts = counts
    del opt

    opt, losses, counts, _, _ = drive(
        "identity", named, aux, loss_fn, batch, group, SIDE, 0)
    print(f"[slice] identity: losses {losses}, launches {counts}")
    if not all(math.isfinite(v) for v in losses) or any(counts.values()):
        fail(f"identity run: losses {losses}, launches {counts}")
    check_params_finite(opt, "identity")
    del opt

    small_reference_check(group)
    return {"block_quantize": main_counts["block_quantize"],
            "block_dequant_sum": main_counts["block_dequant_sum"],
            "cast_sum": cast_counts["cast_sum"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs the "
              "port on the card", file=sys.stderr)
        return 2
    from pytorch_ps_mpi_tpu_torch.ops import _build

    # --- 1. environment ---
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__},"
          f" CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")
    card = card_line()
    print(f"[env] {card}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("[env] TF32 off: torch.backends.cudnn.allow_tf32=False, "
          "torch.backends.cuda.matmul.allow_tf32=False (the model's "
          "convolutions run in bf16; the f32 head and the small reference "
          "check run in full f32)")
    t0 = time.perf_counter()
    path, log = _build.build()
    _build.library()
    print(f"[env] built {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[env] nvcc: {line.strip()}")

    # --- 2. kernels against their plain versions ---
    from pytorch_ps_mpi_tpu_torch.models import build_model, resnet18

    named, _ = build_model(resnet18(), seed=0)
    sizes = [p.numel() for p in named.values()]
    errs = check_kernels(sizes)
    times = time_kernels(sizes)

    # --- 3. the slice ---
    launches = run_slice()

    # --- 4. results ---
    kernels = [{"name": k, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[k], "launches": launches[k],
                "max_abs_err": errs[k], "ms": times[k]["ms"],
                "plain_ms": times[k]["plain_ms"],
                "bound_ms": times[k]["bound_ms"], "bound_by": "bytes",
                "library_ms": times[k]["library_ms"]} for k in REPLACES]
    import torch.distributed as dist

    dist.destroy_process_group()
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
