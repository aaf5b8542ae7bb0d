"""What a traced stretch of the window shows: device time by kernel
category, the device's busy time as the union of its intervals, and the
longest idle gaps with what the host was doing in each.

The category table is a copy of the port's ``chip_smoke.py::_CATEGORIES``:
a kernel falls in the first category one of whose keys its lower-cased
name contains, else in "elementwise/other".
"""

from __future__ import annotations

CATEGORIES = (
    ("block_quantize", ("block_quantize_kernel",)),
    ("block_dequant_sum", ("dequant_sum_group_kernel",)),
    ("cast_sum", ("cast_sum_group_kernel",)),
    ("flash_fwd", ("flash_fwd_",)),
    ("flash_bwd_dkdv", ("flash_bwd_dkdv_",)),
    ("flash_bwd_dq", ("flash_bwd_dq_",)),
    ("nccl", ("nccl",)),
    ("batch norm", ("batch_norm", "batchnorm", "bn_")),
    ("layer norm", ("layer_norm", "layernorm")),
    ("softmax/cross-entropy", ("softmax", "nll_loss")),
    # The models' only f32 matmuls are their heads' (the LM's lm_head:
    # forward, dgrad, wgrad); cuBLAS names its f32 kernels sgemm, f32f32
    # or nvjet_sss.
    ("f32 GEMM (heads)", ("sgemm", "f32f32", "nvjet_sss", "simt")),
    ("conv/matmul", ("conv", "xmma", "gemm", "cudnn", "implicit", "wgrad",
                     "dgrad", "fprop", "sm90", "nvjet", "cutlass")),
)
OTHER = "elementwise/other"
MEMORY = "memcpy/memset"


def category(name: str) -> str:
    low = name.lower()
    if low.startswith(("memcpy", "memset")):
        return MEMORY
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return OTHER


def union_seconds(intervals) -> float:
    """Seconds covered by the union of ``(start, end)`` intervals (any
    unit in, the same unit out), whatever streams they ran on."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(intervals, lo: float, hi: float):
    """The idle stretches of ``[lo, hi]`` that no interval covers, as
    ``(start, end)``."""
    out, at = [], lo
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def _host_at(cpu_events, t: float) -> str:
    """The innermost host operation running at ``t`` (runtime API calls
    give way to the operation that made them), or "host idle"."""
    best = None
    for name, a, b in cpu_events:
        if a <= t < b and (best is None or a >= best[1]):
            best = (name, a, b)
    if best is None:
        return "host idle"
    if best[0].startswith("cuda"):
        outer = [e for e in cpu_events if e[1] <= t < e[2]
                 and not e[0].startswith("cuda")]
        if outer:
            return "launching in " + max(outer, key=lambda e: e[1])[0]
    return best[0]


def summarize(device_events, cpu_events, lo: float, hi: float,
              steps: int) -> dict:
    """``device_events``: ``(name, start_us, end_us)`` of every kernel and
    memory operation; ``cpu_events``: ``(name, start_us, end_us)`` of the
    host's operations; ``[lo, hi]`` the traced stretch (us) over ``steps``
    steps.  Returns per-step device ms by category, the busy and wall
    seconds, and the top device operations and idle gaps (seconds)."""
    inside = [(n, max(a, lo), min(b, hi)) for n, a, b in device_events
              if b > lo and a < hi]
    by_cat, by_name = {}, {}
    for n, a, b in inside:
        us = b - a
        cat = category(n)
        by_cat[cat] = by_cat.get(cat, 0.0) + us
        by_name[n] = by_name.get(n, 0.0) + us
    spans = [(a, b) for _, a, b in inside]
    idle = sorted(gaps(spans, lo, hi), key=lambda g: g[0] - g[1])[:10]
    return {
        "steps": steps,
        "wall_s": (hi - lo) / 1e6,
        "busy_s": union_seconds(spans) / 1e6,
        "kernels_per_step": len(inside) / steps,
        "category_ms": {c: us / steps / 1e3 for c, us in by_cat.items()},
        "device_ops": [[n[:120], us / 1e6] for n, us in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[_host_at(cpu_events, a), (b - a) / 1e6]
                      for a, b in idle],
    }


def from_profiler(prof, lo_name: str, steps: int) -> "dict | None":
    """`summarize` over a ``torch.profiler`` run whose stretch is the host
    span named ``lo_name``, with the program's spans under ``"spans"``
    (`spans.from_profiler`, None where the program opened none); None if
    the profiler saw no device work."""
    from torch.autograd import DeviceType

    from . import spans  # spans reads this module's gaps

    device, cpu, span = [], [], None
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # A host span shows on the device's timeline too, as an
            # annotation that covers its kernels: not device work.
            if not (getattr(e, "is_user_annotation", False)
                    or e.name == lo_name):
                device.append((e.name, a, b))
        elif e.name == lo_name:
            span = (a, b)
        else:
            cpu.append((e.name, a, b))
    if not device or span is None:
        return None
    out = summarize(device, cpu, span[0], span[1], steps)
    out["spans"] = spans.from_profiler(prof, lo_name, steps)
    return out
