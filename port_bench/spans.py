"""Each program span in a traced stretch: its host ms and the device ms of
what it launched, a step.

A program span is a host span (``torch.profiler.record_function``, on the
profiler's clock) whose name begins with one of ``PREFIXES``: the port's
sync step opens ``ps.step`` and, inside it in order, ``ps.grad``,
``ps.encode``, ``ps.sync`` and ``ps.update``, and a model may open spans
of its own, ``model.<name>``, inside them.  A span's host ms is its
summed duration over the stretch's steps, a step; its device ms is the
device time of the kernels and memory operations launched while it was
the innermost program span open on the host.  An
operation is tied to the runtime call that launched it by the profiler's
correlation id (the kernel's and the call's ``cudaLaunchKernel``,
``cuLaunchKernelEx``, ``cudaMemcpyAsync`` ... are one number), and the
call's start places it, whichever thread made it: the backward's kernels
are launched from the autograd engine's thread while ``ps.grad`` is open
on the step's.  Operations whose call is not in the trace count toward no
span, and their share of the device time is returned.
"""

from __future__ import annotations

from . import trace

PREFIXES = ("ps.", "model.")
PHASES = ("ps.grad", "ps.encode", "ps.sync", "ps.update")
GAPS = 5   # the longest idle gaps named by their span


def is_span(name: str) -> bool:
    """A program span's name."""
    return name.startswith(PREFIXES)


def is_launch(name: str) -> bool:
    """A CUDA runtime or driver call (the events that carry a launched
    operation's correlation id on the host)."""
    return name.startswith("cu")


def _innermost(spans, t: float) -> "str | None":
    """The program span open at ``t`` that opened last, or None."""
    best = None
    for name, a, b in spans:
        if a <= t < b and (best is None or a >= best[1]):
            best = (name, a)
    return None if best is None else best[0]


def summarize(device_events, host_events, lo: float, hi: float,
              steps: int) -> "dict | None":
    """``device_events``: ``(name, start_us, end_us, correlation)`` of
    every kernel and memory operation; ``host_events``: ``(name,
    start_us, end_us, correlation)`` of the host's events, program spans
    and runtime calls among them; ``[lo, hi]`` the traced stretch (us)
    over ``steps`` steps.  None where no program span lies in the
    stretch.  Else ``host_ms`` and ``device_ms`` a step by span name,
    ``device_ms_all`` (every operation in the stretch), the shares of it
    that no launch was found for (``unmatched``) and that no span
    claimed, those included (``unclaimed``), and the ``GAPS`` longest
    idle gaps as ``[span or "outside", seconds]``."""
    spans = [(n, a, b) for n, a, b, _ in host_events
             if is_span(n) and a >= lo and b <= hi]
    if not spans:
        return None
    launches = {c: a for n, a, _, c in host_events if is_launch(n)}
    host_ms = {}
    for n, a, b in spans:
        host_ms[n] = host_ms.get(n, 0.0) + (b - a) / steps / 1e3
    device_ms = dict.fromkeys(host_ms, 0.0)
    total = unmatched = unclaimed = 0.0
    intervals = []
    for _, a, b, corr in device_events:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        intervals.append((a, b))
        us = b - a
        total += us
        at = launches.get(corr)
        owner = None if at is None else _innermost(spans, at)
        if at is None:
            unmatched += us
        if owner is None:
            unclaimed += us
        else:
            device_ms[owner] += us / steps / 1e3
    idle = sorted(trace.gaps(intervals, lo, hi),
                  key=lambda g: g[0] - g[1])[:GAPS]
    return {
        "host_ms": host_ms,
        "device_ms": device_ms,
        "device_ms_all": total / steps / 1e3,
        "unmatched": unmatched / total if total else 0.0,
        "unclaimed": unclaimed / total if total else 0.0,
        "idle_gaps": [[_innermost(spans, a) or "outside", (b - a) / 1e6]
                      for a, b in idle],
    }


def events(prof, lo_name: str):
    """``(device_events, host_events, stretch)`` of a ``torch.profiler``
    run as `summarize` takes them, ``stretch`` the ``(start, end)`` of the
    host span ``lo_name`` (None if absent).  A host span's shadow on the
    device's timeline (an annotation over its kernels) is not device
    work."""
    from torch.autograd import DeviceType

    device, host, stretch = [], [], None
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not (getattr(e, "is_user_annotation", False)
                    or e.name == lo_name or is_span(e.name)):
                device.append((e.name, a, b, e.id))
        elif e.name == lo_name:
            stretch = (a, b)
        else:
            host.append((e.name, a, b, e.id))
    return device, host, stretch


def from_profiler(prof, lo_name: str, steps: int) -> "dict | None":
    """`summarize` over the stretch that the host span ``lo_name``
    covers; None without it or without program spans."""
    device, host, stretch = events(prof, lo_name)
    if stretch is None:
        return None
    return summarize(device, host, stretch[0], stretch[1], steps)
