"""The arithmetic behind the metrics' readers (``metrics/<name>.py``).

Each reader takes the run's record (`harness.record`) and returns a number,
or None where it finds nothing to read (then the metric is left out of
the line; a share of a peak or a roofline is never given as 0).  A
program span or counter is read by name (`span_ms`, `counter`), so a
reader of one that the program adds is a file of its own and nothing else.
"""

from __future__ import annotations

import statistics

from . import flops, harness, peaks

MODEL_CATEGORIES = ("conv/matmul", "f32 GEMM (heads)", "batch norm",
                    "layer norm", "softmax/cross-entropy")
ATTENTION_CATEGORIES = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
CODEC_CATEGORIES = ("block_quantize", "block_dequant_sum")


def rate(rec: dict) -> float:
    """Items (images or tokens) of every rank's steps in the window over
    the window's seconds."""
    return rec["items_per_step"] * rec["steps"] / rec["window_s"]


def step_ms_p95(rec: dict) -> float:
    return harness.p95(rec["step_ms"])


def setup_s(rec: dict) -> float:
    return rec["setup_s"]


def host_ms(rec: dict) -> float:
    """Mean host time to issue one queued step (rank 0's ``isend_time``)
    over the window's steps."""
    return statistics.fmean(rec["host_ms"])


def mfu(rec: dict) -> float:
    """Model FLOPs of the window's steps over the window (not traced) over
    the bf16 peak, in percent, per chip."""
    return (100.0 * rec["step_flops"] * rec["steps"] / rec["window_s"]
            / peaks.BF16_FLOPS)


def _category_ms(rec: dict, cats) -> "float | None":
    prof = rec.get("profile")
    if not prof:
        return None
    ms = sum(prof["category_ms"].get(c, 0.0) for c in cats)
    return ms if ms > 0 else None


def model_device_ms(rec: dict) -> "float | None":
    return _category_ms(rec, MODEL_CATEGORIES)


def attention_roofline(rec: dict) -> "float | None":
    ms = _category_ms(rec, ATTENTION_CATEGORIES)
    if ms is None:
        return None
    bound = flops.attention_bound_s(rec["config"], rec["traffic"])
    return 100.0 * bound * 1e3 / ms


def codec_roofline(rec: dict) -> "float | None":
    ms = _category_ms(rec, CODEC_CATEGORIES)
    if ms is None:
        return None
    bound = flops.codec_bound_s(rec["leaf_sizes"], rec["traffic"]["bits"],
                                rec["world"])
    return 100.0 * bound * 1e3 / ms


def device_idle(rec: dict) -> "float | None":
    """The share of the traced stretch in which no kernel or memory
    operation ran on the device (the union over streams), in percent;
    the mean over ranks."""
    prof = rec.get("profile")
    if not prof or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["wall_s"])


def span_ms(span: str, kind: str):
    """The reader of the program span ``span``'s ``kind`` ms a traced step
    (``host_ms`` or ``device_ms``: `spans.summarize`), the mean over
    ranks; it reads None without a trace or without that span."""
    def read(rec: dict) -> "float | None":
        prof = rec.get("profile")
        spans = prof.get("spans") if prof else None
        return spans[kind].get(span) if spans else None
    return read


def counter(name: str):
    """The reader of the number ``name`` of the window's last step's
    metrics (rank 0's), None where the step has no such key."""
    def read(rec: dict) -> "float | None":
        return rec.get("step_metrics", {}).get(name)
    return read
