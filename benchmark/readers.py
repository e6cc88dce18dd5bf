"""Arithmetic the metric readers (benchmark/metrics/<name>.py) share.
Each reader returns None where its cell gives it nothing to read; the
harness then leaves the metric out of the line."""
from __future__ import annotations

import math
import statistics

from .counts import bounds

H100_FP32_FLOPS = bounds.FP32_FLOP_PER_S


def symbols_per_s(run, kind: str):
    """Symbols of every call the window completed over the window, for an
    entry of `kind` ("decode" or "detect")."""
    if run.entry.kind != kind or not run.calls:
        return None
    return len(run.calls) * run.entry.symbols_per_call / run.window_s


def quantile_ms(run, q: float, field: str = "done"):
    """The nearest-rank q-quantile of the calls' host ms from issue to
    `field` ("done": the answer on the host; "enqueued": the issue
    returned)."""
    if not run.calls:
        return None
    ms = sorted(1e3 * (c[field] - c["issue"]) for c in run.calls)
    return ms[max(0, math.ceil(q * len(ms)) - 1)]


def median_ms(run, field: str, kind: str):
    if run.entry.kind != kind or not run.calls:
        return None
    return statistics.median(1e3 * (c[field] - c["issue"])
                             for c in run.calls)


def mfu_pct(run, kind: str):
    """The FLOPs of the calls completed (the frozen count, at each call's
    own BP iterations) over the window, against one H100's fp32 peak."""
    if run.entry.kind != kind or not run.calls:
        return None
    fl = sum(run.entry.flops(c["answer"]) for c in run.calls)
    return 100.0 * fl / run.window_s / H100_FP32_FLOPS


def idle_pct(run, kind: str):
    """The share of the traced window in which no device operation ran."""
    if run.entry.kind != kind or run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def roofline_pct(run, kind: str, kernel: str, match, work) -> float | None:
    """A kernel's bound over its device time in the trace: `work(shape,
    answer)` is one launch's bound in seconds, the shapes are the entry's
    launches of `kernel` in one call. Launches the trace lost are left out
    of both sides: the bound is scaled by the launches the trace holds."""
    if run.entry.kind != kind or run.trace is None:
        return None
    shapes = run.entry.launches().get(kernel, [])
    if not shapes:
        return None
    t, n = run.trace.kernel_time(match)
    if n == 0 or t <= 0.0:
        return None
    expected = len(shapes) * len(run.trace.answers)
    bound = sum(work(s, a, len(shapes)) for a in run.trace.answers
                for s in shapes)
    return 100.0 * bound * (n / expected) / t
