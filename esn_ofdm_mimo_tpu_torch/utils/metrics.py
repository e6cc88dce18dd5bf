"""Structured JSONL event log, profiler hook and non-finite guard (port of
esn_ofdm_mimo_tpu/utils/metrics.py).

  * `MetricsLogger` appends one JSON object per event to a .jsonl file and
    mirrors it to stdout: the same records as the JAX package's;
  * `profile_trace` wraps a region in a `torch.profiler.record_function`
    annotation and, if a trace directory is given, records a torch.profiler
    trace of it (CPU, and CUDA where there is a card) and exports it in the
    Chrome trace format;
  * `debug_nan_checks` is the counterpart of `jax_debug_nans`. PyTorch has
    no switch that checks every forward result (`set_detect_anomaly` only
    covers autograd, which only the classifier zoo's training uses), so the
    guard is a check the curve runners call on what feeds their counters:
    inside the context `check_finite` raises FloatingPointError at the
    first tensor holding a NaN or an infinity, outside it is free;
  * `span` is a `record_function` range while a torch.profiler trace is
    recording and a shared no-op context otherwise: the program's own
    spans (`mc.*`, `graph.*`) land in the same trace as the card's kernels,
    on its clock, and cost one flag test when nothing traces;
  * `PhaseClock` sums wall ms per named phase into a dict, synchronising
    the card at each mark; `EventClock` sums the card's time between CUDA
    events per phase, read once at the end (no sync inside a run). Its
    events can be captured into a CUDA graph (`external`), where each
    replay records them again, and read without blocking (`ready`,
    `phases`): the graphs' body clock (pipelines/graphs.py).
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional

import torch


class PhaseClock:
    """Wall time per phase, in ms, synchronising the device at each mark;
    with `out` None it does nothing."""

    def __init__(self, dev: torch.device, out):
        self.dev, self.out = dev, out
        self.t = self._now() if out is not None else 0.0

    def _now(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        return time.perf_counter()

    def mark(self, name: str):
        if self.out is None:
            return
        t = self._now()
        self.out[name] = self.out.get(name, 0.0) + 1e3 * (t - self.t)
        self.t = t


class EventClock:
    """Time per phase, in ms, without syncing the host: on the card a CUDA
    event recorded at each mark, read by `flush` (which waits for the last
    one) once the caller has the results; on the CPU the wall time at each
    mark. `flush` adds each phase's ms into `out`; with `out` None it
    does nothing.

    With `external`, the events are made to be captured: recorded inside a
    CUDA graph's capture, each becomes an event-record node that every
    replay records again, and `ready` and `phases` read the last replay's
    marks without blocking. Without `begin` the clock starts at its first
    mark, whose own phase is not timed."""

    def __init__(self, dev: torch.device, out, external: bool = False,
                 begin: bool = True):
        self.dev, self.out, self.marks = dev, out, []
        self.external = external
        self.t0 = self._stamp() if out is not None and begin else None

    def _event(self):
        return torch.cuda.Event(enable_timing=True, external=self.external)

    def _stamp(self):
        if self.dev.type != "cuda":
            return time.perf_counter()
        ev = self._event()
        ev.record()
        return ev

    def ready(self) -> bool:
        """Whether every mark has been reached (never blocks; always on the
        CPU)."""
        return self.dev.type != "cuda" or all(
            ev.query() for _, ev in self.marks)

    def phases(self) -> list:
        """[(phase, ms)]: each mark's time since the one before it (the
        first since the clock was made). On the card the marks must be
        `ready`, or CUDA raises."""
        out, prev = [], self.t0
        for name, t in self.marks:
            out.append((name, prev.elapsed_time(t) if self.dev.type == "cuda"
                        else 1e3 * (t - prev)))
            prev = t
        return out

    def mark(self, name: str):
        if self.out is None:
            return
        if self.t0 is None:
            self.t0 = self._stamp()
        else:
            self.marks.append((name, self._stamp()))

    def flush(self):
        if self.out is None or not self.marks:
            return
        if self.dev.type == "cuda":
            self.marks[-1][1].synchronize()
        for name, ms in self.phases():
            self.out[name] = self.out.get(name, 0.0) + ms
        self.marks, self.t0 = [], self.marks[-1][1]


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a", buffering=1)
        else:
            self._f = None

    def log(self, event: str, **fields: Any) -> Dict[str, Any]:
        rec = {"t": time.time(), "event": event, **fields}
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
        if self.echo:
            kv = " ".join(f"{k}={v}" for k, v in fields.items())
            print(f"[{event}] {kv}", flush=True)
        return rec

    def close(self) -> None:
        if self._f:
            self._f.close()


_NO_SPAN = contextlib.nullcontext()


def tracing() -> bool:
    """Whether a torch.profiler trace is recording (torch's own Python
    flag, set while a profiler runs)."""
    return torch.autograd.profiler._is_profiler_enabled


def span(name: str):
    """`torch.profiler.record_function(name)` while a trace is recording,
    so the range lands in the trace beside the card's kernels and on their
    clock; otherwise a shared no-op context."""
    if tracing():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def profile_trace(name: str, trace_dir: Optional[str] = None):
    """Annotate a host-side region; with `trace_dir`, record a profiler
    trace of it into `<trace_dir>/<name>.trace.json` (tracing has overhead:
    profiling runs only)."""
    if not trace_dir:
        with torch.profiler.record_function(name):
            yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in name)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(name):
            yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"{safe}.trace.json"))


_nan_checks = False


@contextlib.contextmanager
def debug_nan_checks(enabled: bool = True):
    """Within the context `check_finite` raises on non-finite values."""
    global _nan_checks
    prev, _nan_checks = _nan_checks, bool(enabled) or _nan_checks
    try:
        yield
    finally:
        _nan_checks = prev


def nan_checks_enabled() -> bool:
    """Whether a `debug_nan_checks` context is active."""
    return _nan_checks


def check_finite(what: str, *tensors: torch.Tensor) -> None:
    """Under `debug_nan_checks`, raise FloatingPointError naming `what` if a
    tensor holds a NaN or an infinity (this synchronises the device)."""
    if not _nan_checks:
        return
    for t in tensors:
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"non-finite values in {what}")
