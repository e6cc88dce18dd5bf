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
  * `PhaseClock` sums wall ms per named phase into a dict, synchronising
    the card at each mark.
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


def check_finite(what: str, *tensors: torch.Tensor) -> None:
    """Under `debug_nan_checks`, raise FloatingPointError naming `what` if a
    tensor holds a NaN or an infinity (this synchronises the device)."""
    if not _nan_checks:
        return
    for t in tensors:
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"non-finite values in {what}")
