"""The traced part of a `--trace 1` run: a few calls of the cell under
torch.profiler, reduced to what the per-layer readers and the result's
`breakdown` take: the device's operations with their intervals, the
harness's own spans (one a call, and `keys`, `issue`, `read` inside it),
the busy and idle time of the traced window.

The card's trace (CUPTI) loses the records of its last milliseconds when
the profiler stops right after the synchronize, so it waits `SETTLE_S`
before it stops (the program's chip_smoke.py found this on the same
card).
"""
from __future__ import annotations

import collections
import time
from typing import NamedTuple

SETTLE_S = 0.3
SPANS = ("bench.call", "bench.keys", "bench.issue", "bench.read")


class Trace(NamedTuple):
    ops: list          # [(name, start_ns, end_ns)] device operations
    spans: list        # [(name, start_ns, end_ns)] host spans and aten ops
    window: tuple      # (start_ns, end_ns): first call's start to last end
    answers: list      # the traced calls' answers

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals inside the
        window, as sorted disjoint (start, end) pairs."""
        lo, hi = self.window
        out = []
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_time(self, match) -> tuple:
        """(seconds, launches) of the device operations whose name
        `match(name)` accepts."""
        t = n = 0
        for name, s, e in self.ops:
            if match(name):
                t += e - s
                n += 1
        return t / 1e9, n

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took the most time, by name, and the
        longest idle gaps inside the window, each named by the innermost
        host span or operation open at its middle."""
        per = collections.defaultdict(int)
        for name, s, e in self.ops:
            per[name] += e - s
        ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        lo, hi = self.window
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, t / 1e9] for n, t in ops],
                "idle_gaps": [[self._host_at((s + e) // 2), (e - s) / 1e9]
                              for s, e in gaps]}

    def _host_at(self, t: int) -> str:
        best = None
        for name, s, e in self.spans:
            if s <= t <= e and (best is None or e - s < best[2] - best[1]):
                best = (name, s, e)
        return best[0] if best else "no host span"


def traced_calls(run_call, n_calls: int) -> Trace:
    """Run `run_call(j)` for j < n_calls under torch.profiler (host and
    device activity) and reduce the trace. `run_call` opens the SPANS
    itself and returns the call's answer."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    answers = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for j in range(n_calls):
            answers.append(run_call(j))
        torch.cuda.synchronize()
        time.sleep(SETTLE_S)
    ops, spans, calls = [], [], []
    for e in prof.profiler.kineto_results.events():
        iv = (e.name(), e.start_ns(), e.end_ns())
        if e.device_type() == DeviceType.CUDA:
            # the harness's spans appear on the device's timeline too
            if not e.is_user_annotation() and e.name() not in SPANS:
                ops.append(iv)
        else:
            spans.append(iv)
            if e.name() == "bench.call":
                calls.append(iv)
    if len(calls) != n_calls:
        raise RuntimeError(f"the trace holds {len(calls)} of {n_calls} "
                           f"calls' spans")
    window = (min(c[1] for c in calls), max(c[2] for c in calls))
    return Trace(ops, spans, window, answers)
