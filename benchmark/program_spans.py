"""Arithmetic of the per-layer metrics that read what the program records
of itself in a traced run: its host spans in the trace (`mc.step.*` round
a fused step's body; utils/metrics.py:span) and its graphs' records
(pipelines/graphs.py:body_stats: each replay's host ms on the host's
clock, taken in the untraced window too; each traced replay's device ms
from CUDA events round it; the ESN fit's ms from event-record nodes
captured in the graph).

Each reader returns None without a trace (and so on the CPU), for a cell
of another kind, or where the program records no such span or body (a
program from before them): the harness then leaves the metric out."""
from __future__ import annotations

import bisect
import statistics

CALL = "bench.call"


def _median(values):
    values = list(values)
    return statistics.median(values) if values else None


def body_stats(run, kind: str):
    """The program's body_stats() in a traced run of a `kind` cell, or
    None."""
    if run.entry.kind != kind or run.trace is None:
        return None
    from esn_ofdm_mimo_tpu_torch.pipelines import graphs
    stats = getattr(graphs, "body_stats", None)
    return stats() if stats is not None else None


def body_ms(run, kind: str, body: str):
    """The median device ms of a traced replay of `body`."""
    stats = body_stats(run, kind)
    if not stats or body not in stats:
        return None
    return _median(stats[body]["device_ms"])


def phase_ms(run, kind: str, phase: str, bodies: tuple):
    """The median ms of `phase` over the sampled replays of the `bodies`
    that mark it."""
    stats = body_stats(run, kind)
    if not stats:
        return None
    return _median(ms for b in bodies if b in stats
                   for ms in stats[b]["phase_ms"].get(phase, ()))


def replay_host_ms(run, kind: str):
    """Per call of the untraced window, the host ms of the graph replays it
    issued (each replay's launch, and any wait inside it, on the host's
    clock); the median over the calls whose replays the bodies still hold.
    None where the program keeps no replay samples."""
    stats = body_stats(run, kind)
    if not stats:
        return None
    samples = sorted(s for b in stats.values() for s in b.get("host", ()))
    if not samples:
        return None
    since = max(b.get("host_since", 0.0) for b in stats.values())
    starts = [t for t, _ in samples]
    out = []
    for c in run.calls:
        if c["issue"] > since:
            lo = bisect.bisect_left(starts, c["issue"])
            hi = bisect.bisect_right(starts, c["enqueued"])
            out.append(sum(ms for _, ms in samples[lo:hi]))
    return _median(out)


def idle_ns(busy: list, lo: int, hi: int) -> int:
    """ns of [lo, hi] that the sorted disjoint busy intervals leave idle."""
    covered = sum(max(0, min(e, hi) - max(s, lo)) for s, e in busy)
    return (hi - lo) - covered


def step_idle_ms(run, kind: str):
    """Per traced call, the ms of device idle (the gaps between the trace's
    busy intervals) from the start of its first `mc.step.*` span to the end
    of the last device operation that started inside the call; the median
    over calls. The step's host span closes when the entry returns, with
    the card's work still queued; the call's last operation is where the
    card finishes it."""
    if run.entry.kind != kind or run.trace is None:
        return None
    t = run.trace
    busy = t.busy_intervals()
    steps = [s for s in t.spans if s[0].startswith("mc.step.")]
    out = []
    for call in (s for s in t.spans if s[0] == CALL):
        lo = min((s[1] for s in steps
                  if call[1] <= s[1] and s[2] <= call[2]), default=None)
        hi = max((e for _, s, e in t.ops if call[1] <= s <= call[2]),
                 default=None)
        if lo is not None and hi is not None and hi > lo:
            out.append(idle_ns(busy, lo, hi) / 1e6)
    return _median(out)
