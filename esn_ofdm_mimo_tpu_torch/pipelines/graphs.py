"""CUDA graphs of the port's rounds: one shared memory pool a card, the
capture with its warm-up, a round's `Body`, and a small cache of captured
graph sets keyed by configuration, blocks a round and card. The CDL and
block-fading pipelines build their round sets from these.

Each body has a name (`cdl.cal`, `cdl.fit`, `cdl.detect`, `cdl.decode`,
`nbf.round`, `chunk.cal`, `zoo.round`) and a record: its replays and
captures, each replay's host ms (the launch, on the host's clock, always),
and, while a torch.profiler trace is recording, its body clock. Every
traced replay gets its device ms from a fresh pair of CUDA events around
it, outside the graph. The body calls `mark(phase)` as each of its phases
ends (`synth`, `esn_fit`, `detect`, ...); of these only the ends of
`synth` and `esn_fit` (`CAPTURED_MARKS`, which time the ESN fit; the zoo
round names its own, pipelines/zoo2x2.py:ZOO_MARKS) are captured into the
graph, as event-record nodes, so every replay records them again and only
a body's last replay before its next is readable; a body without them
captures none. The samples are harvested without blocking, before each replay and
when `body_stats()` is asked: a pair not yet complete waits for a later
harvest; a replay's marks not yet complete when the next replay is issued
are dropped and counted. On the CPU every phase is marked, on the host's
clock. Spans: `graph.replay.<name>` round every replay,
`graph.warmup.<name>` and `graph.capture.<name>` in `capture_graph`.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import time
import traceback

import torch

from ..config import SimConfig
from ..utils.metrics import EventClock, span, tracing


class GraphCaptureError(RuntimeError):
    """A CUDA graph capture failed; the message names the port's line that
    broke it. Deterministic, so never retried."""


# The memory pool every CUDA graph of the port captures into, one a card:
# the graphs replay one after another on one stream, and each reads and
# writes only buffers made outside any capture, so their temporaries may
# share memory. card -> [pool handle, graphs alive in it]: PyTorch frees a
# pool once its last graph is reset, and a handle of a freed pool cannot
# take another capture, so the entry goes with its last graph.
_POOLS: dict = {}


# the phase ends captured into a body's graph: the ESN fit's span
CAPTURED_MARKS = ("synth", "esn_fit")


def _no_mark(phase: str):
    """The phase mark of an untimed run of a body."""


def capture_graph(body, dev: torch.device, name: str,
                  marks: tuple = CAPTURED_MARKS):
    """Run `body(mark)` once eagerly on a side stream with a mark that does
    nothing (the warm-up: nvcc builds, cuFFT plans, codes' host
    construction, the kernels' attribute and occupancy queries, device
    constants), then capture one call of it as a CUDA graph in the card's
    shared pool, the phase ends `marks` as event-record nodes. Returns (graph,
    the capture's host ms, bytes the pool grew by, the marks' EventClock or
    None where the body made none). Raises GraphCaptureError where the
    capture fails, naming the port's line that broke it."""
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with span(f"graph.warmup.{name}"), torch.cuda.stream(side):
        body(_no_mark)
    torch.cuda.current_stream(dev).wait_stream(side)
    if dev not in _POOLS:
        _POOLS[dev] = [torch.cuda.graph_pool_handle(), 0]
    pool = _POOLS[dev]
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    try:
        with span(f"graph.capture.{name}"), \
                torch.cuda.graph(graph, pool=pool[0]):
            # after the capture's own empty_cache: what the body reserves
            # from here on is the pool's growth
            reserved = torch.cuda.memory_reserved(dev)
            clock = EventClock(dev, {}, external=True, begin=False)

            def mark(phase):
                if phase in marks:
                    clock.mark(phase)
            body(mark)
            pool_bytes = torch.cuda.memory_reserved(dev) - reserved
    except Exception as e:
        if not pool[1]:
            del _POOLS[dev]
        here = [f for f in traceback.extract_tb(e.__traceback__)
                if f"{os.sep}esn_ofdm_mimo_tpu_torch{os.sep}" in f.filename]
        at = (f"{here[-1].filename}:{here[-1].lineno} ({here[-1].line})"
              if here else "outside the package")
        raise GraphCaptureError(f"CUDA graph capture of the {name} body "
                                f"failed at {at}: {e}") from e
    pool[1] += 1
    return (graph, 1e3 * (time.perf_counter() - t0), pool_bytes,
            clock if clock.t0 is not None else None)


def _release_graph(graph, dev: torch.device):
    """Reset a graph of `capture_graph`; its card's pool entry goes with
    the last one."""
    graph.reset()
    _POOLS[dev][1] -= 1
    if not _POOLS[dev][1]:
        del _POOLS[dev]


def _card(dev: torch.device) -> torch.device:
    """`dev` with its index: "cuda" names the current card."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def graph_pool_bytes(dev: torch.device) -> int:
    """Device memory of the card's shared graph pool: its segments in the
    caching allocator's snapshot."""
    pool = _POOLS.get(_card(dev))
    if pool is None:
        return 0
    return sum(seg["total_size"]
               for seg in torch.cuda.memory._snapshot()["segments"]
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool[0]))


# the replays' host samples a body keeps, the newest
HOST_SAMPLES = 16384


@dataclasses.dataclass(eq=False)
class BodyRecord:
    """What one Body counts and times: its replays and captures, the
    capture's host ms and pool growth, each replay's host samples (its
    start on the host's perf_counter in s, its host ms; the last
    HOST_SAMPLES, complete for replays that start after `host_since`), and
    the body clock's samples, each traced replay's device ms and its
    phases' ms (phase -> [ms], in the order the body marks them), with the
    replays whose phase marks were dropped."""
    name: str
    replays: int = 0
    captures: int = 0
    capture_ms: float = 0.0
    pool_bytes: int = 0
    dropped: int = 0
    host: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=HOST_SAMPLES))
    host_since: float = 0.0
    device_ms: list = dataclasses.field(default_factory=list)
    phase_ms: dict = dataclasses.field(default_factory=dict)
    marks: EventClock | None = None   # the captured marks (card)
    pending: list = dataclasses.field(default_factory=list)
    marks_pending: bool = False

    def add_host(self, t0: float, t1: float):
        if len(self.host) == self.host.maxlen:
            self.host_since = self.host[0][0]
        self.host.append((t0, 1e3 * (t1 - t0)))

    def add_phases(self, clock: EventClock):
        for phase, ms in clock.phases():
            self.phase_ms.setdefault(phase, []).append(ms)

    def harvest(self, replaying: bool):
        """Read the samples that are complete, without blocking. Issuing a
        replay (`replaying`) records the captured marks again: a last
        replay's marks not yet complete are dropped."""
        if self.pending:
            waiting = []
            for pair in self.pending:
                if pair.ready():
                    self.device_ms.append(pair.phases()[0][1])
                else:
                    waiting.append(pair)
            self.pending = waiting
        if self.marks_pending and self.marks.ready():
            self.add_phases(self.marks)
            self.marks_pending = False
        elif self.marks_pending and replaying:
            self.dropped += 1
            self.marks_pending = False


# every Body's record, read by body_stats()
_RECORDS: list = []


def body_stats() -> dict:
    """name -> {"replays", "captures", "host": [(start s, ms)],
    "host_since", "device_ms": [ms], "phase_ms": {phase: [ms]}, "dropped"}
    over every body alive in the process, the samples harvested first
    (never blocking)."""
    out = {}
    for rec in _RECORDS:
        rec.harvest(replaying=False)
        o = out.setdefault(rec.name, {"replays": 0, "captures": 0,
                                      "host": [], "host_since": 0.0,
                                      "device_ms": [], "phase_ms": {},
                                      "dropped": 0})
        o["replays"] += rec.replays
        o["captures"] += rec.captures
        o["dropped"] += rec.dropped
        o["host"] += rec.host
        o["host_since"] = max(o["host_since"], rec.host_since)
        o["device_ms"] += rec.device_ms
        for phase, ms in rec.phase_ms.items():
            o["phase_ms"].setdefault(phase, []).extend(ms)
    return out


class Body:
    """One body of a round: a function `fn(mark=None)` that reads and
    writes only buffers made before it and calls `mark(phase)`, when
    given, as each of its phases ends. On the card it is captured once as
    a CUDA graph and `run` replays it; on the CPU `run` calls the
    function. `name` names its spans, its record (module docstring) and a
    failed capture. `marks` are the phase ends its graph captures
    (CAPTURED_MARKS unless the body names its own)."""

    def __init__(self, fn, name: str, dev: torch.device,
                 marks: tuple = CAPTURED_MARKS):
        self.fn, self.graph, self.dev, self.name = fn, None, dev, name
        self.record = BodyRecord(name)
        self._replay_span = f"graph.replay.{name}"
        if dev.type == "cuda":
            (self.graph, self.record.capture_ms, self.record.pool_bytes,
             self.record.marks) = capture_graph(fn, dev, name, marks)
            self.record.captures += 1
        _RECORDS.append(self.record)

    @property
    def capture_ms(self) -> float:
        return self.record.capture_ms

    @property
    def pool_bytes(self) -> int:
        return self.record.pool_bytes

    def run(self):
        rec = self.record
        rec.harvest(replaying=True)
        rec.replays += 1
        timed = tracing()
        with span(self._replay_span):
            pair = EventClock(self.dev, {}) if timed else None
            t0 = time.perf_counter()
            if self.graph is not None:
                self.graph.replay()
                rec.marks_pending = timed and rec.marks is not None
            elif timed:
                marks = EventClock(self.dev, {})
                self.fn(marks.mark)
                rec.add_phases(marks)
            else:
                self.fn(_no_mark)
            rec.add_host(t0, time.perf_counter())
            if timed:
                pair.mark("replay")
                rec.pending.append(pair)

    def last_phases(self) -> list:
        """[(phase, ms)] of the captured marks of the last replay, waiting
        for its last mark (a sync of the host; empty on the CPU or without
        marks)."""
        marks = self.record.marks
        if self.graph is None or marks is None or not marks.marks:
            return []
        marks.marks[-1][1].synchronize()
        return marks.phases()

    def release(self):
        if self.graph is not None:
            _release_graph(self.graph, self.dev)
            self.graph = None
        if self.record in _RECORDS:
            _RECORDS.remove(self.record)


# Captured graph sets (a calibration chunk, a CDL round set), the least
# recently used released first past _CACHE_SIZE; `release_graphs` releases
# them all
_CACHE: "collections.OrderedDict[tuple, object]" = collections.OrderedDict()
_CACHE_SIZE = 4


def graph_key(cfg: SimConfig, G: int, dev: torch.device, kind: str,
              layout: tuple = (1, 0)) -> tuple:
    """The cache key of a graph set: (kind, cfg without its Eb/N0 grid,
    which the bodies read from their row buffer, blocks a round on this
    rank, card, the predict switch ESN_TPU_PREDICT_READOUT, which picks K2
    or K4, the layout (ranks W, this rank): a rank's set of G blocks fits
    the pairs of W G blocks). A set is made from its key's cfg, card and
    layout."""
    return (kind, dataclasses.replace(cfg, ebno_db=()), int(G), _card(dev),
            os.environ.get("ESN_TPU_PREDICT_READOUT"),
            tuple(int(v) for v in layout))


def cached_graphs(key: tuple, make):
    """The graph set of `key`, made by `make()` on first use."""
    if key in _CACHE:
        _CACHE.move_to_end(key)
        return _CACHE[key]
    while len(_CACHE) >= _CACHE_SIZE:
        _CACHE.popitem(last=False)[1].release()
    if key[3].type == "cuda":
        with torch.cuda.device(key[3]):
            _CACHE[key] = make()
    else:
        _CACHE[key] = make()
    return _CACHE[key]


def release_graphs():
    """Release every cached graph set: its graphs and their memory."""
    while _CACHE:
        _CACHE.popitem()[1].release()
