"""The port's spans, replay counters and body clock (utils/metrics.py:span,
EventClock; pipelines/graphs.py:Body, body_stats) on the CPU, where the
bodies run eagerly and the body clock takes the host's clock:

  * under a CPU torch.profiler, a tiny fused CDL point, NBF round and
    detection-chunk call each open their `mc.step.*` span, with one
    `graph.replay.<body>` span a `Body.run` nested inside it and
    `mc.stage` spans beside them;
  * outside a profiler `span` never enters `record_function`;
  * `body_stats()` counts replays and captures, keeps a host sample of
    every replay, and its phases come in the body's order, `esn_fit`
    between `synth` and `detect`;
  * a captured body's phase marks that are not complete when the next
    replay is issued are dropped and counted, never waited on; the device
    ms pairs wait for a later harvest;
  * a body keeps its newest HOST_SAMPLES host samples and says from when
    they are complete; a released body's record leaves `body_stats()`.
"""
import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from esn_ofdm_mimo_tpu_torch.parallel import montecarlo as tmc
from esn_ofdm_mimo_tpu_torch.pipelines import cdl, graphs
from esn_ofdm_mimo_tpu_torch.utils import metrics, rng
from test_torch_cal_chunks import _jax_cfg, _port_cfg
from test_torch_curve import _cdl_cfg, _nbf_cfg

torch.set_num_threads(1)

G = 2


def _keys(rounds, jj=0):
    ids = torch.arange(rounds * G)
    return rng.block_keys(rng.prng_key(0), jj, ids).reshape(rounds, G, 2)


def _cdl_point():
    k = _keys(3)
    tmc.make_fused_cdl_snr_step(_cdl_cfg(), "cpu")(12.0, k[:1], k[1:])


def _nbf_round():
    tmc.make_sharded_nbf_step(_nbf_cfg(), "cpu")(12.0, _keys(1)[0])


def _chunks():
    cdl.run_cdl_cal_counters_chunks(_port_cfg(_jax_cfg()), 9.0, _keys(2))


CALLS = {"cdl_point": (_cdl_point, {"cdl.cal": 1, "cdl.fit": 1,
                                    "cdl.detect": 2, "cdl.decode": 2}),
         "nbf_rounds": (_nbf_round, {"nbf.round": 1}),
         "cal_chunks": (_chunks, {"chunk.cal": 2})}


def _events(prof):
    """[(name, start us, end us)] of the profiler's host ranges."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()]


def _inside(iv, outer):
    return outer[1] <= iv[1] and iv[2] <= outer[2]


def _count_runs(monkeypatch):
    runs = []
    real = graphs.Body.run

    def run(self):
        runs.append(self.name)
        return real(self)
    monkeypatch.setattr(graphs.Body, "run", run)
    return runs


@pytest.mark.parametrize("route", sorted(CALLS))
def test_step_span_holds_one_replay_span_a_body_run(route, monkeypatch):
    call, want = CALLS[route]
    call()                       # the graph sets exist before the trace
    runs = _count_runs(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    ev = _events(prof)
    steps = [e for e in ev if e[0] == f"mc.step.{route}"]
    assert len(steps) == 1
    replays = [e for e in ev if e[0].startswith("graph.replay.")]
    assert sorted(e[0] for e in replays) == sorted(
        f"graph.replay.{n}" for n in runs)
    assert {n: runs.count(n) for n in set(runs)} == want
    assert all(_inside(e, steps[0]) for e in replays)
    stages = [e for e in ev if e[0] == "mc.stage"]
    assert stages and all(_inside(e, steps[0]) for e in stages)
    # no replay is staged from inside another, and nothing is named
    # like the harness's own spans
    assert not any(_inside(s, r) for s in stages for r in replays)
    assert not any(e[0].startswith("bench.") for e in ev)


def test_span_outside_a_profiler_never_enters_record_function(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _nbf_round()
    with metrics.span("mc.stage"):
        pass
    assert entered == []
    assert not metrics.tracing()
    with profile(activities=[ProfilerActivity.CPU]):
        assert metrics.tracing()
        _nbf_round()
    assert "mc.step.nbf_rounds" in entered
    assert "graph.replay.nbf.round" in entered


def test_body_stats_count_and_order_the_phases(monkeypatch):
    monkeypatch.setattr(graphs, "_RECORDS", [])
    monkeypatch.setattr(graphs, "_CACHE", collections.OrderedDict())
    _nbf_round()                 # untraced: counted, not timed
    with profile(activities=[ProfilerActivity.CPU]):
        _nbf_round()
        _cdl_point()
    stats = graphs.body_stats()
    nbf = stats["nbf.round"]
    assert (nbf["replays"], nbf["captures"], nbf["dropped"]) == (2, 0, 0)
    assert len(nbf["device_ms"]) == 1
    # every replay's host sample, traced or not, in the order issued
    assert len(nbf["host"]) == 2 and nbf["host_since"] == 0.0
    assert nbf["host"][0][0] < nbf["host"][1][0]
    assert all(ms > 0.0 for _, ms in nbf["host"])
    assert list(nbf["phase_ms"]) == ["synth", "esn_fit", "detect", "decode",
                                     "analytics"]
    assert all(len(v) == 1 and v[0] >= 0.0
               for v in nbf["phase_ms"].values())
    for body in ("cdl.cal", "cdl.detect"):
        assert list(stats[body]["phase_ms"]) == [
            "synth", "esn_fit", "detect", "llr"]
    assert stats["cdl.detect"]["replays"] == 2
    assert len(stats["cdl.detect"]["host"]) == 2
    assert stats["cdl.fit"]["phase_ms"] == {}


class _StubEvent:
    """A CUDA event stand-in: recorded, never waited on, complete only once
    the test says so."""
    done = False

    def record(self):
        pass

    def query(self):
        return _StubEvent.done

    def synchronize(self):
        raise AssertionError("the body clock waited on an event")

    def elapsed_time(self, other):
        assert _StubEvent.done
        return 1.5


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_incomplete_marks_are_dropped_not_waited_on(monkeypatch):
    monkeypatch.setattr(graphs, "_RECORDS", [])
    monkeypatch.setattr(metrics.EventClock, "_event",
                        lambda self: _StubEvent())
    monkeypatch.setattr(_StubEvent, "done", False)
    card = torch.device("cuda", 0)

    def capture(fn, dev, name, marks=graphs.CAPTURED_MARKS):
        clock = metrics.EventClock(dev, {}, external=True, begin=False)
        for phase in marks:
            clock.mark(phase)
        return _StubGraph(), 2.0, 512, clock
    monkeypatch.setattr(graphs, "capture_graph", capture)
    body = graphs.Body(lambda mark: None, "nbf.round", card)
    assert (body.capture_ms, body.pool_bytes) == (2.0, 512)
    body.run()                   # untraced: counted only
    monkeypatch.setattr(graphs, "tracing", lambda: True)
    body.run()
    body.run()                   # the last replay's marks are not complete
    stats = graphs.body_stats()["nbf.round"]
    assert (stats["replays"], stats["captures"], stats["dropped"]) == (3, 1, 1)
    assert stats["device_ms"] == [] and stats["phase_ms"] == {}
    assert body.graph.replays == 3
    _StubEvent.done = True
    stats = graphs.body_stats()["nbf.round"]
    assert stats["dropped"] == 1
    assert stats["device_ms"] == [1.5, 1.5]
    # the clock starts at the first captured mark: only esn_fit is timed
    assert stats["phase_ms"] == {"esn_fit": [1.5]}
    assert len(stats["host"]) == 3


def test_host_samples_are_bounded_and_released_with_the_body(monkeypatch):
    monkeypatch.setattr(graphs, "_RECORDS", [])
    monkeypatch.setattr(graphs, "HOST_SAMPLES", 3)
    body = graphs.Body(lambda mark=None: None, "chunk.cal",
                       torch.device("cpu"))
    for _ in range(5):
        body.run()
    stats = graphs.body_stats()["chunk.cal"]
    assert stats["replays"] == 5 and len(stats["host"]) == 3
    # the samples kept are complete for replays after the last one dropped
    starts = [t for t, _ in body.record.host]
    assert 0.0 < stats["host_since"] < starts[0]
    body.release()
    assert graphs.body_stats() == {}
