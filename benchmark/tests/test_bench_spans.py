"""The readers of the program's own spans and records
(benchmark/program_spans.py) on hand-built traces and stats: idle counted
from a call's `mc.step.*` span to its last device operation only, replay
host ms summed per call of the window, medians over calls and samples,
None without a trace, for another kind of cell, or where the program
records nothing of the kind. On the card, at the tiny configurations: the
program's spans stay out of the trace's device operations, only the ESN
fit is timed inside a graph, and every reader reads a number."""
import time
from types import SimpleNamespace

import pytest

from benchmark import manifest, program_spans
from benchmark.trace import Trace

MS = 1_000_000          # ns


def _run(trace, kind="decode", calls=()):
    return SimpleNamespace(entry=SimpleNamespace(kind=kind), trace=trace,
                           calls=list(calls))


def _trace(ops, spans):
    calls = [s for s in spans if s[0] == "bench.call"]
    window = (min(c[1] for c in calls), max(c[2] for c in calls))
    return Trace(ops, spans, window, [{} for _ in calls])


def _two_calls():
    """Two traced calls of 100 ms. Call 1: step 10-60 ms (its host span
    closes with the card's work queued), busy 20-50, 55-70 and 80-95, the
    call's last operation ending at 95: idle 10 + 5 + 10 = 25 ms (the 10 ms
    before the step and the 5 after the last operation do not count). Call
    2: step 110-150, busy 101-200: no idle."""
    spans = [("bench.call", 0, 100 * MS), ("mc.step.cdl_point", 10 * MS,
                                           60 * MS),
             ("graph.replay.cdl.cal", 12 * MS, 14 * MS),
             ("mc.stage", 11 * MS, 12 * MS),
             ("bench.call", 100 * MS, 200 * MS),
             ("mc.step.cdl_point", 110 * MS, 150 * MS),
             ("graph.replay.cdl.cal", 120 * MS, 130 * MS)]
    ops = [("k", 20 * MS, 50 * MS), ("k", 55 * MS, 70 * MS),
           ("k", 80 * MS, 95 * MS), ("k", 101 * MS, 200 * MS)]
    return _trace(ops, spans)


def test_step_idle_counts_idle_from_the_step_to_the_calls_last_op():
    t = _two_calls()
    # calls read 25 and 0 ms: the median of two is their mean
    assert program_spans.step_idle_ms(_run(t), "decode") == pytest.approx(
        12.5)
    one = _trace(t.ops[:3], t.spans[:4])
    assert program_spans.step_idle_ms(_run(one), "decode") == pytest.approx(
        25.0)
    # a call with no step span or no operation reads nothing
    none = _trace(t.ops[:3], [t.spans[0]])
    assert program_spans.step_idle_ms(_run(none), "decode") is None


# the window's calls on the host's clock (s), and replay samples (start s,
# host ms) of two bodies: call 1 holds 2 + 3 ms, call 2 holds 30 + 5 ms
# and call 3 1 ms; the sample at 0.5 s (the warm-up) and at 9 s (a traced
# call) lie in no call
CALLS = [{"issue": 1.0, "enqueued": 1.2}, {"issue": 2.0, "enqueued": 2.5},
         {"issue": 3.0, "enqueued": 3.1}]
HOST = {"cdl.cal": {"host": [(0.5, 50.0), (1.0, 2.0), (2.1, 30.0),
                             (3.05, 1.0), (9.0, 70.0)], "host_since": 0.0},
        "cdl.fit": {"host": [(1.1, 3.0), (2.4, 5.0)], "host_since": 0.0}}


def test_replay_host_ms_sums_each_call_then_takes_the_median(monkeypatch):
    from esn_ofdm_mimo_tpu_torch.pipelines import graphs
    monkeypatch.setattr(graphs, "body_stats", lambda: HOST)
    run = _run(_two_calls(), calls=CALLS)
    assert program_spans.replay_host_ms(run, "decode") == pytest.approx(5.0)
    assert program_spans.replay_host_ms(
        _run(_two_calls(), calls=CALLS[:2]), "decode") == pytest.approx(20.0)
    # a body that dropped samples up to 1.5 s leaves call 1 out
    cut = {**HOST, "cdl.fit": {**HOST["cdl.fit"], "host_since": 1.5}}
    monkeypatch.setattr(graphs, "body_stats", lambda: cut)
    assert program_spans.replay_host_ms(run, "decode") == pytest.approx(18.0)


def test_no_trace_no_span_or_another_kind_reads_none(monkeypatch):
    t = _two_calls()
    assert program_spans.step_idle_ms(_run(None), "decode") is None
    assert program_spans.step_idle_ms(_run(t, "detect"), "decode") is None
    bare = _trace(t.ops, [s for s in t.spans if s[0] == "bench.call"])
    assert program_spans.step_idle_ms(_run(bare), "decode") is None
    from esn_ofdm_mimo_tpu_torch.pipelines import graphs
    monkeypatch.setattr(graphs, "body_stats", lambda: HOST)
    assert program_spans.replay_host_ms(_run(None, calls=CALLS),
                                        "decode") is None
    assert program_spans.replay_host_ms(_run(t, "detect", CALLS),
                                        "decode") is None
    monkeypatch.setattr(graphs, "body_stats", lambda: {})
    assert program_spans.replay_host_ms(_run(t, calls=CALLS),
                                        "decode") is None
    assert program_spans.body_ms(_run(None), "decode", "cdl.fit") is None
    assert program_spans.phase_ms(_run(None), "decode", "esn_fit",
                                  ("cdl.cal",)) is None


STATS = {"cdl.fit": {"replays": 4, "captures": 1, "dropped": 0,
                     "device_ms": [51.0, 49.0, 60.0], "phase_ms": {}},
         "cdl.cal": {"replays": 9, "captures": 1, "dropped": 2,
                     "device_ms": [30.0],
                     "phase_ms": {"synth": [3.0], "esn_fit": [5.0, 7.0]}},
         "cdl.detect": {"replays": 19, "captures": 1, "dropped": 5,
                        "device_ms": [31.0],
                        "phase_ms": {"esn_fit": [6.0, 9.0, 4.0]}}}


def test_body_readers_take_medians_of_the_samples(monkeypatch):
    from esn_ofdm_mimo_tpu_torch.pipelines import graphs
    monkeypatch.setattr(graphs, "body_stats", lambda: STATS)
    run = _run(_two_calls())
    assert program_spans.body_ms(run, "decode", "cdl.fit") == 51.0
    assert program_spans.body_ms(run, "decode", "nbf.round") is None
    # pooled over the bodies that mark the phase: 4 5 6 7 9
    assert program_spans.phase_ms(run, "decode", "esn_fit",
                                  ("cdl.cal", "cdl.detect")) == 6.0
    assert program_spans.phase_ms(run, "decode", "esn_fit",
                                  ("nbf.round",)) is None
    assert program_spans.body_ms(_run(None), "decode", "cdl.fit") is None
    for name in ("calib_fit_ms.decode", "esn_fit_ms.decode"):
        assert manifest.metric(name).read(run) in (51.0, 6.0)
    assert manifest.metric("esn_fit_ms.detect").read(run) is None


def test_a_program_without_body_stats_reads_none(monkeypatch):
    from esn_ofdm_mimo_tpu_torch.pipelines import graphs
    monkeypatch.delattr(graphs, "body_stats")
    run = _run(_two_calls(), calls=CALLS)
    assert program_spans.body_ms(run, "decode", "cdl.fit") is None
    assert program_spans.phase_ms(run, "decode", "esn_fit",
                                  ("cdl.cal",)) is None
    assert program_spans.replay_host_ms(run, "decode") is None


def _card_calls(route, dev):
    """(a traced call's function, the bodies it replays) of a tiny route on
    the card."""
    import torch
    from torch.profiler import record_function

    from benchmark.tests.tiny import tiny_configs
    from esn_ofdm_mimo_tpu_torch.parallel import montecarlo as tmc
    from esn_ofdm_mimo_tpu_torch.pipelines import cdl
    from esn_ofdm_mimo_tpu_torch.utils import rng
    cfgs = tiny_configs()

    def keys(j, rounds):
        ids = torch.arange(j * rounds * 4, (j + 1) * rounds * 4, device=dev)
        return rng.block_keys(rng.prng_key(5, dev), 0, ids).reshape(
            rounds, 4, 2)

    if route == "point":
        step = tmc.make_fused_cdl_snr_step(cfgs["tiny_cdl"], dev)

        def issue(j):
            k = keys(j, 3)
            return tmc.host_point(step(12.0, k[:1], k[1:]))
        bodies = ("cdl.cal", "cdl.fit", "cdl.detect", "cdl.decode")
    elif route == "round":
        step = tmc.make_sharded_nbf_step(cfgs["tiny_nbf"], dev)

        def issue(j):
            return tmc._host_nbf(step(12.0, keys(j, 1)[0]))
        bodies = ("nbf.round",)
    else:
        def issue(j):
            errs, _ = cdl.run_cdl_cal_counters_chunks(cfgs["tiny_cdl"], 12.0,
                                                      keys(j, 2))
            return {d: int(v) for d, v in errs.items()}
        bodies = ("chunk.cal",)

    def call(j):
        with record_function("bench.call"):
            return issue(j + 1)
    calls = []

    def timed(j):
        a = time.perf_counter()
        issue(j + 10)
        calls.append({"issue": a, "enqueued": time.perf_counter()})
    issue(0)                                  # captures the graphs
    for j in range(2):
        timed(j)
    return call, bodies, calls


@pytest.mark.card
@pytest.mark.parametrize("route", ["point", "round", "chunks"])
def test_program_spans_stay_out_of_the_device_ops(card, route):
    from benchmark import trace as tr
    from esn_ofdm_mimo_tpu_torch.pipelines import graphs
    call, bodies, calls = _card_calls(route, card)
    t = tr.traced_calls(call, 2)
    prefixes = ("mc.", "graph.")
    assert not [n for n, _, _ in t.ops if n.startswith(prefixes)]
    names = {s[0] for s in t.spans}
    assert any(n.startswith("mc.step.") for n in names)
    assert {f"graph.replay.{b}" for b in bodies} <= names
    stats = graphs.body_stats()
    kind = "detect" if route == "chunks" else "decode"
    run = _run(t, kind, calls)
    assert program_spans.replay_host_ms(run, kind) > 0.0
    assert program_spans.step_idle_ms(run, kind) >= 0.0
    for b in bodies:
        assert len(stats[b]["device_ms"]) >= 2
        assert program_spans.body_ms(run, kind, b) > 0.0
        # only the ESN fit's ends are captured into a graph
        assert set(stats[b]["phase_ms"]) <= {"esn_fit"}
    assert "esn_fit" not in stats.get("cdl.fit", {}).get("phase_ms", {})
    assert program_spans.phase_ms(run, kind, "esn_fit", bodies) > 0.0
