"""The zoo's training's device ms a call: per sampled `zoo.round` replay,
the ms from the end of `detect` to the end of `elm` (the CNN's, the GRU's
and the FNN's Adam steps and the ELM's closed-form fit), from the event
marks captured in its graph; the median over the replays."""
import statistics

from benchmark.program_spans import body_stats

PHASES = ("cnn", "rnn", "fnn", "elm")


def read(run):
    stats = body_stats(run, "detect")
    if not stats or "zoo.round" not in stats:
        return None
    ms = stats["zoo.round"]["phase_ms"]
    if not all(ms.get(p) for p in PHASES):
        return None
    return statistics.median(sum(v) for v in zip(*(ms[p] for p in PHASES)))
