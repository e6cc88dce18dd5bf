"""The GRU's training's device ms a call (the zoo cell): the median `rnn`
phase of the sampled `zoo.round` replays (50 Adam steps, each a K7 launch
and the update), from the event marks captured in its graph."""
from benchmark.program_spans import phase_ms


def read(run):
    return phase_ms(run, "detect", "rnn", ("zoo.round",))
