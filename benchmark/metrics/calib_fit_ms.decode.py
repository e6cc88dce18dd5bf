"""The calibrator fit's device ms (decode cells): the median over the
traced calls of a `cdl.fit` replay's device ms, from the program's body
clock (CUDA events round the replay)."""
from benchmark.program_spans import body_ms


def read(run):
    return body_ms(run, "decode", "cdl.fit")
