"""The ESN fit's device ms a round (decode cells): the median `esn_fit`
phase (K3 and the readout solve of each fit) over the sampled replays of
the bodies that fit an ESN, from the event marks captured in their
graphs."""
from benchmark.program_spans import phase_ms

BODIES = ("cdl.cal", "cdl.detect", "nbf.round", "chunk.cal")


def read(run):
    return phase_ms(run, "decode", "esn_fit", BODIES)
