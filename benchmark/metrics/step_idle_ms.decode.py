"""The card's idle ms inside a fused step (decode cells): per traced call,
the gaps between the device's busy intervals from the start of its
`mc.step.*` span to the end of the call's last device operation, the
median over calls."""
from benchmark.program_spans import step_idle_ms


def read(run):
    return step_idle_ms(run, "decode")
