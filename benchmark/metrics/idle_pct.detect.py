"""The share of the traced window in which no operation ran on the card
(detect cells): 100 minus the union of the device operations' intervals."""
from benchmark.readers import idle_pct


def read(run):
    return idle_pct(run, "detect")
