"""The 90th percentile (nearest rank) of a call's wall: from issuing it to
its answer on the host, over every call the window completed."""
from benchmark.readers import quantile_ms


def read(run):
    return quantile_ms(run, 0.9)
