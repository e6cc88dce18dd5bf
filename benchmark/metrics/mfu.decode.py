"""The whole step's share of one H100's fp32 peak (decode cells): the
frozen FLOP count of the calls the window completed over the window."""
from benchmark.readers import mfu_pct


def read(run):
    return mfu_pct(run, "decode")
