"""Decoded symbols a second: every call the window completed counts its
rounds x blocks x (D + 1) symbols, over the window's length."""
from benchmark.readers import symbols_per_s


def read(run):
    return symbols_per_s(run, "decode")
