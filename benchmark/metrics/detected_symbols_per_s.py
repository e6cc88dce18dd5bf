"""Detected symbols a second: every detection call the window completed
counts its chunks x blocks x (D + 1) symbols, over the window's length."""
from benchmark.readers import symbols_per_s


def read(run):
    return symbols_per_s(run, "detect")
