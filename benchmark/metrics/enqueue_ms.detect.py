"""The median host ms from issuing a call to the entry's return, before
its answer is read: the Monte-Carlo loop's enqueue of the graph
replays and their buffer copies (detect cells)."""
from benchmark.readers import median_ms


def read(run):
    return median_ms(run, "enqueued", "detect")
