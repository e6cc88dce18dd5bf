"""The host ms a call spends replaying graphs (detect cells): per call of
the untraced window, the host ms of the graph replays it issued, from the
program's replay counters (pipelines/graphs.py:body_stats); the median
over calls. Read in a traced run, where the program's records are read."""
from benchmark.program_spans import replay_host_ms


def read(run):
    return replay_host_ms(run, "detect")
