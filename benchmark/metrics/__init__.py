"""One reader a metric: `benchmark/metrics/<metric name>.py` defines
`read(run)`, the metric's value in this run or None where the cell gives
it nothing to read (benchmark/run.py:Run holds what it reads)."""
