"""One module a kind of entry: `benchmark/entries/<entry>.py`, named by a
workload file's `entry`. Each defines `Entry(sim, dev, traffic)` with:

  kind              "decode" or "detect": which throughput it reports
  rounds            rounds of `traffic["blocks"]` blocks a call
  symbols_per_call  OFDM symbols (pilot + data) a call detects
  setup()           build the program's step (the warm-up call that
                    follows captures its graphs)
  captured()        the captures' host ms and the graph pool's MiB
  issue(keys)       start one call on the program: keys (rounds, B, 2)
  read(handle)      the call's answer on the host (a flat dict)
  flops(answer)     the call's FLOPs by the frozen count
  launches()        kernel -> [shape dict] of one call's launches
  free()            release the program's graphs before the reference
  reference(ref_cfg, keys, tf32)  the reference's answer to the same keys

and `LIBS`, the program's CUDA libraries the cell launches.

The program's packages are imported inside the functions that use them.
"""
