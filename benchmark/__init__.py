"""The benchmark of esn_ofdm_mimo_tpu_torch on one H100: `run.py` runs a
cell once, driven by the files under `workloads/`, `configs/`,
`entries/` and `metrics/`, against the plain reference under
`reference/`."""
