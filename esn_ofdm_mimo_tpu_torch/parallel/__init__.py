"""The Monte-Carlo engine of the port: calibrated CDL and block-fading SNR
points, and the curves over an SNR grid with adaptive top-up and
checkpoints, on one GPU or over the ranks of a `torch.distributed` layout
(parallel/mesh.py); sequence-axis sharding primitives (parallel/seqshard.py)."""
from .mesh import (  # noqa: F401
    TrialsMesh, device_count, maybe_init_distributed, trials_mesh)
from .montecarlo import (  # noqa: F401
    CdlSnrPoint, CurveResult, assemble_curve, cdl_decode_rounds,
    cdl_snr_point, host_point, make_fused_cdl_grid, make_fused_cdl_snr_step,
    make_fused_nbf_grid, make_sharded_cdl_steps, make_sharded_nbf_scan_step,
    make_sharded_nbf_step, nbf_snr_point, run_cdl_curve, run_nbf_curve)
