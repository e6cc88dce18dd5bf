"""The Monte-Carlo engine of the port: calibrated CDL and block-fading SNR
points, and the curves over an SNR grid with adaptive top-up and
checkpoints."""
from .montecarlo import (  # noqa: F401
    CdlSnrPoint, CurveResult, assemble_curve, cdl_decode_rounds,
    cdl_snr_point, nbf_snr_point, run_cdl_curve, run_nbf_curve)
