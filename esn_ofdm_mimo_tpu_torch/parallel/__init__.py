"""The Monte-Carlo engine of the port: one calibrated CDL SNR point, and
block-fading SNR points and curves."""
from .montecarlo import (  # noqa: F401
    CdlSnrPoint, CurveResult, assemble_curve, cdl_snr_point, nbf_snr_point,
    run_nbf_curve)
