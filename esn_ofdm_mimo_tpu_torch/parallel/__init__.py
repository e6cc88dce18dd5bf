"""The Monte-Carlo engine of the port: one calibrated CDL SNR point."""
from .montecarlo import CdlSnrPoint, cdl_snr_point  # noqa: F401
