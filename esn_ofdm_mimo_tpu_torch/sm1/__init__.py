"""System-model-1 frontend (port of esn_ofdm_mimo_tpu/sm1): the reference's
Sionna OFDM chain (esn_ofdm_mimo_via_cdl.py / esn_via_cdl_all_model.py) so
the classifier zoo trains at the reference's operating point.

  grid  — 5G-style resource grid (guards, DC null, kronecker pilots),
          grid mapper, Eb/N0 -> noise-variance conversion
  cdl   — TR 38.901 CDL-B *spatial* channel + frequency-domain evaluation
  rx    — LS channel estimation with nearest-neighbour interpolation and
          per-RE unbiased LMMSE MIMO equalization
"""
from . import cdl, grid, rx  # noqa: F401
