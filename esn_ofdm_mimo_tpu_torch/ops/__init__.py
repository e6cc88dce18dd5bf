"""Modem primitives and channel models in PyTorch (port of
esn_ofdm_mimo_tpu/ops, the main-path subset)."""

from .qam import (  # noqa: F401
    qam_constellation, qam_bit_labels, pam_axis_points, bits_to_symbols,
    hard_demap_index, symbols_to_bits_hard)
from .ofdm import ofdm_modulate, ofdm_demodulate, add_cp, remove_cp  # noqa: F401
from .pa import rapp_pa, clip_amplitude  # noqa: F401
from .channel import (  # noqa: F401
    exp_pdp, draw_tdl_taps, apply_fir_channel, taps_to_freq_response)
from .chanest import ls_comb_estimate, mmse_refine_td, estimate_channel  # noqa: F401
from .equalize import equalizer_weights, apply_equalizer  # noqa: F401
from .llr import qam_llrs_maxlog, est_sigma2_from_decision  # noqa: F401
