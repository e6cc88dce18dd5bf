"""Modem primitives and channel models in PyTorch (port of
esn_ofdm_mimo_tpu/ops, the main-path subset)."""

from .qam import (  # noqa: F401
    qam_constellation, qam_bit_labels, pam_axis_points, bits_to_symbols,
    hard_demap_index, symbols_to_bits_hard, qam_constellation_gray,
    qam_bit_labels_msb, bits_to_index_msb, bits_to_symbols_gray,
    hard_demap_index_gray)
from .ofdm import ofdm_modulate, ofdm_demodulate, add_cp, remove_cp  # noqa: F401
from .pa import rapp_pa, clip_amplitude  # noqa: F401
from .channel import (  # noqa: F401
    exp_pdp, draw_exp_pdp_taps, draw_flat_awgn_tap, draw_tdl_taps,
    draw_cdlb_taps, awgn,
    apply_fir_channel, taps_to_freq_response)
from .analytics import SvdMetrics, channel_svd_metrics  # noqa: F401
from .chanest import (ls_comb_estimate, mmse_refine_td,  # noqa: F401
                      estimate_channel, channel_freq_correlation)
from .equalize import equalizer_weights, apply_equalizer  # noqa: F401
from .llr import qam_llrs_maxlog, est_sigma2_from_decision  # noqa: F401
