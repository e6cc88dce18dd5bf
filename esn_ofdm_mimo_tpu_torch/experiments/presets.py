"""Experiment presets — the five BASELINE.json configurations.

Each preset mirrors one reference script's parameter block (file:line cited);
`fast=True` shrinks the Monte-Carlo the same way the reference FAST knob does
(OFDM_SISO_NBF_LDPC.py:117,127-142).
"""
from __future__ import annotations

from ..config import (CalibConfig, ChannelConfig, EsnConfig, LdpcConfig,
                      OfdmConfig, SimConfig)

_EBNO_FULL = tuple(float(x) for x in range(0, 31, 3))
_EBNO_FAST = (0.0, 6.0, 12.0, 18.0, 24.0)


def siso_qpsk_awgn(fast: bool = False) -> SimConfig:
    """Demo_SISO_QPSK_AWGN_LDPC_ESN_with_ZF_LS.py:100-148 — SISO QPSK over a
    flat unit-magnitude channel, CP=0, one training per SNR point."""
    n_symbols = 100 if fast else 400
    return SimConfig(
        name="siso_qpsk_awgn",
        ofdm=OfdmConfig(n_subcarriers=512, bits_per_symbol=2,
                        bits_per_pilot_symbol=2, isi_duration=1,
                        coherence_override=n_symbols),
        channel=ChannelConfig(kind="awgn_flat", n_tx=1, n_rx=1,
                              flat_scalar_ls=True),
        # recurrence_precision "highest": this preset's ESN floor (~1e-6
        # uncoded at 21+ dB) sits far below the Pallas predict kernel's
        # ~8e-4 quantization floor (measured on TPU with BOTH code
        # families — the flagship's bf16-kernel validation does not
        # transfer to deep-floor presets; see EsnConfig.recurrence_precision)
        esn=EsnConfig(n_reservoir=200, min_delay=0, max_delay=0,
                      train_ebno_fixed_db=None,
                      recurrence_precision="highest"),
        # qc (round 3): same (4,8)-regular ensemble at n=1024 (Z=128) as the
        # reference's pyldpc draw — the last preset still on the slow XLA
        # Gallager path; decode contract (y_obs unhalved, sigma2 = No,
        # Demo_SISO...:283-296) is family-independent. BER validated vs the
        # committed Gallager curve (results/siso_qpsk_awgn_tpu_qc,
        # tools/compare_curves.py)
        ldpc=LdpcConfig(max_iter=100, yobs_half=False, sigma2_mode="true_no",
                        family="qc"),
        ebno_db=_EBNO_FAST if fast else _EBNO_FULL,
        num_ofdm_symbols=n_symbols)


def _nbf(name, n_tx, n_rx, n_reservoir, n_symbols, fast) -> SimConfig:
    n = 256 if fast else 512
    return SimConfig(
        name=name,
        ofdm=OfdmConfig(n_subcarriers=n, bits_per_symbol=4),
        channel=ChannelConfig(kind="exp_pdp", n_tx=n_tx, n_rx=n_rx),
        esn=EsnConfig(n_reservoir=300 if fast else n_reservoir),
        # qc: same (4,8)-regular ensemble/rate as the reference's pyldpc
        # draw, girth-conditioned; decodes on the fused Pallas BP kernel on
        # TPU — the traced below-6dB doubled iteration budget runs as a
        # runtime cap in a kernel compiled at the 2*max_iter worst case.
        # BER parity with the Gallager draw validated per preset
        # (results/*_qc runs vs the committed Gallager-family curves).
        ldpc=LdpcConfig(max_iter=80 if fast else 100,
                        decode_every=8 if fast else 4, family="qc"),
        ebno_db=_EBNO_FAST if fast else _EBNO_FULL,
        num_ofdm_symbols=(80 if fast else n_symbols))


def siso_nbf(fast: bool = False) -> SimConfig:
    """OFDM_SISO_NBF_LDPC.py:114-203 — canonical block-fading pipeline."""
    return _nbf("siso_nbf", 1, 1, 300, 1000, fast)


def simo_1x2_nbf(fast: bool = False) -> SimConfig:
    """OFDM_SIMO_1-2_NBF_LDPC.py (clone with N_r=2, :133)."""
    return _nbf("simo_1x2_nbf", 1, 2, 300, 1000, fast)


def mimo_2x2_nbf(fast: bool = False) -> SimConfig:
    """OFDM_MIMO_2-2_NBF_LDPC.py (clone with N_t=N_r=2, :132-133)."""
    return _nbf("mimo_2x2_nbf", 2, 2, 300, 1000, fast)


def mimo_4x8_nbf(fast: bool = False) -> SimConfig:
    """Demo_MIMO_4x8_ChannelRank_TrainSNR_LDPC_fast.py (4x8, reservoir 600
    at N=512, 400 symbols, :132-142)."""
    return _nbf("mimo_4x8_nbf", 4, 8, 600, 400, fast)


def mimo_4x8_cdl(fast: bool = False) -> SimConfig:
    """Demo_MIMO_4x8_Sionna_CDL_ESN_v2.py:180-266 — the flagship: 4x8 over
    CDL-B (TDL) 300 ns, calibrated LLRs, N=128."""
    return SimConfig(
        name="mimo_4x8_cdl",
        ofdm=OfdmConfig(n_subcarriers=128, bits_per_symbol=4),
        channel=ChannelConfig(kind="cdl_b", n_tx=4, n_rx=8,
                              delay_spread_ns=300.0),
        esn=EsnConfig(n_reservoir=300, train_ebno_fixed_db=None),
        # qc: same (4,8)-regular ensemble/rate as the reference's pyldpc
        # draw, girth-conditioned (>= 6), fused Pallas BP on TPU; BER
        # validated against the Gallager draw + the reference baseline
        # (tools/validate_baseline.py).
        # offset-minsum (round 5): full-grid validated at the converged
        # 1024-4096-block budget — MMSE coded 11/11 in ±0.5 dB (6 dB
        # +0.38 vs normalized min-sum's rejected +0.59; cliff +0.20),
        # ESN deviations identical to the sumprod control
        # (results/mimo_4x8_cdl_tpu_r5_offms vs _r5; sweep
        # results/minsum_offset_sweep_r5.json). `--ldpc-algo sumprod`
        # restores the pyldpc-exact tanh rule.
        ldpc=LdpcConfig(max_iter=100, family="qc", algo="offset-minsum"),
        calib=CalibConfig(enabled=True, cal_fraction=0.3),
        ebno_db=_EBNO_FAST if fast else _EBNO_FULL,
        num_ofdm_symbols=200 if fast else 1000)


PRESETS = {
    "siso_qpsk_awgn": siso_qpsk_awgn,
    "siso_nbf": siso_nbf,
    "simo_1x2_nbf": simo_1x2_nbf,
    "mimo_2x2_nbf": mimo_2x2_nbf,
    "mimo_4x8_nbf": mimo_4x8_nbf,
    "mimo_4x8_cdl": mimo_4x8_cdl,
}


def get_preset(name: str, fast: bool = False) -> SimConfig:
    return PRESETS[name](fast=fast)
