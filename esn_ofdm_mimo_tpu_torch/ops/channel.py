"""Multipath channel: 38.901 TDL tap draws and lfilter-semantics FIR.

Port of esn_ofdm_mimo_tpu/ops/channel.py (the main-path subset):
  * draw_tdl_taps — TR 38.901 TDL-A/B/C profiles scaled to an RMS delay
    spread, fractional delays split linearly between adjacent integer taps,
    per-link unit-power normalisation (reference
    Demo_MIMO_4x8_Sionna_CDL_ESN_v2.py:127-165). Draws come from the port's
    key-compatible RNG, so a (B, 2) batch of block keys gives the JAX
    package's taps.
  * apply_fir_channel — `scipy.signal.lfilter(c, [1], x)` per link: causal
    FIR convolution truncated to the input length (not circular), summed
    over TX antennas. The JAX package evaluates it as a zero-padded DFT
    product; here it is the direct isi-term sum.
  * exp_pdp — the exponential power-delay profile the TD-MMSE estimator uses.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import rng

# 3GPP TR 38.901 (Rel-16) Tables 7.7.2-1/-2/-3: normalized delays, powers.
TDLA_NORM_DELAYS = np.array([
    0.0000, 0.3819, 0.4025, 0.5868, 0.4610, 0.5375, 0.6708, 0.5750,
    0.7618, 1.5375, 1.8978, 2.2242, 2.1718, 2.4942, 2.5119, 3.0582,
    4.0810, 4.4579, 4.5695, 4.7966, 5.0066, 5.3043, 9.6586,
])
TDLA_POW_DB = np.array([
    -13.4, 0.0, -2.2, -4.0, -6.0, -8.2, -9.9, -10.5, -7.5, -15.9,
    -6.6, -16.7, -12.4, -15.2, -10.8, -11.3, -12.7, -16.2, -18.3,
    -18.9, -16.6, -19.9, -29.7,
])
TDLB_NORM_DELAYS = np.array([
    0.0000, 0.1072, 0.2155, 0.2095, 0.2870, 0.2986, 0.3752, 0.5055, 0.3681,
    0.3697, 0.5700, 0.5283, 1.1021, 1.2756, 1.5474, 1.7842, 2.0169, 2.8294,
    3.0219, 3.6187, 4.1067, 4.2790, 4.7834,
])
TDLB_POW_DB = np.array([
    0.0, -2.2, -4.0, -3.2, -9.8, -1.2, -3.4, -5.2, -7.6,
    -3.0, -8.9, -9.0, -4.8, -5.7, -7.5, -1.9, -7.6, -12.2,
    -9.8, -11.4, -14.9, -9.2, -11.3,
])
TDLC_NORM_DELAYS = np.array([
    0.0000, 0.2099, 0.2219, 0.2329, 0.2176, 0.6366, 0.6448, 0.6560,
    0.6584, 0.7935, 0.8213, 0.9336, 1.2285, 1.3083, 2.1704, 2.7105,
    4.2589, 4.6003, 5.4902, 5.6077, 6.3065, 6.6374, 7.0427, 8.6523,
])
TDLC_POW_DB = np.array([
    -4.4, -1.2, -3.5, -5.2, -2.5, 0.0, -2.2, -3.9, -7.4, -7.1,
    -10.7, -11.1, -5.1, -6.8, -8.7, -13.2, -13.9, -13.9, -15.8,
    -17.1, -16.0, -15.7, -21.6, -22.8,
])
TDL_PROFILES = {
    "a": (TDLA_NORM_DELAYS, TDLA_POW_DB),
    "b": (TDLB_NORM_DELAYS, TDLB_POW_DB),
    "c": (TDLC_NORM_DELAYS, TDLC_POW_DB),
}


def exp_pdp(isi_duration: int, device=None) -> torch.Tensor:
    """One-sided exponential PDP over isi taps, sum 1 (reference :162-164)."""
    cp = isi_duration - 1
    mag = np.exp(-np.arange(cp + 1) / max(cp / 9.0, 1e-12))
    return torch.as_tensor((mag / mag.sum()).astype(np.float32),
                           device=device)


@functools.lru_cache(maxsize=None)
def _tdl_split_matrix(profile: str, isi_duration: int, sample_rate_hz: float,
                      delay_spread_ns: float) -> np.ndarray:
    """(n_paths, isi) S[p, i]: weight of path p on integer tap i, linear
    split between floor(d) and floor(d)+1."""
    norm_delays = TDL_PROFILES[profile][0]
    delays_samp = norm_delays * delay_spread_ns * 1e-9 * sample_rate_hz
    S = np.zeros((len(norm_delays), isi_duration))
    for p, d in enumerate(delays_samp):
        i0 = int(np.floor(d))
        frac = d - i0
        if 0 <= i0 < isi_duration:
            S[p, i0] += 1.0 - frac
        if 0 <= i0 + 1 < isi_duration:
            S[p, i0 + 1] += frac
    return S


def draw_tdl_taps(keys: torch.Tensor, n_rx: int, n_tx: int,
                  isi_duration: int, sample_rate_hz: float,
                  delay_spread_ns: float, profile: str = "b") -> torch.Tensor:
    """keys (..., 2) -> (..., n_rx, n_tx, isi) complex64 TDL taps."""
    dev = keys.device
    pow_lin = 10.0 ** (TDL_PROFILES[profile][1] / 10.0)
    sqrt_pow = torch.sqrt(torch.as_tensor(
        (pow_lin / pow_lin.sum()).astype(np.float32), device=dev))
    split = torch.as_tensor(
        _tdl_split_matrix(profile, isi_duration, float(sample_rate_hz),
                          float(delay_spread_ns)).astype(np.float32),
        device=dev)
    shape = (n_rx, n_tx, sqrt_pow.shape[0])
    kri = rng.split(keys)
    sqrt2 = float(np.float32(np.sqrt(2.0)))
    gr = rng.normal(kri[..., 0, :], shape) / sqrt2 * sqrt_pow
    gi = rng.normal(kri[..., 1, :], shape) / sqrt2 * sqrt_pow
    h = torch.complex(gr @ split, gi @ split)
    power = (h.abs() ** 2).sum(-1, keepdim=True)
    return h / torch.sqrt(torch.clamp_min(power, 1e-30))


def apply_fir_channel(taps: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[..., r, n] = sum_t sum_k taps[..., r, t, k] * x[..., t, n-k].

    taps (..., n_rx, n_tx, isi) complex, x (..., n_tx, T) complex; leading
    axes broadcast. Causal and truncated to T, as lfilter."""
    isi = taps.shape[-1]
    T = x.shape[-1]
    y = taps[..., 0] @ x
    for k in range(1, isi):
        y[..., k:] += taps[..., k] @ x[..., :T - k]
    return y


def taps_to_freq_response(taps: torch.Tensor, n_subcarriers: int
                          ) -> torch.Tensor:
    """taps (..., n_rx, n_tx, isi) -> H (..., N, n_rx, n_tx) = fft(pad(c, N))."""
    H = torch.fft.fft(taps, n=n_subcarriers, dim=-1)
    return torch.movedim(H, -1, -3)
