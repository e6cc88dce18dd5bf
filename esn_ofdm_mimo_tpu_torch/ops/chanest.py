"""Channel estimation: comb LS + linear interpolation + TD-MMSE refine.

Port of esn_ofdm_mimo_tpu/ops/chanest.py (reference OFDM_SISO_NBF_LDPC.py
:316-334):
  * comb pattern: TX antenna `tx` owns subcarriers tx, tx+N_t, ...;
  * per-(rx, tx) LS on the comb, linear interpolation with linear
    extrapolation (scipy interp1d fill_value='extrapolate');
  * TD-MMSE: truncate ifft(H_LS) to isi taps and scale tap l by
    1 / (MMSEScaler / pdp[l] + 1), MMSEScaler = (No/Pi)/(N/2).
"""
from __future__ import annotations

import torch

from .channel import exp_pdp


def _interp_comb_linear(values: torch.Tensor, offset: int, step: int,
                        n_out: int) -> torch.Tensor:
    """values (..., P) at positions offset + i*step -> (..., n_out)."""
    P = values.shape[-1]
    dev = values.device
    pos = (torch.arange(n_out, device=dev, dtype=torch.float32)
           - offset) / step
    i0 = torch.clamp(torch.floor(pos).long(), 0, max(P - 2, 0))
    w = pos - i0
    v0 = values[..., i0]
    v1 = values[..., torch.clamp(i0 + 1, max=P - 1)]
    return v0 * (1.0 - w) + v1 * w


def ls_comb_estimate(Y_ls: torch.Tensor, X_ls_comb: torch.Tensor,
                     power_scale: float, n_tx: int) -> torch.Tensor:
    """Y_ls (..., n_rx, N), X_ls_comb (..., n_tx, N) -> H_ls
    (..., N, n_rx, n_tx)."""
    N = Y_ls.shape[-1]
    outs = []
    for tx in range(n_tx):
        sc = torch.arange(tx, N, n_tx, device=Y_ls.device)
        denom = X_ls_comb[..., tx, sc] * power_scale + 1e-12
        h_comb = Y_ls[..., :, sc] / denom[..., None, :]
        outs.append(_interp_comb_linear(h_comb, tx, n_tx, N))
    H = torch.stack(outs, dim=-1)                     # (..., n_rx, N, n_tx)
    return torch.movedim(H, -2, -3)


def mmse_refine_td(H_ls: torch.Tensor, isi_duration: int, mmse_scaler: float
                   ) -> torch.Tensor:
    """H_ls (..., N, n_rx, n_tx) -> H_mmse of the same shape."""
    N = H_ls.shape[-3]
    pdp = exp_pdp(isi_duration, H_ls.device)
    c_ls = torch.fft.ifft(H_ls, dim=-3)[..., :isi_duration, :, :]
    gain = 1.0 / (mmse_scaler / pdp[:, None, None] + 1.0)
    return torch.fft.fft(c_ls * gain, n=N, dim=-3)


def estimate_channel(Y_ls, X_ls_comb, power_scale: float, n_tx: int,
                     isi_duration: int, mmse_scaler: float):
    """LS + MMSE estimates; returns (H_ls, H_mmse)."""
    H_ls = ls_comb_estimate(Y_ls, X_ls_comb, power_scale, n_tx)
    return H_ls, mmse_refine_td(H_ls, isi_duration, mmse_scaler)
