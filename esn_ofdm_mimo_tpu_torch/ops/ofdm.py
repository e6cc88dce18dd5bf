"""OFDM modulation/demodulation with the reference's unnormalised FFT pair.

Port of esn_ofdm_mimo_tpu/ops/ofdm.py (reference OFDM_SISO_NBF_LDPC.py
:413-428): TX x = N * ifft(X) with the last `cp` samples prepended, RX
Y = fft(y[cp:]) / N, over the last axis. torch.fft takes the place of the
JAX package's DFT-as-matmul (`fft_mxu`), a TPU workaround.
"""
from __future__ import annotations

import torch


def add_cp(x: torch.Tensor, cp_len: int) -> torch.Tensor:
    if cp_len == 0:
        return x
    return torch.cat([x[..., -cp_len:], x], dim=-1)


def remove_cp(y_cp: torch.Tensor, cp_len: int) -> torch.Tensor:
    return y_cp[..., cp_len:]


def ofdm_modulate(X: torch.Tensor, cp_len: int) -> torch.Tensor:
    """Frequency symbols (..., N) -> time-domain with CP (..., N+cp)."""
    n = X.shape[-1]
    return add_cp(n * torch.fft.ifft(X, dim=-1), cp_len)


def ofdm_demodulate(y_cp: torch.Tensor, cp_len: int) -> torch.Tensor:
    """Time-domain with CP (..., N+cp) -> frequency symbols (..., N)."""
    y = remove_cp(y_cp, cp_len)
    return torch.fft.fft(y, dim=-1) / y.shape[-1]
