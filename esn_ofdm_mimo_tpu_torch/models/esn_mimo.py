"""MIMO-OFDM ESN detection harness (port of esn_ofdm_mimo_tpu/models/
esn_mimo.py, the shared-delay "batch" path; reference
libs/helper_mimo_esn_generic.py:5-86 and OFDM_SISO_NBF_LDPC.py:430-448).

  * ESN input: 2*n_rx real channels (re, im per RX) of the received
    waveform y_cp, zero-padded by `delay` samples at the end;
  * ESN target: 2*n_tx channels of the transmitted waveform, delayed by
    `delay` samples;
  * n_forget = delay + cp_len;
  * detection: predict, keep rows [0, N), recombine re + im, FFT/N, divide
    by sqrt(Pi).

Detection runs the CUDA predict kernel for CUDA tensors and its plain
version for CPU tensors (models/esn_cuda.py). The fit stays on the plain
recurrence, as the JAX package keeps it on its XLA scan.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as Fn

from .esn import EsnReservoir, EsnScale, esn_fit
from .esn_cuda import esn_predict_cuda


def _interleave_reim(z: torch.Tensor) -> torch.Tensor:
    """(B, A, T) complex -> (B, T, 2A) real, columns (re0, im0, re1, ...)."""
    parts = torch.stack([z.real, z.imag], dim=-2)           # (B, A, 2, T)
    B, A, _, T = parts.shape
    return parts.reshape(B, 2 * A, T).transpose(-1, -2).to(torch.float32)


def _deinterleave_reim(x: torch.Tensor) -> torch.Tensor:
    """(B, T, 2A) real -> (B, A, T) complex."""
    B, T, twoA = x.shape
    z = x.reshape(B, T, twoA // 2, 2)
    return torch.complex(z[..., 0], z[..., 1]).transpose(-1, -2)


def build_esn_io(y_cp: torch.Tensor, x_cp: torch.Tensor, delay: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y_cp (B, n_rx, T), x_cp (B, n_tx, T) complex -> X_in
    (B, T+delay, 2*n_rx), X_out (B, T+delay, 2*n_tx) real."""
    X_in = Fn.pad(_interleave_reim(y_cp), (0, 0, 0, delay))
    X_out = Fn.pad(_interleave_reim(x_cp), (0, 0, delay, 0))
    return X_in, X_out


def build_esn_input(y_cp: torch.Tensor, delay: int) -> torch.Tensor:
    """Inference input: y_cp (B, n_rx, T) -> (B, T+delay, 2*n_rx)."""
    return Fn.pad(_interleave_reim(y_cp), (0, 0, 0, delay))


def train_mimo_esn(res: EsnReservoir, scale: EsnScale, y_cp: torch.Tensor,
                   x_cp: torch.Tensor, delay: int, cp_len: int,
                   generator=None) -> torch.Tensor:
    """Fit readouts for B coherence blocks -> Wt_out (B, F, 2*n_tx)."""
    X_in, X_out = build_esn_io(y_cp, x_cp, delay)
    return esn_fit(res, scale, X_in, X_out, delay + cp_len, generator)


def esn_detect_symbols(res: EsnReservoir, scale: EsnScale,
                       Wt_out: torch.Tensor, y_cp: torch.Tensor, delay: int,
                       cp_len: int, n_subcarriers: int, power_scale: float,
                       seed: int = 0) -> torch.Tensor:
    """One OFDM symbol per row: y_cp (B, n_rx, N+cp) -> X_hat (B, N, n_tx).
    Wt_out may be grouped, (G, F, n_out) with B % G == 0 (readout g serves
    the contiguous run of B//G rows)."""
    N = n_subcarriers
    X_in = build_esn_input(y_cp, delay)
    pred = esn_predict_cuda(res, scale, Wt_out, X_in, delay + cp_len, seed)
    x_hat_td = _deinterleave_reim(pred[:, :N])             # (B, n_tx, N)
    X_hat = torch.fft.fft(x_hat_td, dim=-1) / N / power_scale
    return X_hat.transpose(-1, -2)
