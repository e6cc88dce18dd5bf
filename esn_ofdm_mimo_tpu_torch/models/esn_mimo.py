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

The fit's state harvest runs the CUDA states kernel (K3,
models/esn_states_cuda.py), as the JAX package's fit does under
ESN_TPU_IMPL=pallas; detection runs the CUDA predict kernel (K2, or K4
under the JAX package's own switch ESN_TPU_PREDICT_READOUT=grouped where its
condition holds; models/esn_cuda.py). CPU tensors run the plain versions.
"""
from __future__ import annotations

import os
from typing import Tuple

import torch
import torch.nn.functional as Fn

from .esn import EsnReservoir, EsnScale, _readout_lstsq, scale_inputs
from .esn_cuda import choose_readout, esn_predict_cuda
from .esn_states_cuda import esn_states_cuda


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
                   seed: int = 0) -> torch.Tensor:
    """Fit readouts for B coherence blocks -> Wt_out (B, F, 2*n_tx): states
    (K3 on the card), then the scaled inputs appended, then the ridge solve
    on rows [n_forget:] (JAX esn_mimo.train_mimo_esn, its Pallas branch).
    `seed` seeds the state noise."""
    X_in, X_out = build_esn_io(y_cp, x_cp, delay)
    n_forget = delay + cp_len
    teachers_scaled = X_out * scale.teacher_scaling
    states = esn_states_cuda(res, scale, X_in, teachers_scaled, seed)
    ext = torch.cat([states, scale_inputs(scale, X_in)], dim=-1)
    return _readout_lstsq(ext[:, n_forget:], teachers_scaled[:, n_forget:])


def esn_detect_symbols(res: EsnReservoir, scale: EsnScale,
                       Wt_out: torch.Tensor, y_cp: torch.Tensor, delay: int,
                       cp_len: int, n_subcarriers: int, power_scale: float,
                       seed: int = 0) -> torch.Tensor:
    """One OFDM symbol per row: y_cp (B, n_rx, N+cp) -> X_hat (B, N, n_tx).
    Wt_out may be grouped, (G, F, n_out) with B % G == 0 (readout g serves
    the contiguous run of B//G rows). With ESN_TPU_PREDICT_READOUT=grouped
    the card runs K4 instead of K2 where a block of the launch's tiling
    touches at most 4 readouts (Dg > 1)."""
    N = n_subcarriers
    X_in = build_esn_input(y_cp, delay)
    G = Wt_out.shape[0]
    readout = "per_row"
    if os.environ.get("ESN_TPU_PREDICT_READOUT") == "grouped":
        readout = choose_readout(X_in.shape[0], G, res.Wt.shape[0],
                                 X_in.shape[2], Wt_out.shape[2], X_in.device)
    pred = esn_predict_cuda(res, scale, Wt_out, X_in, delay + cp_len, seed,
                            readout=readout)
    x_hat_td = _deinterleave_reim(pred[:, :N])             # (B, n_tx, N)
    X_hat = torch.fft.fft(x_hat_td, dim=-1) / N / power_scale
    return X_hat.transpose(-1, -2)
