"""Per-subcarrier ZF/MMSE equalization for block-constant channels.

Port of esn_ofdm_mimo_tpu/ops/equalize.py (reference OFDM_SISO_NBF_LDPC.py
:41-53):  X_hat = solve(H^H H + reg I, H^H y) / sqrt(Pi), with reg = 1e-12
(ZF) or No/Pi (MMSE). The channel is fixed for every data symbol of a
coherence block, so the weights W = (H^H H + reg I)^{-1} H^H are solved once
per (block, subcarrier) by `torch.linalg.solve` on complex64 — the JAX
package's real-embedded unrolled Cholesky (`linalg_mxu`) was a TPU
workaround — and applied to all D symbols as one batched matmul.
"""
from __future__ import annotations

import torch


def equalizer_weights(H: torch.Tensor, reg: float) -> torch.Tensor:
    """H (..., n_rx, n_tx) complex -> W (..., n_tx, n_rx) complex."""
    Hh = H.mH
    A = Hh @ H
    A = A + reg * torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    return torch.linalg.solve(A, Hh)


def apply_equalizer(W: torch.Tensor, Y: torch.Tensor, power_scale: float
                    ) -> torch.Tensor:
    """W (B, N, n_tx, n_rx), Y (B, D, n_rx, N) -> X_hat (B, D, N, n_tx)."""
    Yk = Y.transpose(-1, -2)[..., None]                 # (B, D, N, n_rx, 1)
    return (W[:, None] @ Yk)[..., 0] / power_scale
