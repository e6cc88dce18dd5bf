"""System-model-1 receiver (port of esn_ofdm_mimo_tpu/sm1/rx.py): LS channel
estimation with nearest-neighbour interpolation and per-RE unbiased LMMSE
MIMO equalization.

The reference's `LSChannelEstimator(rg, interpolation_type="nn")` and
`LMMSEEqualizer(rg, sm)` (esn_ofdm_mimo_via_cdl.py:73-74, 247-248):

  * LS: at each pilot RE of stream s, h_ls = y * conj(p) / |p|^2 per rx
    antenna, error variance no / num_streams; every RE takes the estimate
    of its nearest pilot (L2 in (symbol, subcarrier) index coordinates,
    first-match tie-break), per stream and rx antenna — a static gather
    whose indices come from numpy;
  * LMMSE: per RE, A = H^H H + (no + S err_var) I, G = A^-1 H^H, x_hat_j =
    (G y)_j / (G H)_jj (unbiased) and no_eff_j = 1/(G H)_jj - 1, with the
    diagonal clamped at 1e-12.

The JAX package solved the per-RE system through its 8 x 8 real embedding
with an unrolled Cholesky (its TPU backend had no LAPACK); here the S x S
complex Hermitian system goes to a batched `torch.linalg.cholesky_ex` and
`torch.cholesky_solve` (about 57,000 systems at the reference's batch 64).
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .grid import ResourceGrid


@functools.lru_cache(maxsize=None)
def _nn_tables(rg: ResourceGrid) -> Tuple[np.ndarray, np.ndarray]:
    """Static (S, P) flat pilot-RE indices and (S, T, F) nn map into [0,P)."""
    mask = rg.pilot_mask()                       # (S, T, F) bool
    S, T, F = mask.shape
    flat_idx = np.zeros((S, mask[0].sum()), dtype=np.int64)
    nn_map = np.zeros((S, T, F), dtype=np.int64)
    tt, ff = np.meshgrid(np.arange(T), np.arange(F), indexing="ij")
    for s in range(S):
        tp, fp = np.nonzero(mask[s])             # (P,)
        flat_idx[s] = tp * F + fp
        d2 = (tt[..., None] - tp) ** 2 + (ff[..., None] - fp) ** 2
        nn_map[s] = np.argmin(d2, axis=-1)
    return flat_idx, nn_map


def ls_nn_estimate(rg: ResourceGrid, y_grid: torch.Tensor,
                   pilots: torch.Tensor, no) -> Tuple[torch.Tensor, float]:
    """LS + nearest-neighbour channel estimate.

    y_grid (..., T, F_eff, U) complex; pilots (S, T, F_eff) complex.
    Returns h_hat (..., T, F_eff, U, S) and err_var (a float).
    """
    flat_np, nn_np = _nn_tables(rg)
    dev = y_grid.device
    S, T = rg.num_streams, rg.num_ofdm_symbols
    F = rg.num_effective_subcarriers
    *lead, _, _, U = y_grid.shape
    flat_idx = torch.as_tensor(flat_np, device=dev)
    s_idx = torch.arange(S, device=dev)[:, None]
    y_pil = y_grid.reshape(*lead, T * F, U)[..., flat_idx, :]   # (..,S,P,U)
    p_pil = pilots.reshape(S, T * F)[s_idx, flat_idx]           # (S, P)
    h_pil = y_pil * (p_pil.conj() / (p_pil.abs() ** 2))[..., None]
    nn_map = torch.as_tensor(nn_np.reshape(S, T * F), device=dev)
    h_full = h_pil[..., s_idx, nn_map, :].reshape(*lead, S, T, F, U)
    return torch.movedim(h_full, -4, -1), float(no) / float(S)


def lmmse_equalize_grid(h_hat: torch.Tensor, y_grid: torch.Tensor,
                        err_var, no) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-RE unbiased LMMSE equalization (module docstring).

    h_hat (..., U, S) complex, y_grid (..., U) complex (any leading axes).
    Returns x_hat (..., S) complex and no_eff (..., S) real.
    """
    S = h_hat.shape[-1]
    s_cov = float(no) + S * float(err_var)
    hH = h_hat.conj().transpose(-1, -2)                     # (..., S, U)
    G = hH @ h_hat
    A = G + s_cov * torch.eye(S, dtype=G.dtype, device=G.device)
    L, _ = torch.linalg.cholesky_ex(A)
    sol = torch.cholesky_solve(torch.cat([hH @ y_grid[..., None], G], -1), L)
    d = torch.diagonal(sol[..., 1:], dim1=-2, dim2=-1).real
    d = torch.clamp_min(d, 1e-12)
    return sol[..., 0] / d, 1.0 / d - 1.0
