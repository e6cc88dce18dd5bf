"""Per-subcarrier ZF/MMSE equalization.

Port of esn_ofdm_mimo_tpu/ops/equalize.py (reference OFDM_SISO_NBF_LDPC.py
:41-53):  X_hat = solve(H^H H + reg I, H^H y) / sqrt(Pi), with reg = 1e-12
(ZF) or No/Pi (MMSE).

The detect path's channel is fixed for every data symbol of a coherence
block, so its weights W = (H^H H + reg I)^{-1} H^H are solved once per
(block, subcarrier) by an LU solve on complex64 and applied to all
D symbols as one batched matmul (`equalizer_weights`, `apply_equalizer`).
The per-symbol solves (`equalize_zf`, `equalize_mmse`, `equalize_persc`)
keep the JAX package's real 2n_tx x 2n_tx embedding of the normal
equations, factored by a batched Cholesky.
"""
from __future__ import annotations

import torch


# the ZF diagonal load, float32 as the JAX package passes it
_ZF_LOAD = float(torch.tensor(1e-12, dtype=torch.float32))


def _real(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.real.dtype, device=like.device)


def _embed_H(H: torch.Tensor) -> torch.Tensor:
    """H (..., n_rx, n_tx) complex -> [[Hr, -Hi], [Hi, Hr]] (..., 2n_rx,
    2n_tx) real: He^T He embeds H^H H and He^T [yr; yi] embeds H^H y."""
    Hr, Hi = H.real, H.imag
    return torch.cat([torch.cat([Hr, -Hi], dim=-1),
                      torch.cat([Hi, Hr], dim=-1)], dim=-2)


def _regularized_solve(H: torch.Tensor, y: torch.Tensor, reg) -> torch.Tensor:
    """solve(H^H H + reg I, H^H y) batched over the leading axes: H (...,
    n_rx, n_tx) and y (..., n_rx) complex, reg a float or a real tensor
    that broadcasts against the leading axes -> (..., n_tx) complex."""
    n_tx = H.shape[-1]
    He = _embed_H(H)
    ye = torch.cat([y.real, y.imag], dim=-1)[..., None]
    G = He.transpose(-1, -2) @ He
    G = G + _real(reg, G)[..., None, None] * torch.eye(
        2 * n_tx, dtype=G.dtype, device=G.device)
    L, _ = torch.linalg.cholesky_ex(G)
    xe = torch.cholesky_solve(He.transpose(-1, -2) @ ye, L)[..., 0]
    return torch.complex(xe[..., :n_tx], xe[..., n_tx:])


def equalize_zf(Y: torch.Tensor, H: torch.Tensor, power_scale
                ) -> torch.Tensor:
    """Zero forcing with a tiny diagonal load (1e-12): Y (..., n_rx), H
    (..., n_rx, n_tx) -> (..., n_tx); power_scale a float or a tensor that
    broadcasts against the leading axes."""
    return _regularized_solve(H, Y, _ZF_LOAD) / _real(power_scale, Y)[
        ..., None]


def equalize_mmse(Y: torch.Tensor, H: torch.Tensor, power_scale,
                  noise_over_power) -> torch.Tensor:
    """LMMSE: the diagonal load is No / Pi. Shapes as `equalize_zf`."""
    return _regularized_solve(H, Y, noise_over_power) / _real(
        power_scale, Y)[..., None]


def equalize_persc(Y: torch.Tensor, H: torch.Tensor, power_scale,
                   noise_over_power=None) -> torch.Tensor:
    """One full OFDM symbol: Y (..., n_rx, N), H (..., N, n_rx, n_tx) ->
    X_hat (..., N, n_tx). ZF when noise_over_power is None, else MMSE."""
    Yk = Y.transpose(-1, -2)
    ps = _real(power_scale, Y)[..., None]
    if noise_over_power is None:
        return equalize_zf(Yk, H, ps)
    return equalize_mmse(Yk, H, ps, _real(noise_over_power, Y)[..., None])


def equalizer_weights(H: torch.Tensor, reg: float) -> torch.Tensor:
    """H (..., n_rx, n_tx) complex -> W (..., n_tx, n_rx) complex. The LU
    solve of `torch.linalg.solve` without its error check, which would read
    the factorisation's status back to the host (a sync, and so no CUDA
    graph capture); a singular system gives non-finite weights, as the JAX
    package's solve does."""
    Hh = H.mH
    A = Hh @ H
    A = A + reg * torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    return torch.linalg.solve_ex(A, Hh, check_errors=False)[0]


def apply_equalizer(W: torch.Tensor, Y: torch.Tensor, power_scale: float
                    ) -> torch.Tensor:
    """W (B, N, n_tx, n_rx), Y (B, D, n_rx, N) -> X_hat (B, D, N, n_tx)."""
    Yk = Y.transpose(-1, -2)[..., None]                 # (B, D, N, n_rx, 1)
    return (W[:, None] @ Yk)[..., 0] / power_scale
