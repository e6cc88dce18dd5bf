"""Max-log LLRs and decision-directed noise variance (port of
esn_ofdm_mimo_tpu/ops/llr.py; reference Demo_MIMO_4x8_Sionna_CDL_ESN_v2.py
:66-88).

  LLR_b   = (min_{s: b(s)=1} |z-s|^2 - min_{s: b(s)=0} |z-s|^2) / sigma^2
  sigma^2 = mean |z - harddecision(z)|^2 + 1e-12

The column-major square QAM is separable (bits [0, m/2) label the imaginary
PAM index, bits [m/2, m) the real one), so both reduce to two P-point PAM
problems per symbol.
"""
from __future__ import annotations

import torch

from .qam import pam_axis_points, qam_bit_labels, qam_constellation


def _pam_d2(x: torch.Tensor, m: int) -> torch.Tensor:
    """x real (...,) -> (..., P) squared distances to the PAM points."""
    return (x[..., None] - pam_axis_points(m, x.device)) ** 2


def est_sigma2_from_decision(z: torch.Tensor, bits_per_symbol: int
                             ) -> torch.Tensor:
    """Decision-directed sigma^2 over the last axis -> (...,)."""
    m = bits_per_symbol
    if m % 2 == 0:
        err2 = (_pam_d2(z.real, m).amin(-1) + _pam_d2(z.imag, m).amin(-1))
    else:
        const = qam_constellation(m, z.device)
        err2 = ((z[..., None] - const).abs() ** 2).amin(-1)
    return err2.mean(-1) + 1e-12


def _masked_llrs(d2: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """d2 (..., M) distances, labels (M, b) -> (..., b) d1_min - d0_min."""
    is1 = labels.bool()
    inf = torch.tensor(float("inf"), dtype=d2.dtype, device=d2.device)
    d = d2[..., None]
    d0 = torch.where(is1, inf, d).amin(-2)
    d1 = torch.where(is1, d, inf).amin(-2)
    return d1 - d0


def qam_llrs_maxlog(z: torch.Tensor, sigma2, bits_per_symbol: int
                    ) -> torch.Tensor:
    """z (..., n_sym); sigma2 broadcastable to (...) -> (..., n_sym, m)."""
    m = bits_per_symbol
    s2 = torch.clamp_min(torch.as_tensor(sigma2, device=z.device), 1e-12)
    s2 = s2[..., None, None]
    if m % 2 == 0:
        lab = qam_bit_labels(m // 2, z.device)
        llr_im = _masked_llrs(_pam_d2(z.imag, m), lab)
        llr_re = _masked_llrs(_pam_d2(z.real, m), lab)
        return torch.cat([llr_im, llr_re], dim=-1) / s2
    const = qam_constellation(m, z.device)
    d2 = (z[..., None] - const).abs() ** 2
    return _masked_llrs(d2, qam_bit_labels(m, z.device)) / s2
