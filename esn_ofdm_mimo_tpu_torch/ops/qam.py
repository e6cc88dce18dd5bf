"""QAM constellation, bit labelling, mapping and hard demapping.

Port of esn_ofdm_mimo_tpu/ops/qam.py (the main-path subset):
  * square M-QAM from a PAM grid, flattened column-major, unit average
    power (reference OFDM_SISO_NBF_LDPC.py:22-33);
  * natural-binary LSB-first labels: idx = sum_i bits[i] * 2^i.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _constellation_np(bits_per_symbol: int) -> np.ndarray:
    """Unit-power square QAM constellation, column-major PAM ordering."""
    even_sqrt = int(np.ceil(np.sqrt(2.0**bits_per_symbol) / 2) * 2)
    pam = np.arange(-(even_sqrt - 1), even_sqrt, 2, dtype=np.float64)
    grid = pam[None, :] + 1j * pam[:, None]
    flat = grid.T.reshape(-1)
    return (flat / np.sqrt(np.mean(np.abs(flat) ** 2))).astype(np.complex64)


def qam_constellation(bits_per_symbol: int, device=None) -> torch.Tensor:
    """(M,) complex64 unit-power constellation."""
    return torch.as_tensor(_constellation_np(bits_per_symbol), device=device)


def qam_bit_labels(bits_per_symbol: int, device=None) -> torch.Tensor:
    """(M, m) int64; row idx = natural-binary LSB-first bits of idx."""
    idx = torch.arange(2 ** bits_per_symbol, device=device)
    return (idx[:, None] >> torch.arange(bits_per_symbol, device=device)) & 1


def pam_axis_points(bits_per_symbol: int, device=None) -> torch.Tensor:
    """(P,) normalized PAM coordinates of the square grid: the column-major
    constellation is separable, const[i*P + j] = pam[i] + 1j*pam[j]."""
    assert bits_per_symbol % 2 == 0
    P = 2 ** (bits_per_symbol // 2)
    return torch.as_tensor(
        _constellation_np(bits_per_symbol)[:P].imag.copy(), device=device)


def bits_to_symbols(bits: torch.Tensor, bits_per_symbol: int) -> torch.Tensor:
    """Map bits (..., n_sym * m) -> complex64 symbols (..., n_sym)."""
    m = bits_per_symbol
    groups = bits.reshape(*bits.shape[:-1], bits.shape[-1] // m, m)
    powers = 2 ** torch.arange(m, device=bits.device)
    idx = (groups.to(torch.int64) * powers).sum(-1)
    return qam_constellation(m, bits.device)[idx]


def hard_demap_index(symbols: torch.Tensor, bits_per_symbol: int
                     ) -> torch.Tensor:
    """Nearest-constellation-point index (per-PAM-axis argmin)."""
    m = bits_per_symbol
    if m % 2 == 0:
        pam = pam_axis_points(m, symbols.device)
        i = torch.argmin((symbols.real[..., None] - pam) ** 2, dim=-1)
        j = torch.argmin((symbols.imag[..., None] - pam) ** 2, dim=-1)
        return i * pam.shape[0] + j
    const = qam_constellation(m, symbols.device)
    return torch.argmin((symbols[..., None] - const).abs() ** 2, dim=-1)


def symbols_to_bits_hard(symbols: torch.Tensor, bits_per_symbol: int
                         ) -> torch.Tensor:
    """Hard demap (..., n_sym) -> int8 bits (..., n_sym * m), LSB-first."""
    m = bits_per_symbol
    idx = hard_demap_index(symbols, m)
    bits = (idx[..., None] >> torch.arange(m, device=idx.device)) & 1
    return bits.to(torch.int8).reshape(*idx.shape[:-1], idx.shape[-1] * m)
