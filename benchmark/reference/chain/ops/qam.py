"""QAM constellation, bit labelling, mapping and hard demapping.

Port of esn_ofdm_mimo_tpu/ops/qam.py, both label conventions:
  * square M-QAM from a PAM grid, flattened column-major, unit average
    power (reference OFDM_SISO_NBF_LDPC.py:22-33) with natural-binary
    LSB-first labels: idx = sum_i bits[i] * 2^i (system model 2);
  * the Gray/Sionna constellation with MSB-first labels, idx = sum_i
    bits[i] * 2^(m-1-i) (system model 1, `*_gray` / `*_msb`).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.device import device_constant


@functools.lru_cache(maxsize=None)
def _constellation_np(bits_per_symbol: int) -> np.ndarray:
    """Unit-power square QAM constellation, column-major PAM ordering."""
    even_sqrt = int(np.ceil(np.sqrt(2.0**bits_per_symbol) / 2) * 2)
    pam = np.arange(-(even_sqrt - 1), even_sqrt, 2, dtype=np.float64)
    grid = pam[None, :] + 1j * pam[:, None]
    flat = grid.T.reshape(-1)
    return (flat / np.sqrt(np.mean(np.abs(flat) ** 2))).astype(np.complex64)


def qam_constellation(bits_per_symbol: int, device=None) -> torch.Tensor:
    """(M,) complex64 unit-power constellation (a shared constant, not to
    be written to: utils/device.py:device_constant)."""
    return device_constant(_constellation_np, bits_per_symbol, device=device)


def qam_bit_labels(bits_per_symbol: int, device=None) -> torch.Tensor:
    """(M, m) int64; row idx = natural-binary LSB-first bits of idx."""
    idx = torch.arange(2 ** bits_per_symbol, device=device)
    return (idx[:, None] >> torch.arange(bits_per_symbol, device=device)) & 1


def pam_axis_points(bits_per_symbol: int, device=None) -> torch.Tensor:
    """(P,) normalized PAM coordinates of the square grid: the column-major
    constellation is separable, const[i*P + j] = pam[i] + 1j*pam[j]."""
    assert bits_per_symbol % 2 == 0
    return device_constant(_pam_points_np, bits_per_symbol, device=device)


def _pam_points_np(bits_per_symbol: int) -> np.ndarray:
    P = 2 ** (bits_per_symbol // 2)
    return _constellation_np(bits_per_symbol)[:P].imag.copy()


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


@functools.lru_cache(maxsize=None)
def _pam_gray(bits: tuple) -> float:
    """Gray-labelled PAM amplitude of an MSB-first bit tuple (3GPP / Sionna
    convention: p(b) = (1 - 2 b0) * (2^(len-1) - p(b1:)))."""
    if len(bits) > 1:
        return (1 - 2 * bits[0]) * (2 ** (len(bits) - 1) - _pam_gray(bits[1:]))
    return float(1 - 2 * bits[0])


@functools.lru_cache(maxsize=None)
def _constellation_gray_np(bits_per_symbol: int) -> np.ndarray:
    """Unit-power Gray square QAM (sionna.mapping.Mapper("qam", m)): index
    bits MSB-first, even-position bits the real PAM coordinate, odd ones
    the imaginary one, each Gray-labelled."""
    m = bits_per_symbol
    assert m % 2 == 0, "square QAM needs an even number of bits"
    pts = np.empty(2 ** m, dtype=np.complex128)
    for idx in range(2 ** m):
        b = tuple((idx >> (m - 1 - i)) & 1 for i in range(m))
        pts[idx] = _pam_gray(b[0::2]) + 1j * _pam_gray(b[1::2])
    return (pts / np.sqrt(np.mean(np.abs(pts) ** 2))).astype(np.complex64)


def qam_constellation_gray(bits_per_symbol: int, device=None) -> torch.Tensor:
    """(M,) complex64 Gray/Sionna-convention unit-power constellation (a
    shared constant)."""
    return device_constant(_constellation_gray_np, bits_per_symbol,
                           device=device)


def qam_bit_labels_msb(bits_per_symbol: int, device=None) -> torch.Tensor:
    """(M, m) int64; row idx = natural-binary MSB-first bits of idx."""
    m = bits_per_symbol
    idx = torch.arange(2 ** m, device=device)
    return (idx[:, None] >> torch.arange(m - 1, -1, -1, device=device)) & 1


def bits_to_index_msb(bits: torch.Tensor, bits_per_symbol: int
                      ) -> torch.Tensor:
    """Pack bits (..., n_sym * m) -> symbol indices (..., n_sym), MSB-first
    (reference bits_to_symbol_indices, esn_ofdm_mimo_via_cdl.py:81-87)."""
    m = bits_per_symbol
    groups = bits.reshape(*bits.shape[:-1], bits.shape[-1] // m, m)
    powers = 2 ** torch.arange(m - 1, -1, -1, device=bits.device)
    return (groups.to(torch.int64) * powers).sum(-1)


def bits_to_symbols_gray(bits: torch.Tensor, bits_per_symbol: int
                         ) -> torch.Tensor:
    """Map bits (..., n_sym * m) -> Gray-QAM symbols (..., n_sym)."""
    return qam_constellation_gray(bits_per_symbol, bits.device)[
        bits_to_index_msb(bits, bits_per_symbol)]


def hard_demap_index_gray(symbols: torch.Tensor, bits_per_symbol: int
                          ) -> torch.Tensor:
    """Nearest-point index in the Gray constellation (the reference's hard
    SymbolDemapper, esn_ofdm_mimo_via_cdl.py:281-284)."""
    const = qam_constellation_gray(bits_per_symbol, symbols.device)
    return torch.argmin((symbols[..., None] - const).abs() ** 2, dim=-1)
