"""5G-style OFDM resource grid for the system-model-1 pipeline (port of
esn_ofdm_mimo_tpu/sm1/grid.py).

The reference's Sionna objects (esn_ofdm_mimo_via_cdl.py:37-76):
`ResourceGrid(num_ofdm_symbols=14, fft_size=76, subcarrier_spacing=15e3,
cyclic_prefix_length=6, num_guard_carriers=[5,6], dc_null=True,
pilot_pattern="kronecker", pilot_ofdm_symbol_indices=[2,11])` with
`num_streams_per_tx=4`, plus `ResourceGridMapper`, `ebnodb2no` and
`subcarrier_frequencies`.

  * Effective subcarriers = fft_size minus the guards minus the DC null
    (76 - 5 - 6 - 1 = 64); subcarrier k sits at (k - fft_size/2) * scs.
  * Kronecker pilots: pilot OFDM symbols are reserved whole; stream j
    sends QPSK pilots on effective subcarriers j::S scaled by sqrt(S).
  * Data REs fill the non-pilot symbols row-major over (symbol, subcarrier)
    per stream: 64 * 12 = 768 per stream.
  * No = (D / R) (fft / (fft + cp)) / (Eb/No r m) = 0.39733 10^(-EbNo/10)
    for this grid.

The index sets are static numpy; the pilots draw through the port's
`rng.randint`, so they equal the JAX package's at the same key.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..utils import rng


@dataclasses.dataclass(frozen=True)
class ResourceGrid:
    num_ofdm_symbols: int = 14
    fft_size: int = 76
    subcarrier_spacing: float = 15e3
    num_streams: int = 4
    cyclic_prefix_length: int = 6
    num_guard_left: int = 5
    num_guard_right: int = 6
    dc_null: bool = True
    pilot_ofdm_symbol_indices: Tuple[int, ...] = (2, 11)

    # ---- static index sets -------------------------------------------------
    @property
    def effective_subcarriers(self) -> np.ndarray:
        """FFT-bin indices (DC at fft_size//2) that carry REs."""
        idx = np.arange(self.fft_size)
        keep = (idx >= self.num_guard_left) & \
               (idx < self.fft_size - self.num_guard_right)
        if self.dc_null:
            keep &= idx != self.fft_size // 2
        return idx[keep]

    @property
    def num_effective_subcarriers(self) -> int:
        return len(self.effective_subcarriers)

    @property
    def data_symbol_indices(self) -> np.ndarray:
        pil = set(self.pilot_ofdm_symbol_indices)
        return np.array([t for t in range(self.num_ofdm_symbols)
                         if t not in pil])

    @property
    def num_data_symbols(self) -> int:
        """Data REs per stream (Sionna rg.num_data_symbols): 64*12 = 768."""
        return self.num_effective_subcarriers * len(self.data_symbol_indices)

    @property
    def num_resource_elements(self) -> int:
        """All REs per stream (pilot + data): 64*14 = 896."""
        return self.num_effective_subcarriers * self.num_ofdm_symbols

    @property
    def ofdm_symbol_duration(self) -> float:
        return (self.fft_size + self.cyclic_prefix_length) / (
            self.fft_size * self.subcarrier_spacing)

    # ---- pilots ------------------------------------------------------------
    def pilot_mask(self) -> np.ndarray:
        """(S, T, F_eff) bool: True where stream s transmits a pilot."""
        S, T = self.num_streams, self.num_ofdm_symbols
        F = self.num_effective_subcarriers
        mask = np.zeros((S, T, F), dtype=bool)
        for s in range(S):
            for t in self.pilot_ofdm_symbol_indices:
                mask[s, t, s::S] = True
        return mask

    def pilot_grid(self, key: torch.Tensor) -> torch.Tensor:
        """(S, T, F_eff) complex64 pilot values (zero off-pattern) on the
        key's device: random QPSK scaled by sqrt(num_streams)."""
        S, T = self.num_streams, self.num_ofdm_symbols
        F = self.num_effective_subcarriers
        mask = torch.as_tensor(self.pilot_mask(), device=key.device)
        qb = rng.randint(key, (2, S, T, F), 0, 2).to(torch.float32)
        r2 = float(np.float32(np.sqrt(2.0)))
        re, im = (1.0 - 2.0 * qb[0]) / r2, (1.0 - 2.0 * qb[1]) / r2
        amp = float(np.sqrt(float(S)))
        p = amp * torch.complex(re, im)
        return torch.where(mask, p, torch.zeros_like(p))

    # ---- data mapping ------------------------------------------------------
    def map_data(self, x_data: torch.Tensor, pilots: torch.Tensor
                 ) -> torch.Tensor:
        """x_data (..., S, num_data_symbols) complex, pilots (S, T, F_eff) ->
        (..., S, T, F_eff): the ResourceGridMapper (reference :72)."""
        *lead, S, _ = x_data.shape
        F = self.num_effective_subcarriers
        xd = x_data.reshape(*lead, S, len(self.data_symbol_indices), F)
        grid = torch.zeros(*lead, S, self.num_ofdm_symbols, F,
                           dtype=x_data.dtype, device=x_data.device)
        grid[..., torch.as_tensor(self.data_symbol_indices,
                                  device=x_data.device), :] = xd
        return grid + pilots

    def extract_data(self, grid: torch.Tensor) -> torch.Tensor:
        """Inverse of map_data's data part: (..., T, F_eff) -> (..., D)."""
        out = grid[..., torch.as_tensor(self.data_symbol_indices,
                                        device=grid.device), :]
        return out.reshape(*grid.shape[:-2], self.num_data_symbols)


def subcarrier_frequencies(rg: ResourceGrid) -> np.ndarray:
    """Baseband frequency of every FFT bin (Hz), DC at fft_size//2."""
    k = np.arange(rg.fft_size) - rg.fft_size // 2
    return (k * rg.subcarrier_spacing).astype(np.float64)


def ebnodb2no(ebno_db, bits_per_symbol: int, coderate: float,
              rg: ResourceGrid) -> float:
    """Eb/N0 [dB] -> complex noise variance per RE, in float32 as the JAX
    package evaluates it: No = (D / R) * (fft / (fft + cp)) / (Eb/No * r *
    m), D data REs and R REs per stream (the pilot and cyclic-prefix
    overheads are credited to the data bits)."""
    f32 = np.float32
    ebno = f32(10.0) ** (f32(ebno_db) / f32(10.0))
    overhead = (rg.num_data_symbols / rg.num_resource_elements) * (
        rg.fft_size / (rg.fft_size + rg.cyclic_prefix_length))
    return float(f32(overhead) / (ebno * f32(coderate)
                                  * f32(bits_per_symbol)))
