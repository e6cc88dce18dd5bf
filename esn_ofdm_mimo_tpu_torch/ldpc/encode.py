"""LDPC encoding (port of esn_ofdm_mimo_tpu/ldpc/encode.py).

codeword = [P @ u mod 2 | u], info bits in the last k positions.
"""
from __future__ import annotations

import torch

from .code import LdpcCode


def ldpc_encode(code: LdpcCode, u: torch.Tensor) -> torch.Tensor:
    """u (..., k) bits -> codeword (..., n) int8."""
    P = torch.as_tensor(code.P, dtype=torch.float32, device=u.device)
    # float products of 0/1 with sums <= k < 2^24 are exact
    parity = torch.remainder(u.to(torch.float32) @ P.T, 2.0)
    return torch.cat([parity.to(torch.int8), u.to(torch.int8)], dim=-1)

