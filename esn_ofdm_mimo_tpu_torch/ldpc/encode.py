"""LDPC encoding (port of esn_ofdm_mimo_tpu/ldpc/encode.py).

codeword = [P @ u mod 2 | u], info bits in the last k positions.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import device_constant
from .code import LdpcCode


def _encoder_f32(code: LdpcCode) -> np.ndarray:
    return code.P.astype(np.float32)


def ldpc_encode(code: LdpcCode, u: torch.Tensor) -> torch.Tensor:
    """u (..., k) bits -> codeword (..., n) int8."""
    P = device_constant(_encoder_f32, code, device=u.device)
    # float products of 0/1 with sums <= k < 2^24 are exact
    parity = torch.remainder(u.to(torch.float32) @ P.T, 2.0)
    return torch.cat([parity.to(torch.int8), u.to(torch.int8)], dim=-1)


def ldpc_extract_message(code: LdpcCode, cw: torch.Tensor) -> torch.Tensor:
    """codeword (..., n) -> info bits (..., k), the last k positions."""
    return cw[..., code.m:]
