"""Rapp power-amplifier soft clipping (port of esn_ofdm_mimo_tpu/ops/pa.py).

Reference OFDM_SISO_NBF_LDPC.py:300-301:
    x_NLD = x / (1 + (|x|/A)^(2p))^(1/(2p)),  A = sqrt(var_x) * 10^(clip_db/20)
"""
from __future__ import annotations

import numpy as np
import torch


def rapp_pa(x: torch.Tensor, a_clip, smoothness: float = 1.0) -> torch.Tensor:
    """Rapp soft clipping; `a_clip` is a float or broadcasts against the
    leading axes of x."""
    p = smoothness
    a = torch.as_tensor(a_clip, dtype=torch.float32, device=x.device)
    if a.ndim > 0:
        a = a[..., None]
    mag_ratio = x.abs() / a
    return x / (1.0 + mag_ratio ** (2 * p)) ** (1.0 / (2 * p))


def clip_amplitude(var_x: float, clip_level_db: float) -> float:
    """A_Clip = sqrt(var_x) * 10^(clip_db/20) (reference :235), evaluated
    in float32 like the JAX package's link budget."""
    a = np.sqrt(np.float32(var_x)) * np.float32(10.0 ** (clip_level_db / 20.0))
    return float(a)
