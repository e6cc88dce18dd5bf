"""Channel analytics: per-subcarrier SVD capacity, rank and condition number.

Port of esn_ofdm_mimo_tpu/ops/analytics.py (reference
OFDM_SISO_NBF_LDPC.py:369-384). Per subcarrier k, S = svdvals(H_k):
    capacity_k = sum log2(1 + gamma * S^2), gamma = Pi / No / n_tx (the
                 SIMO/MIMO scripts' normalisation, OFDM_SIMO_1-2_NBF_LDPC.py
                 :372, the only one the pipelines use)
    rank_k     = #{S^2 >= max(1e-2 * s1^2, 10 * No / Pi)}
    cond_k     = s1 / max(s_min, 1e-12)
The JAX package computes S by Jacobi sweeps on a real-embedded Gram because
its TPU backend had no complex SVD; here it is `torch.linalg.svdvals`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SvdMetrics(NamedTuple):
    capacity_per_sc: torch.Tensor   # (...,) mean over subcarriers
    rank: torch.Tensor              # (..., N) effective rank per subcarrier
    cond: torch.Tensor              # (..., N) condition number per subcarrier


def channel_svd_metrics(H: torch.Tensor, power_per_sc: float,
                        noise_psd: float) -> SvdMetrics:
    """H (..., N, n_rx, n_tx) complex; the scalar link-budget terms are
    evaluated in float32, as the JAX package does."""
    S = torch.linalg.svdvals(H)                 # (..., N, min(n_rx, n_tx))
    s2 = S ** 2
    gamma = (np.float32(power_per_sc) / np.float32(noise_psd)
             / np.float32(H.shape[-1]))
    cap_k = torch.log2(1.0 + float(gamma) * s2).sum(-1)
    s1, smin = S[..., 0], S[..., -1]
    floor = float(np.float32(10.0) * (np.float32(noise_psd)
                                      / np.float32(power_per_sc)))
    thr = torch.clamp_min(1e-2 * s1 ** 2, floor)
    rank = (s2 >= thr[..., None]).sum(-1)
    cond = s1 / torch.clamp_min(smin, 1e-12)
    return SvdMetrics(cap_k.mean(-1), rank, cond)
