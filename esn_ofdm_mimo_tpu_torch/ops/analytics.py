"""Channel analytics: per-subcarrier SVD capacity, rank and condition number.

Port of esn_ofdm_mimo_tpu/ops/analytics.py (reference
OFDM_SISO_NBF_LDPC.py:369-384). Per subcarrier k, S = svdvals(H_k):
    capacity_k = sum log2(1 + gamma * S^2), gamma = Pi / No / n_tx (the
                 SIMO/MIMO scripts' normalisation, OFDM_SIMO_1-2_NBF_LDPC.py
                 :372, the only one the pipelines use)
    rank_k     = #{S^2 >= max(1e-2 * s1^2, 10 * No / Pi)}
    cond_k     = s1 / max(s_min, 1e-12)

S comes from `svdvals_small`, the JAX package's algorithm
(esn_ofdm_mimo_tpu/ops/linalg_mxu.py:svdvals_small): cyclic Jacobi sweeps
on the real-embedded Gram. On the card it is a CUDA kernel written by hand
(csrc/svdvals_small.cu), on the CPU its plain PyTorch version. A library
SVD (`torch.linalg.svdvals`) reads its convergence info on the host, so a
CUDA graph could not hold it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils import build

# Launches of the SVD kernel since the count was last reset (by the caller).
launches = 0

SWEEPS = 8            # the JAX package's default
SVD_N_T = (1, 2, 4)   # columns the kernel is built for
SVD_N_R_MAX = 8


class SvdMetrics(NamedTuple):
    capacity_per_sc: torch.Tensor   # (...,) mean over subcarriers
    rank: torch.Tensor              # (..., N) effective rank per subcarrier
    cond: torch.Tensor              # (..., N) condition number per subcarrier


def _check_shape(H: torch.Tensor):
    if H.dtype != torch.complex64 or H.dim() < 2:
        raise ValueError(f"svdvals_small takes complex64 (..., n_r, n_t), "
                         f"not {H.dtype} {tuple(H.shape)}")
    n_r, n_t = H.shape[-2:]
    if n_t not in SVD_N_T or not 1 <= n_r <= SVD_N_R_MAX:
        raise ValueError(f"svdvals_small takes n_t in {SVD_N_T} and n_r <= "
                         f"{SVD_N_R_MAX}, not {n_r} x {n_t}")


def svdvals_small_plain(H: torch.Tensor) -> torch.Tensor:
    """Singular values (descending) of batched complex (..., n_r, n_t): the
    eigenvalues of the real embedding of G = H^H H, by SWEEPS cyclic
    Jacobi sweeps (JAX linalg_mxu.py:_jacobi_sweeps_sym), come in
    duplicated pairs; sorted descending, every second one, square-rooted.

    Each rotation is applied to two rows, then to two columns: JAX's dense
    J^T G J with its zero terms left out. Every step is one elementwise
    operation in a fixed order (the Gram a left fold over He's rows), which
    the kernel repeats without contracted multiply-adds, so on the card the
    two agree bit for bit."""
    _check_shape(H)
    n_t = H.shape[-1]
    n = 2 * n_t
    Hr, Hi = H.real, H.imag
    He = torch.cat([torch.cat([Hr, -Hi], -1), torch.cat([Hi, Hr], -1)], -2)
    G = He[..., 0, :, None] * He[..., 0, None, :]
    for i in range(1, He.shape[-2]):
        G = G + He[..., i, :, None] * He[..., i, None, :]
    for _ in range(SWEEPS):
        for p in range(n - 1):
            for q in range(p + 1, n):
                app, aqq, apq = G[..., p, p], G[..., q, q], G[..., p, q]
                big = apq.abs() > 1e-30
                den = torch.where(big, apq, torch.full_like(apq, 1e-30))
                tau = (aqq - app) / (2.0 * den)
                t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
                t = torch.where(big, t, torch.zeros_like(t))
                c = torch.reciprocal(torch.sqrt(1.0 + t * t))
                s = t * c
                c, s = c[..., None], s[..., None]
                gp, gq = G[..., p, :].clone(), G[..., q, :].clone()
                G[..., p, :] = c * gp - s * gq
                G[..., q, :] = s * gp + c * gq
                gp, gq = G[..., :, p].clone(), G[..., :, q].clone()
                G[..., :, p] = gp * c - gq * s
                G[..., :, q] = gp * s + gq * c
    ev = torch.diagonal(G, dim1=-2, dim2=-1)
    ev = torch.sort(ev, dim=-1, descending=True).values[..., ::2]
    return torch.sqrt(torch.clamp_min(ev, 0.0))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("svdvals_small")
    lib.svdvals_small_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.svdvals_small_launch.restype = ctypes.c_int
    return lib


def svdvals_small(H: torch.Tensor) -> torch.Tensor:
    """Singular values (descending) of batched complex64 (..., n_r, n_t),
    n_t in {1, 2, 4}, n_r <= 8 -> float32 (..., n_t). On a CUDA tensor the
    kernel (csrc/svdvals_small.cu, one thread a matrix); on a CPU tensor
    `svdvals_small_plain`. Other shapes raise."""
    global launches
    if H.device.type == "cpu":
        return svdvals_small_plain(H)
    if H.device.type != "cuda":
        raise ValueError(f"unsupported device {H.device}")
    _check_shape(H)
    n_r, n_t = H.shape[-2:]
    Hc = torch.view_as_real(H.contiguous())
    batch = H.numel() // (n_r * n_t)
    S = torch.empty(H.shape[:-2] + (n_t,), dtype=torch.float32,
                    device=H.device)
    rc = _lib().svdvals_small_launch(
        Hc.data_ptr(), S.data_ptr(), batch, n_r, n_t, SWEEPS,
        torch.cuda.current_stream(H.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"svdvals_small_launch failed at {n_r} x {n_t}, "
                           f"batch {batch}: CUDA error {rc}")
    launches += 1
    return S


def channel_svd_metrics(H: torch.Tensor, power_per_sc, noise_psd: float
                        ) -> SvdMetrics:
    """H (..., N, n_rx, n_tx) complex; power_per_sc Pi a float or a 0-d
    float32 tensor on H's device (an EbnoRow's, so a CUDA graph reads it
    from device memory). The link-budget terms are evaluated in float32
    with true divisions, as the JAX package does."""
    S = svdvals_small(H)                        # (..., N, n_tx) descending
    s2 = S ** 2
    pi = torch.as_tensor(power_per_sc, dtype=torch.float32, device=H.device)
    No = torch.full((), float(np.float32(noise_psd)), dtype=torch.float32,
                    device=H.device)
    gamma = pi / No / H.shape[-1]      # n_tx in {1, 2, 4}: an exact scaling
    cap_k = torch.log2(1.0 + gamma * s2).sum(-1)
    s1, smin = S[..., 0], S[..., -1]
    thr = torch.maximum(1e-2 * s1 ** 2, 10.0 * (No / pi))
    rank = (s2 >= thr[..., None]).sum(-1)
    cond = s1 / torch.clamp_min(smin, 1e-12)
    return SvdMetrics(cap_k.mean(-1), rank, cond)
