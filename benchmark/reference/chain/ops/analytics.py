"""Channel analytics: per-subcarrier SVD capacity, rank and condition number.

Port of esn_ofdm_mimo_tpu/ops/analytics.py (reference
OFDM_SISO_NBF_LDPC.py:369-384). Per subcarrier k, S = svdvals(H_k):
    capacity_k = sum log2(1 + gamma * S^2), gamma = Pi / No / n_tx (the
                 SIMO/MIMO scripts' normalisation, OFDM_SIMO_1-2_NBF_LDPC.py
                 :372, the only one the pipelines use)
    rank_k     = #{S^2 >= max(1e-2 * s1^2, 10 * No / Pi)}
    cond_k     = s1 / max(s_min, 1e-12)

S comes from `svdvals_small`: the JAX package's cyclic Jacobi sweeps
(esn_ofdm_mimo_tpu/ops/linalg_mxu.py:svdvals_small) on the Hermitian
n_t x n_t Gram H^H H, where JAX runs them on its 2 n_t x 2 n_t real
embedding (`svdvals_small_plain` says why the values agree). Here it is
the plain PyTorch form alone, on any device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


SWEEPS = 8            # the JAX package's default
SVD_N_T = (1, 2, 4)
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
    square roots of the eigenvalues of the Hermitian n_t x n_t Gram
    G = H^H H, by SWEEPS cyclic complex Jacobi sweeps over the pairs p < q
    in JAX's order (linalg_mxu.py:_jacobi_sweeps_sym).

    The JAX package runs the same sweeps on the 2 n_t x 2 n_t real
    embedding of G, whose eigenvalues are G's, each twice; a complex
    rotation of G does what that algorithm's rotations of the pairs (p, q)
    and (p + n_t, q + n_t) do together, so this form gives the same values
    to float32 rounding with n_t (n_t - 1) / 2 rotations a sweep in place of
    n_t (2 n_t - 1) (tests/test_torch_svdvals.py holds it to JAX's).

    Each step is one float32 elementwise operation on real and imaginary
    parts kept apart, in a fixed order (no complex multiply, whose order is
    torch's), and only G's upper triangle is kept. The kernel
    (csrc/svdvals_small.cu) repeats the steps without contracted
    multiply-adds, so on the card the two agree bit for bit:
      Gram: G_jk = sum_i (hr_ij hr_ik + hi_ij hi_ik)
                   + i (hr_ij hi_ik - hi_ij hr_ik), j <= k, a left fold
            over the rows i; the diagonal is real.
      Rotation (p, q): m = sqrt(ar ar + ai ai) of a_pq = ar + i ai,
            m_d = m where m > 1e-30 else 1e-30, e = a_pq / m_d,
            tau = (a_qq - a_pp) / (2 m_d),
            t = sign(tau) / (|tau| + sqrt(1 + tau^2)), 0 where m <= 1e-30,
            c = 1 / sqrt(1 + t^2), s = t c; for every other r
            G_rp <- G_rp c - (G_rq conj(e)) s, G_rq <- (G_rp e) s + G_rq c;
            a_pp <- a_pp - t m, a_qq <- a_qq + t m, a_pq <- 0; all of it
            only where t != 0: where t == 0 no rotation runs and G stays
            as it is, as in JAX (whose rotation is the identity there).
      Output: the diagonal sorted descending, sqrt(max(., 0))."""
    return _hermitian_jacobi(H)[0]


def _hermitian_jacobi(H: torch.Tensor) -> tuple:
    """(svdvals_small_plain's singular values, int32 (...,) the rotations
    that ran on each matrix, t != 0): the second is the work the function
    needs on H (tools/bench_svd_torch.py:svd_work)."""
    _check_shape(H)
    n_r, n_t = H.shape[-2:]
    hr, hi = H.real, H.imag
    d = [None] * n_t                 # the real diagonal
    u = {}                           # (j, k), j < k: (re, im) of G_jk
    for i in range(n_r):
        for j in range(n_t):
            a, b = hr[..., i, j], hi[..., i, j]
            term = a * a + b * b
            d[j] = term if i == 0 else d[j] + term
            for k in range(j + 1, n_t):
                c, e = hr[..., i, k], hi[..., i, k]
                tr, ti = a * c + b * e, a * e - b * c
                u[j, k] = (tr, ti) if i == 0 else (u[j, k][0] + tr,
                                                   u[j, k][1] + ti)

    def get(r, p):
        """G_rp (r != p) from the upper triangle."""
        return u[r, p] if r < p else (u[p, r][0], -u[p, r][1])

    def put(r, p, v):
        if r < p:
            u[r, p] = v
        else:
            u[p, r] = (v[0], -v[1])

    runs = torch.zeros(H.shape[:-2], dtype=torch.int32, device=H.device)
    for _ in range(SWEEPS):
        for p in range(n_t - 1):
            for q in range(p + 1, n_t):
                ar, ai = u[p, q]
                m = torch.sqrt(ar * ar + ai * ai)
                big = m > 1e-30
                md = torch.where(big, m, torch.full_like(m, 1e-30))
                er, ei = ar / md, ai / md
                tau = (d[q] - d[p]) / (2.0 * md)
                t = torch.sign(tau) / (tau.abs()
                                       + torch.sqrt(1.0 + tau * tau))
                t = torch.where(big, t, torch.zeros_like(t))
                c = torch.reciprocal(torch.sqrt(1.0 + t * t))
                s = t * c
                rot = t != 0.0
                runs += rot
                for r in range(n_t):
                    if r == p or r == q:
                        continue
                    (xr, xi), (yr, yi) = get(r, p), get(r, q)
                    ye_r, ye_i = yr * er + yi * ei, yi * er - yr * ei
                    xe_r, xe_i = xr * er - xi * ei, xr * ei + xi * er
                    put(r, p, (torch.where(rot, xr * c - ye_r * s, xr),
                               torch.where(rot, xi * c - ye_i * s, xi)))
                    put(r, q, (torch.where(rot, xe_r * s + yr * c, yr),
                               torch.where(rot, xe_i * s + yi * c, yi)))
                tm = t * m
                d[p] = torch.where(rot, d[p] - tm, d[p])
                d[q] = torch.where(rot, d[q] + tm, d[q])
                zero = torch.zeros_like(ar)
                u[p, q] = (torch.where(rot, zero, ar),
                           torch.where(rot, zero, ai))
    ev = torch.stack(d, -1)
    ev = torch.sort(ev, dim=-1, descending=True).values
    return torch.sqrt(torch.clamp_min(ev, 0.0)), runs


def svdvals_small(H: torch.Tensor) -> torch.Tensor:
    """Singular values (descending) of batched complex64 (..., n_r, n_t),
    n_t in {1, 2, 4}, n_r <= 8 -> float32 (..., n_t), on any device."""
    return svdvals_small_plain(H)


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
