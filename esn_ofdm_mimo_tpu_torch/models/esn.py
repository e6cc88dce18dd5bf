"""Echo-state network engine in plain PyTorch.

Port of esn_ofdm_mimo_tpu/models/esn.py: the reference's pyESN semantics
(libs/pyESN.py) — state update, teacher forcing during fit, self-feedback
during predict, post-tanh uniform state noise noise*(U(0,1)-0.5), input and
teacher scaling, least-squares readout — with B sequences sharing one
reservoir, so every recurrence step is one (B, n) @ (n, n) matmul. `scan`
becomes a Python loop.

Weights are stored transposed relative to pyESN (row-major `x @ W`):
    state' = tanh(s @ Wt + u @ W_in_t + d @ W_fb_t) + noise*(U(0,1)-0.5)

`esn_predict` is the plain version of the CUDA predict kernel
(models/esn_cuda.py). State noise comes from a `torch.Generator`: the JAX
package draws it from its own stream (`rbg`), so only its distribution is
shared.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import rng


class EsnReservoir(NamedTuple):
    """Fixed (untrained) reservoir weights, stored transposed."""
    Wt: torch.Tensor        # (n_res, n_res)
    W_in_t: torch.Tensor    # (n_in, n_res)
    W_fb_t: torch.Tensor    # (n_out, n_res)
    noise: float            # state-noise amplitude


class EsnScale(NamedTuple):
    """Input/teacher affine scalings (pyESN input_scaling/teacher_scaling)."""
    input_scaling: float
    input_shift: float
    teacher_scaling: float


def spectral_radius_power_iter(W: torch.Tensor, key: torch.Tensor,
                               iters: int = 96, tail: int = 32
                               ) -> torch.Tensor:
    """|lambda_max(W)| by power iteration; the geometric mean of the last
    `tail` growth factors averages out complex-pair oscillation."""
    v = rng.normal(key, (W.shape[0],))
    v = v / torch.linalg.vector_norm(v)
    logs = []
    for _ in range(iters):
        w = v @ W.T
        nw = torch.clamp_min(torch.linalg.vector_norm(w), 1e-30)
        v = w / nw
        logs.append(torch.log(nw))
    return torch.exp(torch.stack(logs[-tail:]).mean())


def init_reservoir(key: torch.Tensor, n_in: int, n_out: int, n_res: int,
                   spectral_radius: float = 0.9, sparsity: float = 0.1,
                   noise: float = 1e-3) -> EsnReservoir:
    """pyESN's draws (pyESN.py:93-109) from the key-compatible RNG: W ~
    U(-0.5, 0.5) zeroed w.p. sparsity, rescaled to `spectral_radius`;
    W_in, W_fb ~ U(-1, 1). The same key gives the JAX package's weights."""
    kw, km, ki, kf, kp = rng.split(key, 5).unbind(0)
    W = rng.uniform(kw, (n_res, n_res), -0.5, 0.5)
    W = W * (rng.uniform(km, (n_res, n_res)) >= sparsity)
    radius = spectral_radius_power_iter(W, kp)
    W = W * (spectral_radius / torch.clamp_min(radius, 1e-12))
    W_in = rng.uniform(ki, (n_res, n_in), -1.0, 1.0)
    W_fb = rng.uniform(kf, (n_res, n_out), -1.0, 1.0)
    return EsnReservoir(Wt=W.T.contiguous(), W_in_t=W_in.T.contiguous(),
                        W_fb_t=W_fb.T.contiguous(), noise=float(noise))


def scale_inputs(scale: EsnScale, x: torch.Tensor) -> torch.Tensor:
    return x * scale.input_scaling + scale.input_shift


def _state_noise(res: EsnReservoir, shape, like: torch.Tensor, generator):
    if res.noise == 0.0:
        return None
    u = torch.rand(shape, generator=generator, device=like.device,
                   dtype=like.dtype)
    return res.noise * (u - 0.5)


def esn_states(res: EsnReservoir, scale: EsnScale, inputs: torch.Tensor,
               teachers_scaled: torch.Tensor, generator=None) -> torch.Tensor:
    """Teacher-forced state harvest (pyESN.fit:179-182).

    inputs (B, T, n_in) raw, teachers_scaled (B, T, n_out) -> states
    (B, T, n_res) with states[:, 0] == 0."""
    B, T, _ = inputs.shape
    n_res = res.Wt.shape[0]
    u = scale_inputs(scale, inputs)
    drive = u[:, 1:] @ res.W_in_t + teachers_scaled[:, :-1] @ res.W_fb_t
    states = torch.zeros(B, T, n_res, dtype=res.Wt.dtype, device=u.device)
    s = states[:, 0]
    for t in range(1, T):
        s = torch.tanh(s @ res.Wt + drive[:, t - 1])
        z = _state_noise(res, s.shape, s, generator)
        if z is not None:
            s = s + z
        states[:, t] = s
    return states


def _readout_lstsq(ext: torch.Tensor, tgt: torch.Tensor,
                   rel_jitter: float = 1e-7) -> torch.Tensor:
    """Batched ridge least squares: ext (B, R, F), tgt (B, R, n_out) ->
    Wt_out (B, F, n_out) with ext @ Wt_out ~= tgt.

    The Gram is formed in fp32 with a relative Tikhonov jitter
    (rel_jitter * mean diagonal), factored by Cholesky in float64, and the
    solution gets one step of iterative refinement against the original
    operator. Tall systems (F <= R) solve the F x F primal normal
    equations; wide ones (the flagship: F = 316 > R = 128) the R x R dual
    ext^T (ext ext^T + lambda I)^-1 tgt — both tend to pyESN's min-norm pinv
    solution as lambda -> 0 (pyESN.py:189-192)."""
    _, R, F = ext.shape

    def factor(A):
        n = A.shape[-1]
        tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / n
        eye = torch.eye(n, dtype=A.dtype, device=A.device)
        A = A + (rel_jitter * tr)[:, None, None] * eye
        L = torch.linalg.cholesky(A.double())
        return lambda b: torch.cholesky_solve(b.double(), L).to(ext.dtype)

    extT = ext.transpose(-1, -2)
    if F <= R:
        solve = factor(extT @ ext)
        x = solve(extT @ tgt)
        return x + solve(extT @ (tgt - ext @ x))
    solve = factor(ext @ extT)
    z = solve(tgt)
    z = z + solve(tgt - ext @ (extT @ z))
    return extT @ z


def esn_fit(res: EsnReservoir, scale: EsnScale, inputs: torch.Tensor,
            outputs: torch.Tensor, n_forget: int, generator=None,
            rel_jitter: float = 1e-7) -> torch.Tensor:
    """Fit readouts for B sequences sharing one reservoir: inputs
    (B, T, n_in), outputs (B, T, n_out) raw -> Wt_out (B, n_res + n_in,
    n_out). The first n_forget rows are left out of the solve."""
    teachers_scaled = outputs * scale.teacher_scaling
    states = esn_states(res, scale, inputs, teachers_scaled, generator)
    ext = torch.cat([states, scale_inputs(scale, inputs)], dim=-1)
    return _readout_lstsq(ext[:, n_forget:], teachers_scaled[:, n_forget:],
                          rel_jitter)


def esn_predict(res: EsnReservoir, scale: EsnScale, Wt_out: torch.Tensor,
                inputs: torch.Tensor, n_forget: int, generator=None
                ) -> torch.Tensor:
    """Outputs with self-feedback from zero state (pyESN.predict,
    continuation=False). The plain version of the CUDA predict kernel.

    inputs (B, T, n_in) raw; Wt_out (G, F, n_out) grouped readouts with
    B % G == 0: readout g serves rows [g*Dg, (g+1)*Dg), Dg = B // G.
    Returns (B, T - n_forget, n_out) unscaled outputs."""
    B, T, n_in = inputs.shape
    n_res = res.Wt.shape[0]
    G, _, n_out = Wt_out.shape
    assert B % G == 0, (B, G)
    Dg = B // G
    u = scale_inputs(scale, inputs)
    Wt_s, Wt_u = Wt_out[:, :n_res], Wt_out[:, n_res:]
    drive = u @ res.W_in_t                                  # (B, T, n_res)
    o_in = (u.reshape(G, Dg * T, n_in) @ Wt_u).reshape(B, T, n_out)
    s = torch.zeros(B, n_res, dtype=u.dtype, device=u.device)
    o = torch.zeros(B, n_out, dtype=u.dtype, device=u.device)
    outs = torch.empty(B, T, n_out, dtype=u.dtype, device=u.device)
    for t in range(T):
        s = torch.tanh(s @ res.Wt + drive[:, t] + o @ res.W_fb_t)
        z = _state_noise(res, s.shape, s, generator)
        if z is not None:
            s = s + z
        o = (s.reshape(G, Dg, n_res) @ Wt_s).reshape(B, n_out) + o_in[:, t]
        outs[:, t] = o
    return outs[:, n_forget:] / scale.teacher_scaling


def key_seed(key: torch.Tensor) -> int:
    """The 64-bit seed of a (2,) key: seeds the ESN state-noise stream
    (a torch.Generator, or the CUDA kernel's Philox)."""
    k0, k1 = (int(x) for x in key.reshape(-1)[:2].tolist())
    return (k0 << 32) | k1


def generator_for(key: torch.Tensor, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(key_seed(key))
    return g
