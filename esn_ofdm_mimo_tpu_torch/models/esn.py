"""Echo-state network engine in plain PyTorch.

Port of esn_ofdm_mimo_tpu/models/esn.py: the reference's pyESN semantics
(libs/pyESN.py) — state update, teacher forcing during fit, self-feedback
during predict, post-tanh uniform state noise noise*(U(0,1)-0.5), input and
teacher scaling, least-squares readout — with B sequences sharing one
reservoir, so every recurrence step is one (B, n) @ (n, n) matmul. `scan`
becomes a Python loop.

Weights are stored transposed relative to pyESN (row-major `x @ W`):
    state' = tanh(s @ Wt + u @ W_in_t + d @ W_fb_t) + noise*(U(0,1)-0.5)

`esn_predict` is the plain version of the CUDA predict kernels
(models/esn_cuda.py), `esn_predict_ablate` that of their ablation builds,
`esn_states` that of the CUDA state-harvest kernel
(models/esn_states_cuda.py). `esn_fit` harvests its states through that
kernel's wrapper, which runs `esn_states` on CPU tensors; with
return_carry it also returns pyESN's (laststate, lastoutput) pair, from
which `esn_predict(..., init_carry=...)` continues (continuation=True).
State noise comes from a `torch.Generator`: the JAX package draws it from
its own stream (`rbg`), so only its distribution is shared.
"""
from __future__ import annotations

import functools
import os
from typing import NamedTuple

import torch

from ..ops.linalg import ns_solver
from ..utils import rng

# The readout solve (ESN_TPU_READOUT, the JAX package's switch and values):
# "ridge" (default), the JAX package's Newton-Schulz ridge solve; "pinv",
# its ablation, pyESN's unregularised float64 pseudo-inverse.
_READOUT_IMPL = os.environ.get("ESN_TPU_READOUT", "ridge")


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
    """Teacher-forced state harvest (pyESN.fit:179-182). The plain version
    of the CUDA state-harvest kernel.

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
    """Batched least squares: ext (B, R, F), tgt (B, R, n_out) -> Wt_out
    (B, F, n_out) with ext @ Wt_out ~= tgt.

    ESN_TPU_READOUT=ridge (the default) is the JAX package's solve: the fp32
    Gram with a relative Tikhonov jitter (rel_jitter * mean diagonal), its
    Newton-Schulz inverse (`ns_solver`, 40 iterations), and one step of
    iterative refinement against the original operator. The iteration
    resolves eigenvalues down to ~2^-40 of the largest only, so on an
    ill-conditioned Gram it regularises: an exact factorisation gives
    another readout, and other BERs. Tall systems (F <= R) solve the F x F
    primal normal equations; wide ones (the flagship: F = 316 > R = 128)
    the R x R dual ext^T (ext ext^T + lambda I)^-1 tgt; both tend to pyESN's
    min-norm pinv solution as lambda -> 0 (pyESN.py:189-192).

    ESN_TPU_READOUT=pinv is the JAX package's ablation: pyESN's
    unregularised float64 pinv(ext) @ tgt, cast back to fp32."""
    if _READOUT_IMPL == "pinv":
        return (torch.linalg.pinv(ext.double()) @ tgt.double()).to(ext.dtype)
    if _READOUT_IMPL != "ridge":
        raise ValueError(f"ESN_TPU_READOUT={_READOUT_IMPL!r}: expected "
                         f"'ridge' or 'pinv'")
    _, R, F = ext.shape

    def prepare(A):
        n = A.shape[-1]
        tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / n
        eye = torch.eye(n, dtype=A.dtype, device=A.device)
        return ns_solver(A + (rel_jitter * tr)[:, None, None] * eye)

    extT = ext.transpose(-1, -2)
    if F <= R:
        solve = prepare(extT @ ext)
        x = solve(extT @ tgt)
        return x + solve(extT @ (tgt - ext @ x))
    solve = prepare(ext @ extT)
    z = solve(tgt)
    z = z + solve(tgt - ext @ (extT @ z))
    return extT @ z


def esn_fit(res: EsnReservoir, scale: EsnScale, inputs: torch.Tensor,
            outputs: torch.Tensor, n_forget: int, seed=0,
            rel_jitter: float = 1e-7, return_carry: bool = False):
    """Train the readouts of B sequences that share one reservoir: inputs
    (B, T, n_in) and outputs (B, T, n_out) raw -> Wt_out (B, n_res + n_in,
    n_out), pyESN's W_out transposed. The states come from the CUDA
    state-harvest kernel on the card (its plain version on the CPU), state
    noise seeded with `seed` (an int, or a one-element int64 tensor on the
    inputs' device, `key_seed_tensor`'s); the scaled inputs are appended and
    the first `n_forget` rows left out of the solve (pyESN's `transient`).

    With return_carry=True it also returns (laststate (B, n_res),
    lastoutput_scaled (B, n_out)), pyESN's laststate / lastoutput
    (pyESN.fit:194-197), the carry of `esn_predict(..., init_carry=...)`."""
    from .esn_states_cuda import esn_states_cuda
    teachers_scaled = outputs * scale.teacher_scaling
    states = esn_states_cuda(res, scale, inputs, teachers_scaled, seed)
    ext = torch.cat([states, scale_inputs(scale, inputs)], dim=-1)
    Wt_out = _readout_lstsq(ext[:, n_forget:], teachers_scaled[:, n_forget:],
                            rel_jitter)
    if return_carry:
        return Wt_out, (states[:, -1], teachers_scaled[:, -1])
    return Wt_out


def broadcast_carry(init_carry, B: int, n_res: int, n_out: int,
                    like: torch.Tensor):
    """(s0, o0) of shapes (n_res,) / (1, n_res) / (B, n_res) and likewise
    for o0 -> contiguous (B, n_res), (B, n_out) tensors of `like`'s dtype
    and device; None -> zeros (pyESN's continuation=False)."""
    if init_carry is None:
        z = functools.partial(torch.zeros, dtype=like.dtype,
                              device=like.device)
        return z(B, n_res), z(B, n_out)
    s0, o0 = init_carry
    return tuple(torch.as_tensor(x, dtype=like.dtype, device=like.device)
                 .expand(B, n).contiguous()
                 for x, n in ((s0, n_res), (o0, n_out)))


ABLATE_PARTS = ("readout", "feedback", "noise", "tanh", "recurrence_dot")


def esn_predict_ablate(res: EsnReservoir, scale: EsnScale,
                       Wt_out: torch.Tensor, inputs: torch.Tensor,
                       n_forget: int, generator=None, *, readout: bool = True,
                       feedback: bool = True, noise: bool = True,
                       tanh: bool = True, recurrence_dot: bool = True,
                       init_carry=None) -> torch.Tensor:
    """The predict recurrence, each part of its step behind a switch. With
    every part on (the default) it is `esn_predict`; with parts off it is
    the plain version of the CUDA ablation builds, for attributing the
    step's time (the JAX package's tools/bench_micro.py:_mk_kernel). What a
    part computes when off: readout -> o = s'[:n_out]; feedback -> the
    W_fb o term dropped; noise -> none; tanh -> s' = 0.5 * pre;
    recurrence_dot -> pre = s + W_in u (+ W_fb o). Shapes and init_carry
    as `esn_predict`."""
    B, T, n_in = inputs.shape
    n_res = res.Wt.shape[0]
    G, _, n_out = Wt_out.shape
    assert B % G == 0, (B, G)
    Dg = B // G
    u = scale_inputs(scale, inputs)
    Wt_s, Wt_u = Wt_out[:, :n_res], Wt_out[:, n_res:]
    drive = u @ res.W_in_t
    o_in = (u.reshape(G, Dg * T, n_in) @ Wt_u).reshape(B, T, n_out)
    s, o = broadcast_carry(init_carry, B, n_res, n_out, u)
    outs = torch.empty(B, T, n_out, dtype=u.dtype, device=u.device)
    for t in range(T):
        pre = (s @ res.Wt if recurrence_dot else s) + drive[:, t]
        if feedback:
            pre = pre + o @ res.W_fb_t
        s = torch.tanh(pre) if tanh else 0.5 * pre
        z = _state_noise(res, s.shape, s, generator) if noise else None
        if z is not None:
            s = s + z
        if readout:
            o = ((s.reshape(G, Dg, n_res) @ Wt_s).reshape(B, n_out)
                 + o_in[:, t])
        else:
            o = s[:, :n_out]
        outs[:, t] = o
    return outs[:, n_forget:] / scale.teacher_scaling


def esn_predict(res: EsnReservoir, scale: EsnScale, Wt_out: torch.Tensor,
                inputs: torch.Tensor, n_forget: int, generator=None,
                init_carry=None) -> torch.Tensor:
    """Outputs with self-feedback (pyESN.predict). The plain version of the
    CUDA predict kernel: the step of `esn_predict_ablate` with every part
    on.

    inputs (B, T, n_in) raw; Wt_out (G, F, n_out) grouped readouts with
    B % G == 0: readout g serves rows [g*Dg, (g+1)*Dg), Dg = B // G.
    init_carry None starts from zero state and output (continuation=False,
    pyESN.predict:238-241); the (laststate, lastoutput_scaled) pair of
    `esn_fit(..., return_carry=True)`, broadcast over the rows, resumes
    where the fit left off (continuation=True, :234-237).
    Returns (B, T - n_forget, n_out) unscaled outputs."""
    return esn_predict_ablate(res, scale, Wt_out, inputs, n_forget, generator,
                              init_carry=init_carry)


def key_seed(key: torch.Tensor) -> int:
    """The 64-bit seed of a (2,) key: seeds the ESN state-noise stream
    (a torch.Generator, or the CUDA kernels' Philox)."""
    k0, k1 = (int(x) for x in key.reshape(-1)[:2].tolist())
    return (k0 << 32) | k1


def key_seed_tensor(keys: torch.Tensor) -> torch.Tensor:
    """`key_seed` of every key of a (..., 2) batch, computed where the keys
    are: an int64 tensor (...,) whose bits are the unsigned 64-bit seed
    (k0 << 32) | k1, so a k0 >= 2^31 reads as a negative int64. The CUDA
    kernels read their seed from it in device memory: no host sync; the
    plain versions seed a torch.Generator with the same 64 bits. The ESN
    functions take its elements as their `seed` on either device."""
    k = keys.to(torch.int64) & 0xFFFFFFFF
    k0, k1 = k[..., 0], k[..., 1]
    # k0 as a signed 32-bit value times 2^32 stays inside int64
    return (k0 - ((k0 >> 31) << 32)) * (1 << 32) | k1

