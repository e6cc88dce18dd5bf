"""Wrapper of the CUDA ESN predict kernel (csrc/esn_predict.cu).

Counterpart of esn_ofdm_mimo_tpu/models/esn_pallas.py:esn_predict_pallas.
For CUDA tensors it lays the operands out for the kernel — the stacked
weight Wc = [Wt; W_in_t; W_fb_t] zero-padded to (K_pad, n_p), the scaled
inputs time-major (T, n_in, B), the grouped readout (G, F, n_out) as is —
and launches the whole T-step recurrence once on PyTorch's current stream.
For CPU tensors it runs the plain version, models/esn.py:esn_predict. The
kernel works in fp32 throughout, like the plain version.

State noise: the kernel draws it from Philox seeded with `seed`; the plain
version from a torch.Generator seeded with the same value. The streams
differ, the distribution (noise * (U(0,1) - 0.5)) is the same.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import build
from .esn import EsnReservoir, EsnScale, esn_predict, scale_inputs

# Launches of the kernel since the count was last reset (by the caller).
launches = 0

_N_RES_MAX = 640     # n_p = n_res rounded up to 64, at most 10 x 64
_N_OUT_MAX = 32


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("esn_predict")
    lib.esn_predict_k_pad.argtypes = [ctypes.c_int] * 3
    lib.esn_predict_k_pad.restype = ctypes.c_int
    fn = lib.esn_predict_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_ulonglong,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def stacked_weights(res: EsnReservoir, n_in: int, n_out: int, K_pad: int
                    ) -> torch.Tensor:
    """Wc (K_pad, n_p): rows [Wt; W_in_t; W_fb_t], columns = neurons, zero
    padded (n_p = n_res rounded up to 64)."""
    n_res = res.Wt.shape[0]
    n_p = -(-n_res // 64) * 64
    Wc = torch.zeros(K_pad, n_p, dtype=torch.float32, device=res.Wt.device)
    Wc[:n_res, :n_res] = res.Wt
    Wc[n_res:n_res + n_in, :n_res] = res.W_in_t
    Wc[n_res + n_in:n_res + n_in + n_out, :n_res] = res.W_fb_t
    return Wc


def esn_predict_cuda(res: EsnReservoir, scale: EsnScale,
                     Wt_out: torch.Tensor, inputs: torch.Tensor,
                     n_forget: int, seed: int = 0) -> torch.Tensor:
    """Drop-in for models/esn.esn_predict: inputs (B, T, n_in) raw,
    Wt_out (G, n_res + n_in, n_out) grouped (B % G == 0) -> (B, T -
    n_forget, n_out) unscaled outputs."""
    global launches
    if inputs.device.type == "cpu":
        gen = torch.Generator(device="cpu")
        gen.manual_seed(int(seed))
        return esn_predict(res, scale, Wt_out, inputs, n_forget, gen)
    if inputs.device.type != "cuda":
        raise ValueError(f"unsupported device {inputs.device}")
    B, T, n_in = inputs.shape
    n_res = res.Wt.shape[0]
    G, F, n_out = Wt_out.shape
    for name, t in (("inputs", inputs), ("Wt_out", Wt_out), ("Wt", res.Wt),
                    ("W_in_t", res.W_in_t), ("W_fb_t", res.W_fb_t)):
        if t.dtype != torch.float32 or t.device != inputs.device:
            raise ValueError(f"{name} must be float32 on {inputs.device}")
    if (B % G or F != n_res + n_in or n_res > _N_RES_MAX or n_out > _N_OUT_MAX
            or res.W_in_t.shape != (n_in, n_res)
            or res.W_fb_t.shape != (n_out, n_res) or not 0 <= n_forget < T):
        raise ValueError(
            f"shapes the kernel does not take: inputs {tuple(inputs.shape)}, "
            f"Wt_out {tuple(Wt_out.shape)}, n_res {n_res}, n_forget "
            f"{n_forget} (needs B % G == 0, F == n_res + n_in, n_res <= "
            f"{_N_RES_MAX}, n_out <= {_N_OUT_MAX})")
    lib = _lib()
    K_pad = lib.esn_predict_k_pad(n_res, n_in, n_out)
    Wc = stacked_weights(res, n_in, n_out, K_pad)
    u_fm = scale_inputs(scale, inputs).permute(1, 2, 0).contiguous()
    wout = Wt_out.contiguous()
    out = torch.empty(B, T - n_forget, n_out, dtype=torch.float32,
                      device=inputs.device)
    rc = lib.esn_predict_launch(
        u_fm.data_ptr(), Wc.data_ptr(), wout.data_ptr(), out.data_ptr(),
        B, T, n_res, n_in, n_out, B // G, n_forget, float(res.noise),
        float(scale.teacher_scaling), int(seed) & (2**64 - 1),
        torch.cuda.current_stream(inputs.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"esn_predict_launch failed: CUDA error {rc}")
    launches += 1
    return out
