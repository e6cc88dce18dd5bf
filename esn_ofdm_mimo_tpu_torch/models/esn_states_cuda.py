"""Wrapper of the CUDA ESN state-harvest kernel (csrc/esn_states.cu), K3.

Counterpart of esn_ofdm_mimo_tpu/models/esn_pallas.py:esn_states_pallas.
For CUDA tensors it stacks the weight Wc = [Wt; W_in_t; W_fb_t] zero-padded
to (K_pad, n_p), scales the inputs, and launches the whole teacher-forced
recurrence once on PyTorch's current stream. For CPU tensors it runs the
plain version, models/esn.py:esn_states. fp32 throughout.

State noise: the kernel draws it from Philox seeded with `seed`; the plain
version from a torch.Generator seeded with the same value. The streams
differ, the distribution (noise * (U(0,1) - 0.5)) is the same.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import build
from .esn import EsnReservoir, EsnScale, esn_states, scale_inputs
from .esn_cuda import stacked_weights

# Launches of the kernel since the count was last reset (by the caller).
launches = 0

_N_RES_MAX = 640     # n_p = n_res rounded up to 64, two columns a thread


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("esn_states")
    for fn, n in ((lib.esn_states_k_pad, 3), (lib.esn_states_n_p, 1)):
        fn.argtypes = [ctypes.c_int] * n
        fn.restype = ctypes.c_int
    lib.esn_states_launch.argtypes = ([ctypes.c_void_p] * 4
                                      + [ctypes.c_int] * 5
                                      + [ctypes.c_float, ctypes.c_ulonglong,
                                         ctypes.c_void_p])
    lib.esn_states_launch.restype = ctypes.c_int
    return lib


def esn_states_cuda(res: EsnReservoir, scale: EsnScale, inputs: torch.Tensor,
                    teachers_scaled: torch.Tensor, seed: int = 0
                    ) -> torch.Tensor:
    """Drop-in for models/esn.esn_states: inputs (B, T, n_in) raw,
    teachers_scaled (B, T, n_out) -> states (B, T, n_res), states[:, 0] = 0.
    """
    global launches
    if inputs.device.type == "cpu":
        gen = torch.Generator(device="cpu")
        gen.manual_seed(int(seed))
        return esn_states(res, scale, inputs, teachers_scaled, gen)
    if inputs.device.type != "cuda":
        raise ValueError(f"unsupported device {inputs.device}")
    B, T, n_in = inputs.shape
    n_res = res.Wt.shape[0]
    n_out = teachers_scaled.shape[-1]
    for name, t in (("inputs", inputs), ("teachers_scaled", teachers_scaled),
                    ("Wt", res.Wt), ("W_in_t", res.W_in_t),
                    ("W_fb_t", res.W_fb_t)):
        if t.dtype != torch.float32 or t.device != inputs.device:
            raise ValueError(f"{name} must be float32 on {inputs.device}")
    if (teachers_scaled.shape[:2] != (B, T) or n_res > _N_RES_MAX
            or res.W_in_t.shape != (n_in, n_res)
            or res.W_fb_t.shape != (n_out, n_res)):
        raise ValueError(
            f"shapes the kernel does not take: inputs {tuple(inputs.shape)}, "
            f"teachers {tuple(teachers_scaled.shape)}, n_res {n_res} (needs "
            f"matching (B, T) and n_res <= {_N_RES_MAX})")
    lib = _lib()
    Wc = stacked_weights(res, n_in, n_out, lib.esn_states_k_pad(
        n_res, n_in, n_out), lib.esn_states_n_p(n_res))
    u = scale_inputs(scale, inputs).contiguous()
    d = teachers_scaled.contiguous()
    out = torch.empty(B, T, n_res, dtype=torch.float32, device=inputs.device)
    rc = lib.esn_states_launch(
        u.data_ptr(), d.data_ptr(), Wc.data_ptr(), out.data_ptr(), B, T,
        n_res, n_in, n_out, float(res.noise), int(seed) & (2**64 - 1),
        torch.cuda.current_stream(inputs.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"esn_states_launch failed: CUDA error {rc}")
    launches += 1
    return out
