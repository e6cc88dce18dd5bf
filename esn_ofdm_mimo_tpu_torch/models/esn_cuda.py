"""Wrapper of the CUDA ESN predict kernels: K2 (csrc/esn_predict.cu, per-row
readout from L2), K4 (csrc/esn_predict_grouped.cu, the tile's readout
slots staged in shared memory) and K5 (csrc/esn_predict_ablate.cu, builds of
K2 with parts of the step switched off, for the micro-benchmark
tools/bench_micro_torch.py; `esn_predict_ablate_cuda`).

Counterpart of esn_ofdm_mimo_tpu/models/esn_pallas.py:esn_predict_pallas;
`readout="grouped"` is its ESN_TPU_PREDICT_READOUT=grouped kernel. For CUDA
tensors it lays the operands out for the kernel — the stacked weight Wc =
[Wt; W_in_t; W_fb_t] zero-padded to (K_pad, n_p), the scaled inputs
time-major (T, n_in, B), the grouped readout (G, F, n_out) as is — and
launches the whole T-step recurrence once on PyTorch's current stream. For
CPU tensors it runs the plain version, models/esn.py:esn_predict, for either
readout. The kernels work in fp32 throughout, like the plain version.

State noise: the kernel draws it from Philox seeded with `seed`; the plain
version from a torch.Generator seeded with the same value. The streams
differ, the distribution (noise * (U(0,1) - 0.5)) is the same.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import build
from .esn import (ABLATE_PARTS, EsnReservoir, EsnScale, esn_predict,
                  esn_predict_ablate, scale_inputs)

# Launches of K2, of K4 and of K5 since the counts were last reset (by the
# caller).
launches = 0
launches_grouped = 0
launches_ablate = 0

_N_RES_MAX = 640     # n_p = n_res rounded up to 64, at most 10 x 64
_N_OUT_MAX = 32


_SOURCES = {"per_row": "esn_predict", "grouped": "esn_predict_grouped",
            "ablate": "esn_predict_ablate"}
# K5: the mask bit of each part (csrc/esn_predict_core.cuh, enum Off), the
# sets of switched-off parts that are built, and the one reservoir width
_OFF_BIT = {part: 1 << i for i, part in enumerate(ABLATE_PARTS)}
ABLATE_BUILDS = (frozenset(),) + tuple(frozenset((p,)) for p in ABLATE_PARTS) \
    + (frozenset(ABLATE_PARTS),)
_ABLATE_NJ4 = 5


@functools.lru_cache(maxsize=None)
def _lib(readout: str):
    """(k_pad, launch) of K2 (readout "per_row"), K4 ("grouped") or K5
    ("ablate", whose launch takes the mask of switched-off parts after
    n_forget)."""
    name = _SOURCES[readout]
    lib = build.load(name)
    k_pad, launch = (getattr(lib, f"{name}_k_pad"),
                     getattr(lib, f"{name}_launch"))
    k_pad.argtypes = [ctypes.c_int] * 3
    launch.argtypes = ([ctypes.c_void_p] * 4
                       + [ctypes.c_int] * (8 if readout == "ablate" else 7)
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_ulonglong,
                          ctypes.c_void_p])
    k_pad.restype = launch.restype = ctypes.c_int
    return k_pad, launch


def grouped_slots(G: int, Dg: int) -> int:
    """Readouts a 64-row kernel tile over runs of Dg rows can touch: the JAX
    package's P = min(G, BC // Dg + 2) at the port's tile of 64 rows."""
    return min(G, 64 // Dg + 2)


def grouped_viable(G: int, Dg: int) -> bool:
    """The JAX package's condition for its grouped kernel: Dg > 1, P <= 4."""
    return Dg > 1 and grouped_slots(G, Dg) <= 4


def stacked_weights(res: EsnReservoir, n_in: int, n_out: int, K_pad: int,
                    n_p: int | None = None) -> torch.Tensor:
    """Wc (K_pad, n_p): rows [Wt; W_in_t; W_fb_t], columns = neurons, zero
    padded (n_p defaults to n_res rounded up to 64)."""
    n_res = res.Wt.shape[0]
    n_p = -(-n_res // 64) * 64 if n_p is None else n_p
    Wc = torch.zeros(K_pad, n_p, dtype=torch.float32, device=res.Wt.device)
    Wc[:n_res, :n_res] = res.Wt
    Wc[n_res:n_res + n_in, :n_res] = res.W_in_t
    Wc[n_res + n_in:n_res + n_in + n_out, :n_res] = res.W_fb_t
    return Wc


def _check_operands(res: EsnReservoir, Wt_out: torch.Tensor,
                    inputs: torch.Tensor, n_forget: int):
    """Raise on what the predict kernels do not take; returns (B, T, n_in,
    n_res, G, n_out)."""
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
    return B, T, n_in, n_res, G, n_out


def esn_predict_cuda(res: EsnReservoir, scale: EsnScale,
                     Wt_out: torch.Tensor, inputs: torch.Tensor,
                     n_forget: int, seed: int = 0,
                     readout: str = "per_row") -> torch.Tensor:
    """Drop-in for models/esn.esn_predict: inputs (B, T, n_in) raw,
    Wt_out (G, n_res + n_in, n_out) grouped (B % G == 0) -> (B, T -
    n_forget, n_out) unscaled outputs. readout="grouped" launches K4 and
    needs grouped_viable(G, B // G)."""
    global launches, launches_grouped
    if readout not in ("per_row", "grouped"):
        raise ValueError(f"unknown readout {readout!r}")
    if inputs.device.type == "cpu":
        gen = torch.Generator(device="cpu")
        gen.manual_seed(int(seed))
        return esn_predict(res, scale, Wt_out, inputs, n_forget, gen)
    if inputs.device.type != "cuda":
        raise ValueError(f"unsupported device {inputs.device}")
    B, T, n_in, n_res, G, n_out = _check_operands(res, Wt_out, inputs,
                                                  n_forget)
    if readout == "grouped" and not grouped_viable(G, B // G):
        raise ValueError(f"the grouped readout kernel needs Dg > 1 and P <= "
                         f"4; got Dg={B // G}, P={grouped_slots(G, B // G)}")
    k_pad, launch = _lib(readout)
    Wc = stacked_weights(res, n_in, n_out, k_pad(n_res, n_in, n_out))
    u_fm = scale_inputs(scale, inputs).permute(1, 2, 0).contiguous()
    wout = Wt_out.contiguous()
    out = torch.empty(B, T - n_forget, n_out, dtype=torch.float32,
                      device=inputs.device)
    rc = launch(
        u_fm.data_ptr(), Wc.data_ptr(), wout.data_ptr(), out.data_ptr(),
        B, T, n_res, n_in, n_out, B // G, n_forget, float(res.noise),
        float(scale.teacher_scaling), int(seed) & (2**64 - 1),
        torch.cuda.current_stream(inputs.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ESN predict ({readout}) launch failed: CUDA "
                           f"error {rc}")
    if readout == "grouped":
        launches_grouped += 1
    else:
        launches += 1
    return out


def esn_predict_ablate_cuda(res: EsnReservoir, scale: EsnScale,
                            Wt_out: torch.Tensor, inputs: torch.Tensor,
                            n_forget: int, seed: int = 0, *,
                            readout: bool = True, feedback: bool = True,
                            noise: bool = True, tanh: bool = True,
                            recurrence_dot: bool = True) -> torch.Tensor:
    """models/esn.esn_predict_ablate on the card (K5): the predict
    recurrence with the named parts switched off at compile time. Operands
    as `esn_predict_cuda`; the micro-benchmark passes one readout per row
    (G == B). Built for the sets in ABLATE_BUILDS (all on, one part off,
    all off) and ceil(n_res / 64) == 5."""
    global launches_ablate
    on = dict(readout=readout, feedback=feedback, noise=noise, tanh=tanh,
              recurrence_dot=recurrence_dot)
    if inputs.device.type == "cpu":
        gen = torch.Generator(device="cpu")
        gen.manual_seed(int(seed))
        return esn_predict_ablate(res, scale, Wt_out, inputs, n_forget, gen,
                                  **on)
    if inputs.device.type != "cuda":
        raise ValueError(f"unsupported device {inputs.device}")
    B, T, n_in, n_res, G, n_out = _check_operands(res, Wt_out, inputs,
                                                  n_forget)
    off = frozenset(p for p in ABLATE_PARTS if not on[p])
    if off not in ABLATE_BUILDS or -(-n_res // 64) != _ABLATE_NJ4:
        raise ValueError(
            f"no ablation build for parts off {sorted(off)} at n_res "
            f"{n_res}: built are all on, one part off, all off, for "
            f"{64 * _ABLATE_NJ4 - 63} <= n_res <= {64 * _ABLATE_NJ4}")
    k_pad, launch = _lib("ablate")
    # a dropped term's weight rows are zeroed: the kernel skips whole chunks
    # of them and a chunk that straddles the term adds nothing
    zero = torch.zeros_like
    res_k = res._replace(
        Wt=res.Wt if recurrence_dot else zero(res.Wt),
        W_fb_t=res.W_fb_t if feedback else zero(res.W_fb_t))
    Wc = stacked_weights(res_k, n_in, n_out, k_pad(n_res, n_in, n_out))
    u_fm = scale_inputs(scale, inputs).permute(1, 2, 0).contiguous()
    wout = Wt_out.contiguous()
    out = torch.empty(B, T - n_forget, n_out, dtype=torch.float32,
                      device=inputs.device)
    rc = launch(
        u_fm.data_ptr(), Wc.data_ptr(), wout.data_ptr(), out.data_ptr(),
        B, T, n_res, n_in, n_out, B // G, n_forget,
        sum(_OFF_BIT[p] for p in off), float(res.noise),
        float(scale.teacher_scaling), int(seed) & (2**64 - 1),
        torch.cuda.current_stream(inputs.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ESN predict ablation {sorted(off)} launch "
                           f"failed: CUDA error {rc}")
    launches_ablate += 1
    return out
