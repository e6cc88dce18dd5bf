"""Wrapper of the CUDA BP decoders: flooding (csrc/bp_decode.cu) and
row-layered (csrc/bp_decode_layered.cu).

Counterpart of esn_ofdm_mimo_tpu/ldpc/decode_pallas.py. For a CUDA tensor
the wrapper launches the kernel of the schedule (one codeword per thread
block, per-codeword early exit; see the source notes) on PyTorch's current
stream; for a CPU tensor it runs the plain version (ldpc/decode.py). There
is no fallback: a CUDA call that the kernel cannot take raises.

`pass1_iters` is accepted for the JAX package's interface. The TPU wrapper
needs its two-pass compaction because a 128-codeword tile exits only when
all its codewords have; this kernel exits per codeword, so its single pass
already is the two-pass result, bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import build
from .code import LdpcCode
from .decode import ALGOS, _check_args, _effective_cap, ldpc_decode_bp_plain

# Launches of the flooding and of the layered kernel since the counts were
# last reset (by the caller).
launches = 0
launches_layered = 0

_ALGO_ID = {a: i for i, a in enumerate(ALGOS)}
_DC = 8          # the check degree the kernels are built for
_DV_LAYERED = 4  # the variable degree the layered kernel is built for
_SOURCES = {"flooding": "bp_decode", "layered": "bp_decode_layered"}


@functools.lru_cache(maxsize=None)
def _lib(schedule: str):
    name = _SOURCES[schedule]
    fn = getattr(build.load(name), f"{name}_launch")
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


_CODE_TENSORS: dict = {}


def _code_tensors(code: LdpcCode, device: torch.device):
    """(inv_perm, shifts, info columns) as int32 tensors on `device`, kept
    per (code, device) — codes come from the cached make_qc_ldpc."""
    key = (id(code), str(device))
    hit = _CODE_TENSORS.get(key)
    if hit is None or hit[0] is not code:
        qc = code.qc
        as_i32 = lambda a: torch.as_tensor(a, dtype=torch.int32,
                                           device=device).contiguous()
        hit = _CODE_TENSORS[key] = (code, as_i32(qc.inv_perm),
                                    as_i32(qc.shifts), as_i32(qc.perm[code.m:]))
    return hit[1:]


def _launch(code: LdpcCode, llr: torch.Tensor, truth, cap: int, algo: str,
            minsum_scale: float, minsum_offset: float, schedule: str):
    global launches, launches_layered
    if llr.dtype != torch.float32 or llr.dim() != 2 or llr.shape[1] != code.n:
        raise ValueError(f"llr must be float32 (B, {code.n}); got "
                         f"{tuple(llr.shape)} {llr.dtype}")
    if code.dc != _DC or code.dv * code.qc.Z > 1024:
        raise ValueError(f"the BP kernels take dc = {_DC} and "
                         f"dv*Z <= 1024; got dc={code.dc}, "
                         f"dv*Z={code.dv * code.qc.Z}")
    if schedule == "layered" and (code.dv != _DV_LAYERED
                                  or code.qc.Z > 256):
        raise ValueError(f"the layered BP kernel takes dv = {_DV_LAYERED} "
                         f"and Z <= 256; got dv={code.dv}, Z={code.qc.Z}")
    llr = llr.contiguous()
    dev = llr.device
    B = llr.shape[0]
    inv_perm, shifts, info_cols = _code_tensors(code, dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    conv = torch.empty(B, dtype=torch.bool, device=dev)
    if truth is not None:
        if truth.shape != (B, code.k):
            raise ValueError(f"info_bits must be (B, {code.k})")
        truth = truth.to(device=dev, dtype=torch.int8).contiguous()
        out = torch.empty(B, dtype=torch.int32, device=dev)
        bits_ptr, err_ptr, truth_ptr = None, out.data_ptr(), truth.data_ptr()
    else:
        out = torch.empty(B, code.n, dtype=torch.int8, device=dev)
        bits_ptr, err_ptr, truth_ptr = out.data_ptr(), None, None
    rc = _lib(schedule)(llr.data_ptr(), inv_perm.data_ptr(), shifts.data_ptr(),
                truth_ptr, info_cols.data_ptr(), bits_ptr, err_ptr,
                iters.data_ptr(), conv.data_ptr(), B, code.qc.Z, code.dv,
                code.dc, code.k, cap, _ALGO_ID[algo], float(minsum_scale),
                float(minsum_offset), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{_SOURCES[schedule]}_launch failed: CUDA error "
                           f"{rc}")
    if schedule == "layered":
        launches_layered += 1
    else:
        launches += 1
    return out, {"iterations": iters, "converged": conv}


def _decode(code, llr, truth, max_iter, algo, minsum_scale, iter_cap,
            schedule, pass1_iters, minsum_offset):
    if llr.device.type == "cpu":
        return ldpc_decode_bp_plain(
            code, llr, max_iter, algo, minsum_scale, iter_cap=iter_cap,
            schedule=schedule, pass1_iters=pass1_iters,
            minsum_offset=minsum_offset, count_against=truth)
    if llr.device.type != "cuda":
        raise ValueError(f"unsupported device {llr.device}")
    _check_args(code, algo, schedule)
    cap = _effective_cap(max_iter, iter_cap)
    return _launch(code, llr, truth, cap, algo, minsum_scale, minsum_offset,
                   schedule)


def ldpc_decode_bp_cuda(code: LdpcCode, llr: torch.Tensor,
                        max_iter: int = 100, algo: str = "sumprod",
                        minsum_scale: float = 0.75, iter_cap=None,
                        schedule: str = "flooding", pass1_iters=None,
                        minsum_offset: float = 0.625):
    """llr (B, n) pipeline order -> (bits (B, n) int8, stats)."""
    return _decode(code, llr, None, max_iter, algo, minsum_scale, iter_cap,
                   schedule, pass1_iters, minsum_offset)


def ldpc_decode_bp_cuda_counts(code: LdpcCode, llr: torch.Tensor,
                               info_bits: torch.Tensor, max_iter: int = 100,
                               algo: str = "sumprod",
                               minsum_scale: float = 0.75, iter_cap=None,
                               schedule: str = "flooding", pass1_iters=None,
                               minsum_offset: float = 0.625):
    """Counts mode: info_bits (B, k) pipeline order -> (per-codeword
    info-bit errors (B,), stats); the kernel compares in place and writes
    no bits."""
    return _decode(code, llr, info_bits, max_iter, algo, minsum_scale,
                   iter_cap, schedule, pass1_iters, minsum_offset)
