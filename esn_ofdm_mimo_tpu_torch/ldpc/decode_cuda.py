"""Wrapper of the CUDA BP decoders: flooding (csrc/bp_decode.cu) and
row-layered (csrc/bp_decode_layered.cu); beside them both kernels'
attribution builds (`ldpc_decode_bp_diag`, for tools/bench_bp_torch.py) and
the sum-product check rule on its own (`sumprod_rule`, for chip_smoke.py).

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
from typing import NamedTuple

import torch

from ..utils import build
from .code import LdpcCode
from .decode import (ALGOS, _check_args, _decode_flooding,
                     _decode_layered, _effective_cap, ldpc_decode_bp_plain,
                     log_ratio, tanh_half)

# Launches of the flooding and of the layered kernel since the counts were
# last reset (by the caller); of the attribution builds and of the check
# rule on its own, counted apart: they are no decode.
launches = 0
launches_layered = 0
launches_diag = 0
launches_rule = 0

# The attribution builds of both BP kernels (masks of decode.DIAG_*; each
# holds DIAG_FIXED): the kernel at a fixed iteration count, then the check
# rule a copy of its inputs, the syndrome removed, the variable update (in
# the layered kernel: the posterior write) removed, and all three.
DIAG_BUILDS = (1, 3, 5, 9, 15)

_ALGO_ID = {a: i for i, a in enumerate(ALGOS)}
_DC, _DV = 8, 4  # the check and variable degrees the kernels are built for
_SOURCES = {"flooding": "bp_decode", "layered": "bp_decode_layered"}


# Threads a block of the flooding kernel may have, and the layered kernel's
# (csrc/bp_decode.cu, csrc/bp_decode_layered.cu)
_FLOOD_THREADS, _LAYERED_THREADS = 1024, 512
# Floats of a layered thread's row of messages in shared memory: dv * dc and
# a pad of 4 (16-byte rows 144 B apart: a float4 phase of 8 threads on
# distinct banks)
_MSG_ROW = _DV * _DC + 4


class BpPlan(NamedTuple):
    """How a BP kernel lays codewords on a thread block."""
    threads: int             # threads a block
    checks_per_thread: int   # lifted checks a thread owns
    smem_bytes: int          # dynamic shared memory of a block
    codewords: int = 1       # codewords a block


def checks_per_thread(Z: int) -> int:
    """Lifted checks a thread of the flooding kernel owns at lifting size Z,
    0 where it takes no such code (csrc/bp_decode.cu:checks_per_thread):
    two where dv * Z threads would fill a block of 1,024 or exceed it (Z
    even, up to 512), else one."""
    if Z <= 0 or 2 * _FLOOD_THREADS < _DV * Z or (
            _DV * Z >= _FLOOD_THREADS and Z % 2):
        return 0
    return 2 if _DV * Z >= _FLOOD_THREADS else 1


def layered_smem_bytes(Z: int) -> int:
    """Dynamic shared memory of a block of the layered kernel at lifting
    size Z, 0 where it takes no such code
    (csrc/bp_decode_layered.cu:smem_bytes): the posteriors (dc * Z floats)
    and each thread's row of messages (Z rows of `_MSG_ROW` floats)."""
    if not 0 < Z <= _LAYERED_THREADS:
        return 0
    return 4 * (_DC + _MSG_ROW) * Z


def bp_plan(Z: int, schedule: str = "flooding") -> BpPlan:
    """The launch of a codeword of lifting size Z (n = dc * Z), as the
    kernels take it, one codeword a block; raises where their threads
    cannot hold the code. Flooding: dv * Z / `checks_per_thread(Z)`
    threads, shared memory (2 + dv) * n floats, 98 KB at Z = 512. Layered:
    Z threads, each owning check z' of all dv base rows, up to 512; shared
    memory `layered_smem_bytes(Z)`, 88 KB at Z = 512."""
    n = _DC * Z
    if schedule == "layered":
        if not layered_smem_bytes(Z):
            raise ValueError(f"the layered BP kernel takes Z <= "
                             f"{_LAYERED_THREADS} (one thread a lifted "
                             f"index); got Z={Z}")
        return BpPlan(Z, _DV, layered_smem_bytes(Z))
    cpt = checks_per_thread(Z)
    if cpt == 0:
        raise ValueError(f"the flooding BP kernel takes dv * Z <= "
                         f"{2 * _FLOOD_THREADS} checks in a block of "
                         f"{_FLOOD_THREADS} threads, two a thread from "
                         f"{_FLOOD_THREADS} on (Z even); got Z={Z}")
    return BpPlan(_DV * Z // cpt, cpt, 4 * (2 + _DV) * n)


# argument types of the two decoders' launchers (csrc/*.cu), less the stream
_DECODE_ARGS = ((ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 7
                + (ctypes.c_float, ctypes.c_float))


@functools.lru_cache(maxsize=None)
def _lib(source: str):
    """The built library, checked once against the layout rule `bp_plan`
    reports: `checks_per_thread` for the flooding kernel,
    `layered_smem_bytes` for the layered one."""
    lib = build.load(source)
    symbol, rule = {
        "bp_decode": ("bp_decode_checks_per_thread", checks_per_thread),
        "bp_decode_layered": ("bp_decode_layered_smem_bytes",
                              layered_smem_bytes)}[source]
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    bad = [Z for Z in range(-1, 2 * _FLOOD_THREADS // _DV + 2)
           if fn(Z) != rule(Z)]
    if bad:
        raise RuntimeError(f"{rule.__name__} differs from the built "
                           f"{source} at Z = {bad[:8]}")
    return lib


@functools.lru_cache(maxsize=None)
def _fn(source: str, symbol: str, argtypes: tuple):
    fn = getattr(_lib(source), symbol)
    fn.argtypes = list(argtypes)
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
            minsum_scale: float, minsum_offset: float, schedule: str,
            diag: int = 0):
    global launches, launches_layered, launches_diag
    if llr.dtype != torch.float32 or llr.dim() != 2 or llr.shape[1] != code.n:
        raise ValueError(f"llr must be float32 (B, {code.n}); got "
                         f"{tuple(llr.shape)} {llr.dtype}")
    if code.dc != _DC or code.dv != _DV:
        raise ValueError(f"the BP kernels take dc = {_DC} and dv = {_DV}; "
                         f"got dc={code.dc}, dv={code.dv}")
    plan = bp_plan(code.qc.Z, schedule)  # raises where it cannot launch
    Z = code.qc.Z
    if (diag and schedule == "flooding" and plan.checks_per_thread == 2
            and Z & (Z - 1)):
        raise ValueError(f"the attribution builds take two checks a thread "
                         f"only where Z is a power of two; got Z={Z}")
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
    args = (llr.data_ptr(), inv_perm.data_ptr(), shifts.data_ptr(), truth_ptr,
            info_cols.data_ptr(), bits_ptr, err_ptr, iters.data_ptr(),
            conv.data_ptr(), B, code.qc.Z, code.dv, code.dc, code.k, cap,
            _ALGO_ID[algo], float(minsum_scale), float(minsum_offset))
    stream = torch.cuda.current_stream(dev).cuda_stream
    name = _SOURCES[schedule]
    if diag:
        rc = _fn(name, f"{name}_diag_launch",
                 _DECODE_ARGS + (ctypes.c_int, ctypes.c_void_p))(
            *args, diag, stream)
    else:
        rc = _fn(name, f"{name}_launch", _DECODE_ARGS + (ctypes.c_void_p,))(
            *args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    if diag:
        launches_diag += 1
    elif schedule == "layered":
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


def ldpc_decode_bp_diag(code: LdpcCode, llr: torch.Tensor, cap: int,
                        algo: str, diag: int, minsum_scale: float = 0.75,
                        minsum_offset: float = 0.625,
                        schedule: str = "flooding"):
    """One of the attribution builds of the schedule's kernel (`diag` in
    DIAG_BUILDS): `cap` iterations for every codeword, results wrong by
    design, (bits (B, n) int8, stats) as ldpc_decode_bp_cuda. For a CPU
    tensor, the plain version of the same build."""
    if diag not in DIAG_BUILDS:
        raise ValueError(f"no attribution build {diag}; built: {DIAG_BUILDS}")
    _check_args(code, algo, schedule)
    if llr.device.type == "cpu":
        qc = code.qc
        decode = _decode_layered if schedule == "layered" else \
            _decode_flooding
        bits, iters, conv = decode(
            code, llr.to(torch.float32)[:, torch.as_tensor(qc.inv_perm)],
            int(cap), algo, minsum_scale, minsum_offset, diag)
        return (bits[:, torch.as_tensor(qc.perm)].to(torch.int8),
                {"iterations": iters, "converged": conv})
    if llr.device.type != "cuda":
        raise ValueError(f"unsupported device {llr.device}")
    return _launch(code, llr, None, int(cap), algo, minsum_scale,
                   minsum_offset, schedule, diag)


def layered_occupancy(Z: int, algo: str) -> tuple:
    """(registers a thread, resident blocks an SM) of the layered decode
    kernel of rule `algo` at lifting size Z, as the card reports them
    (cudaFuncGetAttributes, cudaOccupancyMaxActiveBlocksPerMultiprocessor
    at `bp_plan`'s threads and shared memory). Needs the card."""
    bp_plan(Z, "layered")
    regs, blocks = ctypes.c_int(), ctypes.c_int()
    ptr = ctypes.POINTER(ctypes.c_int)
    rc = _fn("bp_decode_layered", "bp_decode_layered_occupancy",
             (ctypes.c_int, ctypes.c_int, ptr, ptr))(
        Z, _ALGO_ID[algo], ctypes.byref(regs), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"bp_decode_layered_occupancy failed: CUDA error "
                           f"{rc}")
    return regs.value, blocks.value


def sumprod_rule(x: torch.Tensor, which: str) -> torch.Tensor:
    """The sum-product check rule's two functions on their own, elementwise
    on a float32 tensor: which="t" gives tanh(x / 2), which="r"
    log((1 + x) / (1 - x)), as the BP kernels compute them (csrc/
    bp_common.cuh, through a small kernel of csrc/bp_decode.cu); for a CPU
    tensor the plain versions decode.tanh_half and decode.log_ratio."""
    global launches_rule
    if which not in ("t", "r"):
        raise ValueError(f"which must be 't' or 'r', got {which!r}")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    if x.device.type == "cpu":
        return tanh_half(x) if which == "t" else log_ratio(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    y = torch.empty_like(x)
    rc = _fn("bp_decode", "bp_sumprod_rule_launch",
             (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p))(
        x.data_ptr(), y.data_ptr(), x.numel(), 0 if which == "t" else 1,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bp_sumprod_rule_launch failed: CUDA error {rc}")
    launches_rule += 1
    return y
