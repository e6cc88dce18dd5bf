"""Wrapper of the CUDA ESN predict kernels: K2 (csrc/esn_predict.cu, per-row
readout from L2), K4 (csrc/esn_predict_grouped.cu, the tile's readout
slots staged in shared memory) and K5 (csrc/esn_predict_ablate.cu, builds of
K2 with parts of the step switched off, for the micro-benchmark
tools/bench_micro_torch.py; `esn_predict_ablate_cuda`).

Counterpart of esn_ofdm_mimo_tpu/models/esn_pallas.py:esn_predict_pallas;
`readout="grouped"` is its ESN_TPU_PREDICT_READOUT=grouped kernel. For CUDA
tensors it chooses the row tiling from the batch, the operand sizes and the
card's SM count (`predict_tiling`: every SM the same rows, all blocks
resident at once), lays the operands out for the kernel — the stacked weight
Wc = [Wt; W_in_t; W_fb_t] zero-padded to (K_pad, n_p) with the input rows on
a chunk boundary, the scaled inputs time-major (T, n_in, B), the grouped
readout (G, F, n_out) as is — and launches the whole T-step recurrence once
on PyTorch's current stream. For
CPU tensors it runs the plain version, models/esn.py:esn_predict, for either
readout. The kernels work in fp32 throughout, like the plain version.

State noise: the kernel draws it from Philox seeded with `seed`; the plain
version from a torch.Generator seeded with the same value. The streams
differ, the distribution (noise * (U(0,1) - 0.5)) is the same. A launch
takes the seed in device memory (copied on its stream into the library's
constant slot, csrc/esn_predict_core.cuh:c_seed): `seed` is an int or a
one-element int64 tensor on the inputs' device holding its 64 bits
(models/esn.py:key_seed_tensor), so a caller can seed a launch without
leaving the card, as a captured CUDA graph must
(pipelines/cdl.py:run_cdl_cal_counters_chunks).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..utils import build
from .esn import (ABLATE_PARTS, EsnReservoir, EsnScale, broadcast_carry,
                  esn_predict, esn_predict_ablate, scale_inputs)

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


# The kernel's shared-memory layout (csrc/esn_predict_core.cuh): weight chunks
# of _KC rows in a ring of _STAGES, 8 readout columns of partial sums a warp,
# 8 floats between staged readout slots.
_KC, _STAGES, _SLOT_PAD = 8, 4, 8
SMEM_BLOCK_MAX = 232_448      # bytes of shared memory one block may take
_SMEM_SM = 233_472            # an SM's shared memory, of which each resident
_SMEM_BLOCK_RESERVED = 1_024  # block costs this much beyond what it asks for


def tile_heights(n_res: int, readout: str = "per_row") -> tuple:
    """Tile heights (rows of the register tile) built for this reservoir
    width: 20 and 72 rows up to n_res = 320, 20 above (a 72-row state of a
    wider reservoir leaves the weight ring no room); the ablation builds
    (K5) have the 72-row tile only."""
    if readout == "ablate":
        return (72,)
    return (20, 72) if n_res <= 320 else (20,)


def block_threads(n_res: int, height: int) -> int:
    """Threads of a block of this tile (esn_predict_core.cuh:threads_of): 128
    where 256 would leave a thread at most 64 accumulators, else 256."""
    return 128 if height * -(-n_res // 64) // 4 <= 64 else 256


class Tiling(NamedTuple):
    """How a predict launch cuts B rows into blocks."""
    rows_per_block: int    # consecutive rows a block owns (the last may own fewer)
    blocks: int
    smem_bytes: int        # dynamic shared memory of one block
    blocks_per_sm: int     # resident blocks an SM the plan counts on
    height: int            # compiled tile height, >= rows_per_block
    waves: int             # 1: all blocks resident at once


def grouped_slots(G: int, Dg: int, rows_per_block: int = 64) -> int:
    """Readouts a block of `rows_per_block` consecutive rows over runs of Dg
    rows can touch: the JAX package's P = min(G, BC // Dg + 2) at the rows a
    block owns in this launch (`predict_tiling`)."""
    return min(G, rows_per_block // Dg + 2)


def predict_smem_bytes(n_res: int, n_in: int, n_out: int, height: int,
                       slots: int = 0) -> int:
    """Dynamic shared memory of one block (esn_predict_core.cuh:smem_bytes):
    the state and both [u; o] buffers at `height` rows, the weight ring, the
    readout's partial sums and, for K4, `slots` staged readouts."""
    n_p = -(-n_res // 64) * 64
    k_rows = -(-n_res // _KC) * _KC + 2 * (-(-(n_in + n_out) // _KC) * _KC)
    warps = block_threads(n_res, height) // 32
    floats = (k_rows * height + _STAGES * _KC * n_p + warps * 8 * height
              + slots * ((n_res + n_in) * n_out + _SLOT_PAD))
    return 4 * floats


def predict_tiling(B: int, n_res: int, n_in: int, n_out: int, n_sm: int,
                   Dg: int | None = None,
                   heights: tuple | None = None) -> Tiling:
    """Rows a block owns, from the batch, the operand sizes and the card's SM
    count. With `Dg` the plan is K4's: each block also stages its
    rows_per_block // Dg + 2 readout slots (capped at B // Dg).

    Every SM gets the same number of blocks (1 or 2 resident, by shared
    memory and by the registers: two only of the 128-thread tiles) and every block the same rows, B / (n_sm x blocks an SM)
    rounded up, in the smallest built tile height that holds them. Of the
    plans that fit, those with all blocks resident at once (one wave) come
    first, then the one whose SMs compute the fewest tile rows (padding rows
    cost what real rows cost); ties go to one block an SM, then the lower
    tile. Where B is too large for one resident wave, the SMs take `waves`
    equal rounds of blocks."""
    heights = tile_heights(n_res) if heights is None else heights
    best = None
    for height in heights:
        for bps in (1, 2):
            if bps == 2 and block_threads(n_res, height) != 128:
                continue
            waves = -(-B // (n_sm * bps * height))
            rows = max(1, -(-B // (n_sm * bps * waves)))
            slots = 0 if Dg is None else grouped_slots(B // Dg, Dg, rows)
            smem = predict_smem_bytes(n_res, n_in, n_out, height, slots)
            if (smem > SMEM_BLOCK_MAX
                    or bps * (smem + _SMEM_BLOCK_RESERVED) > _SMEM_SM):
                continue
            cost = (waves, waves * bps * height, bps, height)
            if best is None or cost < best[0]:
                best = (cost, Tiling(rows, -(-B // rows), smem, bps, height,
                                     waves))
    if best is None:
        raise ValueError(f"no predict tile fits shared memory: n_res {n_res},"
                         f" n_in {n_in}, n_out {n_out}, heights {heights}")
    return best[1]


def grouped_viable(G: int, Dg: int, rows_per_block: int = 64) -> bool:
    """The JAX package's condition for its grouped kernel: Dg > 1, P <= 4,
    at the rows a block owns."""
    return Dg > 1 and grouped_slots(G, Dg, rows_per_block) <= 4


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def device_seed(seed, device: torch.device) -> torch.Tensor:
    """The noise seed as the kernels read it: one int64 on `device` holding
    the seed's 64 bits. A tensor (`key_seed_tensor`'s, or an element of it)
    passes as it is; an int is written there by a fill kernel, not copied
    from the host."""
    if isinstance(seed, torch.Tensor):
        if (seed.dtype != torch.int64 or seed.numel() != 1
                or seed.device != device):
            raise ValueError(f"a seed tensor must hold one int64 on {device}; "
                             f"got {seed.dtype} {tuple(seed.shape)} on "
                             f"{seed.device}")
        return seed
    v = int(seed) & (2**64 - 1)
    return torch.full((1,), v - 2**64 if v >= 2**63 else v,
                      dtype=torch.int64, device=device)


def host_generator(seed) -> torch.Generator:
    """The plain versions' noise stream: a CPU torch.Generator seeded with
    the seed's 64 bits (an int, or a one-element int64 tensor)."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed) & (2**64 - 1))
    return gen


def grouped_plan(B: int, G: int, n_res: int, n_in: int, n_out: int,
                 n_sm: int) -> Tiling | None:
    """K4's tiling of a (B rows, G readouts) call, or None where the grouped
    kernel does not apply (Dg == 1, more than 4 slots a block, or no tile
    with its slots fits shared memory)."""
    Dg = B // G
    if Dg <= 1 or B % G:
        return None
    try:
        plan = predict_tiling(B, n_res, n_in, n_out, n_sm, Dg=Dg)
    except ValueError:
        return None
    return plan if grouped_viable(G, Dg, plan.rows_per_block) else None


@functools.lru_cache(maxsize=None)
def _lib(readout: str):
    """(k_pad, smem_bytes, launch) of K2 (readout "per_row"), K4 ("grouped")
    or K5 ("ablate", whose launch takes no carry pointers and takes the mask
    of switched-off parts after the tile height)."""
    name = _SOURCES[readout]
    lib = build.load(name)
    k_pad, smem, launch = (getattr(lib, f"{name}_{fn}")
                           for fn in ("k_pad", "smem_bytes", "launch"))
    k_pad.argtypes = [ctypes.c_int] * 3
    smem.argtypes = [ctypes.c_int] * 5
    launch.argtypes = ([ctypes.c_void_p] * (4 if readout == "ablate" else 6)
                       + [ctypes.c_int] * (10 if readout == "ablate" else 9)
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                          ctypes.c_void_p])
    k_pad.restype = launch.restype = ctypes.c_int
    smem.restype = ctypes.c_longlong
    return k_pad, smem, launch


def stacked_weights(res: EsnReservoir, n_in: int, n_out: int, K_pad: int,
                    n_p: int | None = None) -> torch.Tensor:
    """Wc (K_pad, n_p): rows [Wt; W_in_t; W_fb_t], columns = neurons, zero
    padded (n_p defaults to n_res rounded up to 64). The state-harvest
    kernel's layout; the predict kernels take `predict_weights`."""
    n_res = res.Wt.shape[0]
    n_p = -(-n_res // 64) * 64 if n_p is None else n_p
    Wc = torch.zeros(K_pad, n_p, dtype=torch.float32, device=res.Wt.device)
    Wc[:n_res, :n_res] = res.Wt
    Wc[n_res:n_res + n_in, :n_res] = res.W_in_t
    Wc[n_res + n_in:n_res + n_in + n_out, :n_res] = res.W_fb_t
    return Wc


def predict_weights(res: EsnReservoir, n_in: int, n_out: int) -> torch.Tensor:
    """The predict kernels' Wc (K_pad, n_p): rows [Wt; 0; W_in_t; W_fb_t; 0]
    with the input rows starting at n_res rounded up to the chunk of 8, so
    that no chunk straddles the state and the [u; o] rows; columns = neurons,
    zero padded to a multiple of 64."""
    n_res = res.Wt.shape[0]
    n_res8 = -(-n_res // _KC) * _KC
    K_pad = n_res8 + -(-(n_in + n_out) // _KC) * _KC
    Wc = torch.zeros(K_pad, -(-n_res // 64) * 64, dtype=torch.float32,
                     device=res.Wt.device)
    Wc[:n_res, :n_res] = res.Wt
    Wc[n_res8:n_res8 + n_in, :n_res] = res.W_in_t
    Wc[n_res8 + n_in:n_res8 + n_in + n_out, :n_res] = res.W_fb_t
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


def choose_readout(B: int, G: int, n_res: int, n_in: int, n_out: int,
                   device: torch.device) -> str:
    """"grouped" where the grouped-readout kernel applies to a call of B rows
    and G readouts on `device` (at the tiling this card gives the call), else
    "per_row". On the CPU either name runs the plain version."""
    if device.type != "cuda":
        return "grouped" if B % G == 0 and grouped_viable(G, B // G) \
            else "per_row"
    plan = grouped_plan(B, G, n_res, n_in, n_out, _sm_count(device))
    return "per_row" if plan is None else "grouped"


def _launch(readout: str, plan: Tiling, res: EsnReservoir, scale: EsnScale,
            Wt_out: torch.Tensor, inputs: torch.Tensor, n_forget: int,
            seed, slots: int = 0, extra: tuple = (),
            init_carry=None) -> torch.Tensor:
    """Lay the operands out and launch one predict kernel on PyTorch's
    current stream; raises where the launcher refuses or the launch fails.
    K2 and K4 take the carry's two device pointers (null for a zero carry),
    K5 none."""
    B, T, n_in = inputs.shape
    n_res, (G, _, n_out) = res.Wt.shape[0], Wt_out.shape
    k_pad, smem, launch = _lib(readout)
    Wc = predict_weights(res, n_in, n_out)
    if (Wc.shape[0] != k_pad(n_res, n_in, n_out) or plan.smem_bytes
            != smem(n_res, n_in, n_out, plan.height, slots)):
        raise RuntimeError("the wrapper's layout of the predict kernel's "
                           "operands or shared memory differs from the "
                           "built library's")
    u_fm = scale_inputs(scale, inputs).permute(1, 2, 0).contiguous()
    wout = Wt_out.contiguous()
    out = torch.empty(B, T - n_forget, n_out, dtype=torch.float32,
                      device=inputs.device)
    # `carry` keeps the carried rows alive until the launch is queued
    carry = (None if init_carry is None
             else broadcast_carry(init_carry, B, n_res, n_out, inputs))
    ptrs = () if readout == "ablate" else (None, None) if carry is None \
        else tuple(c.data_ptr() for c in carry)
    seed_d = device_seed(seed, inputs.device)
    rc = launch(
        u_fm.data_ptr(), Wc.data_ptr(), wout.data_ptr(), out.data_ptr(),
        *ptrs, B, T, n_res, n_in, n_out, B // G, n_forget,
        plan.rows_per_block, plan.height, *extra, float(res.noise),
        float(scale.teacher_scaling), seed_d.data_ptr(),
        torch.cuda.current_stream(inputs.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ESN predict ({readout}{list(extra)}) launch "
                           f"failed at {plan}: CUDA error {rc}")
    return out


def esn_predict_cuda(res: EsnReservoir, scale: EsnScale,
                     Wt_out: torch.Tensor, inputs: torch.Tensor,
                     n_forget: int, seed=0,
                     readout: str = "per_row",
                     tiling: Tiling | None = None,
                     init_carry=None) -> torch.Tensor:
    """Drop-in for models/esn.esn_predict: inputs (B, T, n_in) raw,
    Wt_out (G, n_res + n_in, n_out) grouped (B % G == 0) -> (B, T -
    n_forget, n_out) unscaled outputs. readout="grouped" launches K4 and
    needs `grouped_plan` to give a tiling. `tiling` replaces the one
    `predict_tiling` chooses for this card (for measurements of a tile
    height; the launcher refuses a height it has no build for).
    init_carry (s0, o0), rows (n_res,) / (n_out,) or (1, ·) broadcast or
    (B, ·), starts each row there (`esn_fit(..., return_carry=True)`);
    None from zeros.

    The launch copies the seed into its library's one `__constant__` slot
    on the current stream (csrc/esn_predict_core.cuh:c_seed). So launches
    of one library (K2's, K4's or K5's) must not run on two streams at
    once: a kernel could read the other launch's seed. The port launches
    them on one stream at a time."""
    global launches, launches_grouped
    if readout not in ("per_row", "grouped"):
        raise ValueError(f"unknown readout {readout!r}")
    if inputs.device.type == "cpu":
        return esn_predict(res, scale, Wt_out, inputs, n_forget,
                           host_generator(seed), init_carry=init_carry)
    if inputs.device.type != "cuda":
        raise ValueError(f"unsupported device {inputs.device}")
    B, T, n_in, n_res, G, n_out = _check_operands(res, Wt_out, inputs,
                                                  n_forget)
    n_sm, slots = _sm_count(inputs.device), 0
    if readout == "grouped":
        plan = grouped_plan(B, G, n_res, n_in, n_out, n_sm) \
            if tiling is None else tiling
        if plan is None or not grouped_viable(G, B // G, plan.rows_per_block):
            raise ValueError(
                f"the grouped readout kernel needs Dg > 1 and at most 4 "
                f"readout slots a block; got Dg={B // G}, G={G}, B={B}")
        slots = grouped_slots(G, B // G, plan.rows_per_block)
    else:
        plan = predict_tiling(B, n_res, n_in, n_out, n_sm) \
            if tiling is None else tiling
    out = _launch(readout, plan, res, scale, Wt_out, inputs, n_forget, seed,
                  slots, init_carry=init_carry)
    if readout == "grouped":
        launches_grouped += 1
    else:
        launches += 1
    return out


def esn_predict_ablate_cuda(res: EsnReservoir, scale: EsnScale,
                            Wt_out: torch.Tensor, inputs: torch.Tensor,
                            n_forget: int, seed=0, *,
                            readout: bool = True, feedback: bool = True,
                            noise: bool = True, tanh: bool = True,
                            recurrence_dot: bool = True) -> torch.Tensor:
    """models/esn.esn_predict_ablate on the card (K5): the predict
    recurrence with the named parts switched off at compile time. Operands
    as `esn_predict_cuda`; the micro-benchmark passes one readout per row
    (G == B). Built for the sets in ABLATE_BUILDS (all on, one part off,
    all off), ceil(n_res / 64) == 5 and the 72-row tile."""
    global launches_ablate
    on = dict(readout=readout, feedback=feedback, noise=noise, tanh=tanh,
              recurrence_dot=recurrence_dot)
    if inputs.device.type == "cpu":
        return esn_predict_ablate(res, scale, Wt_out, inputs, n_forget,
                                  host_generator(seed), **on)
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
    # a dropped term's weight rows are zeroed: the kernel skips whole chunks
    # of them and a chunk that straddles the term adds nothing
    zero = torch.zeros_like
    res_k = res._replace(
        Wt=res.Wt if recurrence_dot else zero(res.Wt),
        W_fb_t=res.W_fb_t if feedback else zero(res.W_fb_t))
    plan = predict_tiling(B, n_res, n_in, n_out, _sm_count(inputs.device),
                          heights=tile_heights(n_res, "ablate"))
    out = _launch("ablate", plan, res_k, scale, Wt_out, inputs, n_forget,
                  seed, extra=(sum(_OFF_BIT[p] for p in off),))
    launches_ablate += 1
    return out
