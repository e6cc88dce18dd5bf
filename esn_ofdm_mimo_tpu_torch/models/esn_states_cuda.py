"""Wrapper of the CUDA ESN state-harvest kernel (csrc/esn_states.cu), K3.

Counterpart of esn_ofdm_mimo_tpu/models/esn_pallas.py:esn_states_pallas.
For CUDA tensors it chooses a cluster plan from the batch, the operand sizes
and the card's active-cluster counts (`states_plan`), cuts the stacked
weight Wc = [Wt; W_in_t; W_fb_t] into the CTAs' column slices
(`weight_slices`), scales the inputs, and launches the whole teacher-forced
recurrence once on PyTorch's current stream. For CPU tensors it runs the
plain version, models/esn.py:esn_states. fp32 throughout.

State noise: the kernel draws it from Philox seeded with `seed`; the plain
version from a torch.Generator seeded with the same value. The streams
differ, the distribution (noise * (U(0,1) - 0.5)) is the same. As for the
predict kernels, `seed` is an int or a one-element int64 tensor on the
inputs' device, which the kernel reads from device memory
(models/esn_cuda.py:device_seed).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..utils import build
from .esn import EsnReservoir, EsnScale, esn_states, scale_inputs
from .esn_cuda import device_seed, host_generator, stacked_weights

# Launches of the kernel since the count was last reset (by the caller).
launches = 0

_N_RES_MAX = 640
CLUSTER_SIZES = (2, 4, 8, 16)
ROW_TILES = (1, 2, 4, 8, 16)  # rows a tile, as built (template RT)
SMEM_BLOCK_MAX = 232_448      # bytes of shared memory one block may take
_MAX_GROUPS = 22              # column groups of 4 a CTA: CP <= 88
_Z_REGS = 2                   # drive values a thread prefetches


class StatesPlan(NamedTuple):
    """How a state-harvest launch lays B rows on clusters of CTAs."""
    cluster: int            # CTAs a cluster (C), each on its own SM
    clusters: int           # clusters launched, all resident at once
    rows_per_cluster: int   # consecutive rows a cluster owns (the last fewer)
    cols_per_cta: int       # neuron columns a CTA owns (the last fewer)
    smem_bytes: int         # dynamic shared memory of one CTA
    row_tile: int           # rows computed together (RT); rows_per_cluster
                            # / row_tile tiles run one after another


def cols_pad(n_res: int, C: int) -> int:
    """Columns of a CTA's weight slice as stored: cols rounded up to 4, then
    to an odd number of float4s (csrc/esn_states.cu:cols_pad)."""
    cols = -(-n_res // C)
    cp = -(-cols // 4) * 4
    return cp + 4 if (cp // 4) % 2 == 0 else cp


def cta_threads(n_res: int, C: int) -> int:
    """Threads of a CTA: a warp for every two column groups of 4."""
    return 32 * -(-(cols_pad(n_res, C) // 4) // 2)


def states_smem_bytes(n_res: int, n_in: int, n_out: int, C: int,
                      row_tile: int) -> int:
    """One CTA's weight slice (K x CP) and its two X buffers (K x RT)."""
    return 4 * (n_res + n_in + n_out) * (cols_pad(n_res, C) + 2 * row_tile)


def tile_fits(n_res: int, n_in: int, n_out: int, C: int, rt: int) -> bool:
    """Whether the launcher takes a tile of rt rows at cluster size C: the
    columns a CTA owns in at most 22 groups of 4 (11 warps), its slice and
    X buffers in a block's shared memory, and the drive prefetch in
    _Z_REGS values a thread (csrc/esn_states.cu:dispatch)."""
    return (cols_pad(n_res, C) // 4 <= _MAX_GROUPS
            and states_smem_bytes(n_res, n_in, n_out, C, rt) <= SMEM_BLOCK_MAX
            and (n_in + n_out) * rt <= _Z_REGS * cta_threads(n_res, C))


def tail_tile(row_tile: int, left: int) -> int:
    """Rows of the tile that runs `left` rows (< row_tile) after a
    cluster's full tiles: the smallest built one that holds them
    (csrc/esn_states.cu:tile_rows)."""
    r = 1
    while r < left and r < row_tile:
        r *= 2
    return r


def _step_clocks(n_res: int, K: int, C: int, rt: int) -> float:
    """Clocks of one step of a tile of rt rows, fitted to H100 times of
    the kernel (tools/bench_states_torch.py): ~4,000 a step (the cluster
    barrier, the pushes, tanh, the butterfly's latency), and the
    multiply-adds of the busiest of an SM's four schedulers, one instruction
    a clock each, at 1.5 clocks an instruction (shared-memory loads)."""
    warps = cta_threads(n_res, C) // 32
    return 4000 + 1.5 * -(-warps // 4) * -(-K // 16) * 4 * rt


def states_plan(B: int, n_res: int, n_in: int, n_out: int, n_sm: int,
                max_clusters: dict | None = None) -> StatesPlan:
    """The cluster plan of a (B rows, n_res neurons) harvest. For each
    cluster size C the card takes (`max_clusters[C]` resident clusters; by
    default n_sm // C), the rows are spread over as many resident clusters
    as there are rows, a cluster takes them in tiles of at most 16 (the
    smallest built tile that holds its share and fits shared memory; the
    rows left after its full tiles in `tail_tile`), and the plan must fit a
    block's shared memory and threads. Of those, the one with the fewest
    estimated clocks (`_step_clocks` over the tiles) wins; ties go to the
    smaller cluster. Raises where no cluster size fits."""
    if max_clusters is None:
        max_clusters = {C: n_sm // C for C in CLUSTER_SIZES}
    K = n_res + n_in + n_out
    best = None
    for C in CLUSTER_SIZES:
        mc = min(int(max_clusters.get(C, 0)), n_sm // C)
        if mc <= 0 or n_res <= 0 or B <= 0:
            continue
        rows = -(-B // min(mc, B))
        want = next(r for r in ROW_TILES if r >= min(rows, ROW_TILES[-1]))
        fits = [r for r in ROW_TILES
                if r <= want and tile_fits(n_res, n_in, n_out, C, r)]
        if not fits:
            continue
        rt = fits[-1]
        smem = states_smem_bytes(n_res, n_in, n_out, C, rt)
        full, left = divmod(rows, rt)
        clocks = full * _step_clocks(n_res, K, C, rt) + (
            _step_clocks(n_res, K, C, tail_tile(rt, left)) if left else 0)
        cost = (clocks, C)
        if best is None or cost < best[0]:
            best = (cost, StatesPlan(C, -(-B // rows), rows, -(-n_res // C),
                                     smem, rt))
    if best is None:
        raise ValueError(
            f"no state-harvest cluster plan fits: n_res {n_res}, n_in {n_in},"
            f" n_out {n_out}, B {B}, resident clusters {max_clusters}")
    return best[1]


def weight_slices(res: EsnReservoir, n_in: int, n_out: int,
                  C: int) -> torch.Tensor:
    """The CTAs' slices of Wc, (C, K, CP): slice r holds columns [r * cols,
    (r + 1) * cols) of `stacked_weights`, zero padded to CP."""
    n_res = res.Wt.shape[0]
    K = n_res + n_in + n_out
    cols, cp = -(-n_res // C), cols_pad(n_res, C)
    Wc = stacked_weights(res, n_in, n_out, K, cols * C)
    return torch.nn.functional.pad(
        Wc.reshape(K, C, cols).permute(1, 0, 2),
        (0, cp - cols)).contiguous()


@functools.lru_cache(maxsize=None)
def _lib():
    """The built library, its layout checked once against `cols_pad` and
    `states_smem_bytes`, which the plan and the weight slices follow."""
    lib = build.load("esn_states")
    lib.esn_states_cols_pad.argtypes = [ctypes.c_int] * 2
    lib.esn_states_cols_pad.restype = ctypes.c_int
    lib.esn_states_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.esn_states_smem_bytes.restype = ctypes.c_longlong
    lib.esn_states_max_clusters.argtypes = [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.esn_states_max_clusters.restype = ctypes.c_int
    lib.esn_states_launch.argtypes = ([ctypes.c_void_p] * 4
                                      + [ctypes.c_int] * 9
                                      + [ctypes.c_float, ctypes.c_void_p,
                                         ctypes.c_void_p])
    lib.esn_states_launch.restype = ctypes.c_int
    bad = [(n, C) for C in CLUSTER_SIZES for n in range(1, _N_RES_MAX + 1)
           if lib.esn_states_cols_pad(n, C) != cols_pad(n, C)]
    bad += [(n, C, rt) for C in CLUSTER_SIZES for rt in ROW_TILES
            for n in (1, 300, 600, _N_RES_MAX)
            if lib.esn_states_smem_bytes(n, 16, 8, C, rt)
            != states_smem_bytes(n, 16, 8, C, rt)]
    if bad:
        raise RuntimeError(f"the wrapper's layout of the state-harvest "
                           f"kernel's slices or shared memory differs from "
                           f"the built library's at {bad[:4]}")
    return lib


@functools.lru_cache(maxsize=None)
def max_clusters_on(device_index: int, n_res: int, n_in: int,
                    n_out: int) -> dict:
    """{C: clusters of C CTAs the card holds at once} for this shape:
    cudaOccupancyMaxActiveClusters at the smallest row tile, counted with no
    less than half an SM's shared memory so that a CTA has its SM to itself
    as the plan assumes; 0 where the launcher or the card takes no such
    cluster."""
    lib, out = _lib(), {}
    with torch.cuda.device(device_index):
        for C in CLUSTER_SIZES:
            n = ctypes.c_int(0)
            rc = lib.esn_states_max_clusters(n_res, n_in, n_out, C,
                                             ROW_TILES[0], ctypes.byref(n))
            out[C] = n.value if rc == 0 else 0
    return out


def device_plan(B: int, n_res: int, n_in: int, n_out: int,
                device: torch.device) -> StatesPlan:
    """`states_plan` on this card: its SM count and active-cluster counts."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    n_sm = torch.cuda.get_device_properties(idx).multi_processor_count
    return states_plan(B, n_res, n_in, n_out, n_sm,
                       max_clusters_on(idx, n_res, n_in, n_out))


def esn_states_cuda(res: EsnReservoir, scale: EsnScale, inputs: torch.Tensor,
                    teachers_scaled: torch.Tensor,
                    seed=0) -> torch.Tensor:
    """Drop-in for models/esn.esn_states: inputs (B, T, n_in) raw,
    teachers_scaled (B, T, n_out) -> states (B, T, n_res), states[:, 0] = 0.
    `seed`: an int, or a one-element int64 tensor on the inputs' device.
    """
    if inputs.device.type == "cpu":
        return esn_states(res, scale, inputs, teachers_scaled,
                          host_generator(seed))
    return _launch(res, scale, inputs, teachers_scaled, seed, None)


def _launch(res: EsnReservoir, scale: EsnScale, inputs: torch.Tensor,
            teachers_scaled: torch.Tensor, seed,
            plan: StatesPlan | None) -> torch.Tensor:
    """The kernel under `plan`, by default `device_plan`'s
    (tools/bench_states_torch.py times the others)."""
    global launches
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
    if plan is None:
        plan = device_plan(B, n_res, n_in, n_out, inputs.device)
    wsl = weight_slices(res, n_in, n_out, plan.cluster)
    u = scale_inputs(scale, inputs).contiguous()
    d = teachers_scaled.contiguous()
    out = torch.empty(B, T, n_res, dtype=torch.float32, device=inputs.device)
    seed_d = device_seed(seed, inputs.device)
    rc = _lib().esn_states_launch(
        u.data_ptr(), d.data_ptr(), wsl.data_ptr(), out.data_ptr(), B, T,
        n_res, n_in, n_out, plan.cluster, plan.clusters,
        plan.rows_per_cluster, plan.row_tile, float(res.noise),
        seed_d.data_ptr(),
        torch.cuda.current_stream(inputs.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"esn_states_launch failed at {plan}: CUDA error "
                           f"{rc}")
    launches += 1
    return out
