#!/usr/bin/env python3
"""Times of the small-SVD kernel (csrc/svdvals_small.cu behind
ops/analytics.py:svdvals_small) on one full-width NBF round's channels, and
what its build compiled to.

    python3 tools/bench_svd_torch.py [--reps N]

For the channels of 128 blocks at 12 dB of mimo_4x8_nbf, mimo_2x2_nbf and
simo_1x2_nbf (65,536 matrices of 8 x 4, 2 x 2 and 2 x 1; chip_smoke.py's
`[svd]` draws the same) it checks the kernel against the plain version
(identical) and prints the kernel's ms (CUDA events around a CUDA graph
of N wrapper calls, and N calls from Python) and the plain version's; at
8 x 4 also the kernel's ms at 0, 1, 2, 4 and 8 sweeps (the C entry's
`sweeps`, on a contiguous H), which splits the staging, Gram and store
from the rotations, and early sweeps from late ones. Then, from the built
library with the toolkit's `cuobjdump`, each of those builds' registers,
shared and local memory (a spill shows as local memory), the SASS
instructions of its sweep loop, a rotation's share of them and their
issue floor. Exit 1 on a difference or a spill. Needs a GPU and nvcc.
chip_smoke.py's `[svd]` imports `svd_work` (the bound), `graph_ms` and
the build report from here.

It times the package of the tree it sits in: a copy of it in another
checkout times that tree's kernel (the same C entry), so two trees are
compared in one call (A, B, B, A).
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

# (preset, label) of the NBF shapes the kernel is built for and runs at
SHAPES = (("mimo_4x8_nbf", "8x4"), ("mimo_2x2_nbf", "2x2"),
          ("simo_1x2_nbf", "2x1"))


def svd_work(H, real_embedding: bool = False) -> tuple:
    """(bytes, fp32 operations, divisions and square roots) the small SVD of
    H (..., n_r, n_t) needs on these inputs: H read once, S written once.
    The Hermitian form (the default): the Gram's upper triangle, 3
    operations a row and diagonal entry, 6 a row and complex off-diagonal
    one, plus the fold's additions; 3 for each pair's test |a_pq|^2 > 0;
    for each rotation that runs on this data (t != 0; the plain version
    counts them) 11 more for its angle, 3 for the diagonal and 24 for each
    of the n_t - 2 other indices, and 5 divisions and 3 square roots.
    `real_embedding`: the count of the algorithm on the 2 n_t x 2 n_t real
    embedding, the kernel's earlier form (the symmetric Gram's distinct
    entries, every rotation of every sweep with its two rows outside its
    (p, q) block once, 5 divisions and square roots a rotation)."""
    from esn_ofdm_mimo_tpu_torch.ops import analytics
    n_r, n_t = H.shape[-2:]
    b = H.numel() // (n_r * n_t)
    n_bytes = 8 * H.numel() + 4 * b * n_t
    if real_embedding:
        n = 2 * n_t
        rot = analytics.SWEEPS * n * (n - 1) // 2
        return (n_bytes, b * (2 * n_r * n * (n + 1) + rot * (6 * n + 24)),
                5 * b * rot)
    gram = 3 * n_r * n_t * n_t + (n_r - 1) * n_t * n_t
    tests = analytics.SWEEPS * n_t * (n_t - 1) // 2
    ran = int(analytics._hermitian_jacobi(H)[1].sum())
    return (n_bytes, b * (gram + 3 * tests) + ran * (11 + 24 * (n_t - 2)),
            8 * ran)


def round_channels(preset: str, dev, blocks: int = 128):
    """H_true of `blocks` blocks of `preset` at 12 dB (synth_block's channel
    draw at keys block_keys(prng_key(0), snr index, 0..blocks-1))."""
    import torch

    from esn_ofdm_mimo_tpu_torch.experiments import presets
    from esn_ofdm_mimo_tpu_torch.ops import taps_to_freq_response
    from esn_ofdm_mimo_tpu_torch.pipelines.common import _K_CHAN, _draw_taps
    from esn_ofdm_mimo_tpu_torch.utils import rng
    c = getattr(presets, preset)()
    keys = rng.block_keys(rng.prng_key(0), c.ebno_db.index(12.0),
                          torch.arange(blocks)).to(dev)
    taps = _draw_taps(c, rng.fold_in(keys, _K_CHAN))
    return taps_to_freq_response(taps, c.ofdm.n_subcarriers)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of fn over `reps` calls launched from Python after one
    warm-up call (CUDA events): a launch's host time shows where it is
    longer than the kernel."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean ms of fn over `reps` calls captured into one CUDA graph and
    replayed (CUDA events around a replay, after a warm-up one): the
    kernels back to back, without the host's launch time."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    g.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def build_report() -> dict:
    """{(n_r, n_t): {"registers", "shared", "local", "stack", "loop"}} of
    every build in the SVD library: resources from `cuobjdump -res-usage`,
    `loop` the SASS instructions of the kernel's longest backward branch
    (the sweep loop) from `cuobjdump -sass`. Builds with n_t alone in their
    name (a tree before the Hermitian form) are keyed (0, n_t)."""
    from esn_ofdm_mimo_tpu_torch.utils import build
    build.load("svdvals_small")
    lib = str(build.lib_path("svdvals_small"))
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")

    def dump(flag):
        return subprocess.run([tool, flag, lib], capture_output=True,
                              text=True, check=True).stdout

    def key(name):
        m = re.search(r"svdvals_small_kernelILi(\d+)E(?:Li(\d+)E)?", name)
        if m is None:
            return None
        return ((int(m.group(1)), int(m.group(2))) if m.group(2)
                else (0, int(m.group(1))))
    out, k = {}, None
    for line in dump("-res-usage").splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            k = key(m.group(1))
            continue
        m = re.search(r"REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)", line)
        if m and k is not None:
            out[k] = dict(zip(("registers", "stack", "shared", "local"),
                              map(int, m.groups())), loop=0)
    k, branches = None, []

    def close():
        if k in out:
            out[k]["loop"] = max((a - t for a, t in branches if t < a),
                                 default=-16) // 16 + 1
    for line in dump("-sass").splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            close()
            k, branches = key(m.group(1)), []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*)", line)
        if m and k is not None:
            b = re.search(r"\bBRA(?:\.\S+)?\s+(?:\S+,\s*)?(0x[0-9a-f]+)",
                          m.group(2))
            if b:
                branches.append((int(m.group(1), 16), int(b.group(1), 16)))
    close()
    return out


def build_line(r: dict, n_r: int, n_t: int, H) -> str:
    """One build's line of `build_report` at the launch on H: with its
    sweep loop's SASS instructions a rotation, their issue floor over the
    SWEEPS sweeps at one thread a matrix of H and 128 thread slots a clock
    on every SM at the card's top clock."""
    import torch
    from bench_bp_torch import sm_clock_hz

    from esn_ofdm_mimo_tpu_torch.ops import analytics
    line = (f"{r['registers']} registers, shared {r['shared']} B, local "
            f"{r['local']} B, stack {r['stack']} B")
    rot = n_t * (n_t - 1) // 2 if n_r else n_t * (2 * n_t - 1)
    if rot == 0:
        return line + " | no rotation"
    b = H.numel() // (H.shape[-2] * H.shape[-1])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    floor = (1e3 * b * r["loop"] * analytics.SWEEPS
             / (128 * n_sm * sm_clock_hz()))
    return (line + f" | sweep loop {r['loop']} SASS instructions, "
            f"{r['loop'] / rot:.1f} a rotation, issue floor {floor:.4f} ms "
            f"at {tuple(H.shape)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bench_svd_torch: needs a GPU", file=sys.stderr)
        return 1
    from esn_ofdm_mimo_tpu_torch.ops import analytics
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)

    ok = True
    shapes = {}
    for preset, what in SHAPES:
        H = round_channels(preset, dev)
        S_k = analytics.svdvals_small(H)
        S_p = analytics.svdvals_small_plain(H)
        torch.cuda.synchronize()
        same = torch.equal(S_k, S_p)
        ok &= same
        ms = graph_ms(lambda: analytics.svdvals_small(H), args.reps)
        eager_ms = cuda_ms(lambda: analytics.svdvals_small(H), args.reps)
        plain_ms = cuda_ms(lambda: analytics.svdvals_small_plain(H), 2)
        shapes[tuple(H.shape[-2:])] = H
        print(f"[svd {what}] {tuple(H.shape)}: identical to plain {same} | "
              f"kernel {ms:.4f} ms (a graph of {args.reps} launches; from "
              f"Python {eager_ms:.4f} ms), plain {plain_ms:.3f} ms",
              flush=True)
    H = shapes[8, 4]
    lib, b = analytics._lib(), H.numel() // 32
    Hc = torch.view_as_real(H.contiguous())
    S = torch.empty(b, 4, device=dev)
    by_sweeps = {n: graph_ms(lambda: lib.svdvals_small_launch(
        Hc.data_ptr(), S.data_ptr(), b, 8, 4, n,
        torch.cuda.current_stream().cuda_stream), args.reps)
        for n in (0, 1, 2, 4, 8)}
    print("[svd 8x4 by sweeps] ms at " + ", ".join(
        f"{n}: {v:.4f}" for n, v in by_sweeps.items()), flush=True)
    for (n_r, n_t), r in sorted(build_report().items()):
        H = shapes.get((n_r, n_t))
        if n_r == 0:                         # one build an n_t: 8 x n_t
            H = shapes.get((8, n_t), shapes.get((2, n_t)))
        if H is None:
            continue
        ok &= r["local"] == 0
        print(f"[svd build {n_r}x{n_t}] {build_line(r, n_r, n_t, H)}",
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
