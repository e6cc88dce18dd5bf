"""Scaling measurement: blocks/s of one block-fading SNR point over the
first 1, 2, 4 ... ranks (port of esn_ofdm_mimo_tpu/experiments/scaling.py).

    python -m esn_ofdm_mimo_tpu_torch.experiments.scaling \\
        [--preset mimo_2x2_nbf] [--out scaling.json] [--device cuda]
    torchrun --nproc_per_node=4 -m esn_ofdm_mimo_tpu_torch.experiments.scaling

Each layout of n ranks (`parallel/mesh.py:trials_mesh(n)`) runs the fused
`make_sharded_nbf_step` over its ranks (as the JAX CLI runs its sharded
step; on the card each rank replays its CUDA graph of the round, the
counters summed on the card) on rounds of 2 blocks a rank: one warm-up
round, which captures the graph, then 3 timed ones, each on fresh keys;
the ranks beyond n wait. Rank 0 prints
blocks/s, seconds a round and the efficiency against the one-rank layout,
and writes them to --out as JSON. The preset is always cut to its --fast
size, as the JAX CLI's is.

Without a process group (no torchrun variables) the run is one rank, and
one H100 gives one rank: no scaling efficiency can be claimed from it. On
the CPU (--device cpu, gloo) the ranks share the host's cores, so the
numbers check the path, not the scaling.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist

from ..parallel.mesh import device_count, maybe_init_distributed, trials_mesh
from ..parallel.montecarlo import make_sharded_nbf_step
from ..utils import rng
from ..utils.device import resolve_device


def measure_scaling(cfg, device_counts=None, blocks_per_device: int = 2,
                    iters: int = 3, ebno_db: float = 12.0,
                    device=None) -> dict:
    """{n: {"blocks_per_s", "seconds_per_round", "efficiency"}} for each n
    of `device_counts` (default the powers of two up to the world's
    ranks); every rank returns the same dict."""
    dev = resolve_device(device)
    n_avail = device_count()
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_avail]
    root = rng.prng_key(0)
    out = {}
    for nd in device_counts:
        mesh = trials_mesh(nd)
        G = nd * blocks_per_device

        def round_keys(i):
            return rng.block_keys(root, i, torch.arange(G))

        if mesh.member:
            step = make_sharded_nbf_step(cfg, dev, mesh)
            step(ebno_db, round_keys(0))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for i in range(iters):
                step(ebno_db, round_keys(i + 1))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = (time.perf_counter() - t0) / iters
            out[nd] = {"blocks_per_s": G / dt, "seconds_per_round": dt}
        if dist.is_initialized():
            # every rank takes rank 0's numbers
            box = [out.get(nd)]
            dist.broadcast_object_list(box, src=0)
            out[nd] = box[0]
            dist.barrier()
        if not dist.is_initialized() or dist.get_rank() == 0:
            print(f"[scaling] {nd} rank{'s' if nd > 1 else ''}: "
                  f"{out[nd]['blocks_per_s']:.2f} blocks/s", flush=True)
    base = out[device_counts[0]]["blocks_per_s"] / device_counts[0]
    for nd in device_counts:
        out[nd]["efficiency"] = out[nd]["blocks_per_s"] / (nd * base)
    return out


def main(argv=None):
    from .presets import get_preset
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", default="mimo_2x2_nbf")
    ap.add_argument("--fast", action="store_true", default=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu (the "
                         "kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)
    started = not dist.is_initialized() and maybe_init_distributed(
        args.device)
    try:
        cfg = get_preset(args.preset, fast=True)
        res = measure_scaling(cfg, device=args.device)
        if not dist.is_initialized() or dist.get_rank() == 0:
            print(json.dumps(res, indent=1))
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(res, f, indent=1)
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
