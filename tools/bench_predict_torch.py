#!/usr/bin/env python3
"""Times of the CUDA predict kernels (K2, K4) under every tiling that fits,
and the compiler's resource use of every predict build.

    python3 tools/bench_predict_torch.py [--ptxas] [--reps N]

For the two full-width detect shapes (mimo_4x8_cdl: 9,472 rows, T = 138,
n_res = 300; mimo_4x8_nbf: 2,304 rows, T = 522, n_res = 600) it launches K2
and K4 with the tiling `models/esn_cuda.py:predict_tiling` chooses and with
each other plan (tile height x blocks an SM, in as many waves as the batch
needs) the launcher has a build for, checks every output against the plain version (atol 1e-4, rtol
1e-3: the sums are taken in another order) and prints ms per launch from
CUDA events, in turns within one process. It is how a tile height is held
against the chosen one on the card. Then K2's TF32 build (route "tf32",
precision None) at its chosen tiling, against the plain TF32 form (atol
5e-4, rtol 1e-3), in turns with the fp32 build.

--ptxas first compiles the three predict sources with `-Xptxas -v` and
prints registers and spill bytes of every kernel in them (template
arguments: reservoir width / 64, tile height, grouped readout, ablation
mask, TF32 product); it exits 1 if a build spills. Needs a GPU and nvcc.
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def ptxas_report() -> bool:
    """Print registers and spills per kernel; True if none spills."""
    from esn_ofdm_mimo_tpu_torch.utils import build
    clean = True
    with tempfile.TemporaryDirectory() as tmp:
        procs = {n: subprocess.Popen(
            build._nvcc_cmd(n, os.path.join(tmp, f"{n}.so"))
            + ["-Xptxas", "-v"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for n in ("esn_predict", "esn_predict_grouped",
                      "esn_predict_ablate")}
        for name, p in procs.items():
            log, _ = p.communicate()
            if p.returncode:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
            entry, spill = "?", ("?", "?")
            for line in log.splitlines():
                m = re.search(r"ILi(\d+)ELi(\d+)ELb([01])ELi(\d+)ELb([01])",
                              line)
                if m and "entry function" in line:
                    entry = "<%s, %s, %s, %s, %s>" % m.groups()
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
                if m:
                    spill = m.groups()
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    print(f"[ptxas {name}] {entry}: {m.group(1)} registers, "
                          f"spill stores/loads {spill[0]}/{spill[1]} B")
                    clean &= spill == ("0", "0")
    return clean


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_predict_torch: needs a GPU", file=sys.stderr)
        return 1
    from esn_ofdm_mimo_tpu_torch.experiments.presets import (mimo_4x8_cdl,
                                                             mimo_4x8_nbf)
    from esn_ofdm_mimo_tpu_torch.models import esn_cuda
    from esn_ofdm_mimo_tpu_torch.models.esn import (EsnScale, esn_predict,
                                                    init_reservoir)
    from esn_ofdm_mimo_tpu_torch.utils import rng

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    if args.ptxas and not ptxas_report():
        print("bench_predict_torch: a predict build spills", file=sys.stderr)
        return 1

    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    scale = EsnScale(input_scaling=0.5, input_shift=0.0, teacher_scaling=1.0)

    def cuda_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(args.reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / args.reps

    ok, G = True, 128
    for c in (mimo_4x8_cdl(), mimo_4x8_nbf()):
        n_res = c.esn.n_reservoir
        n_in, n_out = 2 * c.channel.n_rx, 2 * c.channel.n_tx
        delay = c.esn.shared_delay(c.ofdm.isi_duration)
        T = c.ofdm.n_subcarriers + c.ofdm.cp_len + delay
        B, n_forget = G * c.data_symbols_per_block, delay + c.ofdm.cp_len
        res = init_reservoir(rng.prng_key(7, dev), n_in, n_out, n_res,
                             c.esn.spectral_radius, c.esn.sparsity, 0.0)
        x = torch.randn(B, T, n_in, generator=gen, device=dev)
        W = 0.02 * torch.randn(G, n_res + n_in, n_out, generator=gen,
                               device=dev)
        plain = esn_predict(res, scale, W, x, n_forget)
        plain_ms = cuda_ms(lambda: esn_predict(res, scale, W, x, n_forget))
        print(f"[{c.name}] rows {B} T {T} n_res {n_res} Dg {B // G}: plain "
              f"{plain_ms:.3f} ms")
        for readout in ("per_row", "grouped"):
            Dg = B // G if readout == "grouped" else None
            chosen = esn_cuda.predict_tiling(B, n_res, n_in, n_out, n_sm,
                                             Dg=Dg)
            plans = [chosen]
            for h in esn_cuda.tile_heights(n_res):
                for bps in (1, 2):
                    waves = -(-B // (n_sm * bps * h))
                    rows = -(-B // (n_sm * bps * waves))
                    slots = 0 if Dg is None else esn_cuda.grouped_slots(
                        G, Dg, rows)
                    p = esn_cuda.Tiling(
                        rows, -(-B // rows), esn_cuda.predict_smem_bytes(
                            n_res, n_in, n_out, h, slots), bps, h, waves)
                    if (slots <= 4 and p.smem_bytes <= esn_cuda.SMEM_BLOCK_MAX
                            and bps * (p.smem_bytes + 1024) <= 233_472
                            and (bps == 1 or esn_cuda.block_threads(
                                n_res, h) == 128)
                            and all((p.rows_per_block, p.height)
                                    != (q.rows_per_block, q.height)
                                    for q in plans)):
                        plans.append(p)
            for p in plans + [chosen]:       # chosen first and last: in turns
                run = lambda: esn_cuda.esn_predict_cuda(      # noqa: E731
                    res, scale, W, x, n_forget, 0, readout=readout, tiling=p)
                out = run()
                torch.cuda.synchronize()
                good = torch.allclose(out, plain, atol=1e-4, rtol=1e-3)
                ok &= good
                print(f"[{c.name} {readout}] tile {p.height} x "
                      f"{p.blocks_per_sm} a SM, {p.blocks} blocks of "
                      f"{p.rows_per_block} rows in {p.waves} wave(s), "
                      f"{p.smem_bytes} B"
                      f"{' (chosen)' if p is chosen else ''}: "
                      f"{cuda_ms(run):.3f} ms, max abs err "
                      f"{float((out - plain).abs().max()):.3e}"
                      f"{'' if good else ' MISMATCH'}")
        tf = esn_cuda.predict_tiling(B, n_res, n_in, n_out, n_sm, tf32=True)
        plain_tf = esn_predict(res, scale, W, x, n_forget, tf32=True)
        runs = {p: (lambda p=p: esn_cuda.esn_predict_cuda(
            res, scale, W, x, n_forget, 0, precision=p))
            for p in ("highest", None)}
        out = runs[None]()
        torch.cuda.synchronize()
        good = torch.allclose(out, plain_tf, atol=5e-4, rtol=1e-3)
        ok &= good
        ms = {p: [] for p in runs}
        for p in ("highest", None, None, "highest"):      # in turns
            ms[p].append(cuda_ms(runs[p]))
        print(f"[{c.name} tf32] tile {tf.height} x {tf.blocks_per_sm} a SM, "
              f"{tf.blocks} blocks of {tf.rows_per_block} rows, "
              f"{tf.smem_bytes} B: {sum(ms[None]) / 2:.3f} ms, fp32 build "
              f"{sum(ms['highest']) / 2:.3f} ms, max abs err against plain "
              f"TF32 {float((out - plain_tf).abs().max()):.3e}"
              f"{'' if good else ' MISMATCH'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
