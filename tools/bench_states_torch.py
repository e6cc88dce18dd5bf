#!/usr/bin/env python3
"""Times of the CUDA state-harvest kernel (K3) under every cluster plan that
fits, beside the cuDNN RNN that computes the same function, and the
compiler's resource use of every K3 build.

    python3 tools/bench_states_torch.py [--ptxas] [--reps N]

For the two full-width fit shapes (mimo_4x8_nbf: 128 rows, T = 522, n_res =
600; mimo_4x8_cdl: 128 rows, T = 138, n_res = 300) it prints the card's
active-cluster counts, then launches K3 with the plan
`models/esn_states_cuda.py:states_plan` chooses and with every other
(cluster size, row tile) that fits, spreading the rows over as many
resident clusters as the card holds; it checks every output against the
plain version (atol 1e-4, rtol 1e-3: the sums are taken in another order)
and prints ms per launch from CUDA events, with the plan's estimated clocks
a step (`_step_clocks`) beside the measured ones at the card's SM clock.
Last, the cuDNN torch.nn.RNN (tanh, no bias, TF32 off) on the same inputs
at noise 0, its ms and its error. It is how one plan is held against
another on the card, and where the step model's constants come from.

--ptxas first compiles csrc/esn_states.cu with `-Xptxas -v` and prints
registers, stack and spill bytes of every build (template argument: the
row tile). Needs a GPU and nvcc.
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


def ptxas_report() -> None:
    """Print registers, stack and spills of every K3 build."""
    from esn_ofdm_mimo_tpu_torch.utils import build
    with tempfile.TemporaryDirectory() as tmp:
        p = subprocess.run(
            build._nvcc_cmd("esn_states", os.path.join(tmp, "k3.so"))
            + ["-Xptxas", "-v"], capture_output=True, text=True)
        log = p.stdout + p.stderr
        if p.returncode:
            raise RuntimeError(f"nvcc failed for esn_states.cu:\n{log}")
        entry, frame = "?", "?"
        for line in log.splitlines():
            m = re.search(r"esn_states_cluster_kernelILi(\d+)E", line)
            if m and "entry function" in line:
                entry = m.group(1)
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                frame = m.groups()
            m = re.search(r"Used (\d+) registers", line)
            if m:
                print(f"[ptxas esn_states] row tile {entry}: {m.group(1)} "
                      f"registers, stack {frame[0]} B, spill stores/loads "
                      f"{frame[1]}/{frame[2]} B", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    from esn_ofdm_mimo_tpu_torch.experiments.presets import (mimo_4x8_cdl,
                                                             mimo_4x8_nbf)
    from esn_ofdm_mimo_tpu_torch.models import esn_states_cuda as k3
    from esn_ofdm_mimo_tpu_torch.models.esn import (EsnScale, esn_states,
                                                    init_reservoir,
                                                    scale_inputs)
    from esn_ofdm_mimo_tpu_torch.utils import rng

    if not torch.cuda.is_available():
        print("bench_states_torch: needs a GPU", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    if args.ptxas:
        ptxas_report()
    dev = torch.device("cuda")
    props = torch.cuda.get_device_properties(dev)
    n_sm = props.multi_processor_count
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    scale = EsnScale(input_scaling=0.5, input_shift=0.0, teacher_scaling=1.0)

    def ms(fn) -> float:
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

    for cfg, label in ((mimo_4x8_nbf(), "nbf fit"),
                       (mimo_4x8_cdl(), "flagship fit")):
        n_res = cfg.esn.n_reservoir
        n_in, n_out = 2 * cfg.channel.n_rx, 2 * cfg.channel.n_tx
        T = (cfg.ofdm.n_subcarriers + cfg.ofdm.cp_len
             + cfg.esn.shared_delay(cfg.ofdm.isi_duration))
        K, B = n_res + n_in + n_out, 128
        r = init_reservoir(rng.prng_key(9, dev), n_in, n_out, n_res,
                           cfg.esn.spectral_radius, cfg.esn.sparsity, 0.0)
        x = torch.randn(B, T, n_in, generator=gen, device=dev)
        d = 0.5 * torch.randn(B, T, n_out, generator=gen, device=dev)
        want = esn_states(r, scale, x, d)
        mcs = k3.max_clusters_on(dev.index or 0, n_res, n_in, n_out)
        chosen = k3.device_plan(B, n_res, n_in, n_out, dev)
        print(f"[{label}] {B} x {T} x {n_res}: active clusters {mcs}",
              flush=True)
        plans = [chosen]
        for C in k3.CLUSTER_SIZES:
            clusters = min(mcs.get(C, 0), n_sm // C, B)
            if clusters <= 0:
                continue
            rows = -(-B // clusters)
            for rt in k3.ROW_TILES:
                p = k3.StatesPlan(C, -(-B // rows), rows, -(-n_res // C),
                                  k3.states_smem_bytes(n_res, n_in, n_out, C,
                                                       rt), rt)
                if (k3.tile_fits(n_res, n_in, n_out, C, rt)
                        and rt < 2 * rows and p != chosen):
                    plans.append(p)
        for p in plans:
            got = k3._launch(r, scale, x, d, 0, p)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not torch.allclose(got, want, atol=1e-4, rtol=1e-3):
                print(f"bench_states_torch: {label} {p} differs from the "
                      f"plain version (max abs err {err})", file=sys.stderr)
                return 1
            t = ms(lambda: k3._launch(r, scale, x, d, 0, p))
            full, left = divmod(p.rows_per_cluster, p.row_tile)
            tiles = [p.row_tile] * full + (
                [k3.tail_tile(p.row_tile, left)] if left else [])
            est = sum(k3._step_clocks(n_res, K, p.cluster, rt) for rt in tiles)
            print(f"[{label}] C {p.cluster} x {p.clusters} clusters, "
                  f"{p.rows_per_cluster} rows in tiles {tiles}, "
                  f"{p.smem_bytes} B{' (chosen)' if p == chosen else ''}: "
                  f"{t:.3f} ms, {1e3 * t / (T - 1):.3f} us a step "
                  f"(estimated {est:.0f} clocks a step), max abs err "
                  f"{err:.2e}", flush=True)
        rnn = torch.nn.RNN(n_in + n_out, n_res, nonlinearity="tanh",
                           bias=False, batch_first=True).to(dev)
        with torch.no_grad():
            rnn.weight_ih_l0.copy_(torch.cat([r.W_in_t, r.W_fb_t]).T)
            rnn.weight_hh_l0.copy_(r.Wt.T)
            xz = torch.cat([scale_inputs(scale, x)[:, 1:], d[:, :-1]],
                           dim=2).contiguous()
            err = float((rnn(xz)[0] - want[:, 1:]).abs().max())
            t = ms(lambda: rnn(xz))
        print(f"[{label}] cuDNN RNN (the yardstick): {t:.3f} ms, max abs "
              f"err {err:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
