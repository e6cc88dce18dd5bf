#!/usr/bin/env python3
"""Per-iteration cost of the CUDA BP decoders (K1 flooding, K1-layered) and
the attribution builds of the flooding kernel: the port of
tools/bench_bp_itercost.py.

    python3 tools/bench_bp_torch.py [--ptxas] [--reps N] [--lo L] [--hi H]
                                    [--batch B] [--device D] [--no-diag]
                                    [--wide]

For each code the presets decode with (mimo_4x8_cdl: n = 512, 75,776
codewords; mimo_4x8_nbf: n = 2048, 12,800 codewords: the batches
chip_smoke.py times) it draws BPSK/AWGN codewords at Eb/N0 = -3 dB, where
no codeword converges, so every codeword runs the whole budget. It times
each decode at the caps L and H (CUDA events, one warm-up, N launches) and
prints the marginal ms per iteration (t_H - t_L) / (H - L), in which the
launch, the LLR load and the result write cancel; for the three check
rules and both schedules (an iteration of the layered schedule is one sweep
over the dv base rows). --wide adds the codes of mimo_4x8_nbf at 64- and
256-QAM (n = 3,072 and 4,096, Z = 384 and 512; 2,048 codewords each, as
chip_smoke.py's [K1 Z384/Z512] lines), without attribution builds.

Then the attribution builds of the flooding kernel
(ldpc/decode_cuda.py:DIAG_BUILDS; compile-time switches of csrc/bp_decode.cu,
launched only here and counted in `launches_diag`, results wrong by design)
the same way: the kernel at a fixed iteration count without the exit vote
("fixed"), then with the check rule a copy of its inputs, the syndrome
removed, the variable update removed, and all three ("floor"). "fixed"
minus each build is what that part costs an iteration; the floor is the
barriers and the shared-memory reads and writes that remain. --no-diag
leaves them out.

--ptxas first compiles both BP sources with -Xptxas -v and prints the
registers and spill bytes of every kernel in them (template arguments: DC,
DV, checks a thread and the attribution mask; DV and DC for the layered
kernel); it exits 1 if a build spills. --device cpu runs the plain versions on a small batch
against the host clock: a check that the tool runs, not a time of the card.
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import torch  # noqa: E402

from esn_ofdm_mimo_tpu_torch.experiments.presets import (  # noqa: E402
    mimo_4x8_cdl, mimo_4x8_nbf)
from esn_ofdm_mimo_tpu_torch.ldpc import (decode_cuda, ldpc_encode,  # noqa: E402
                                          make_code)
from esn_ofdm_mimo_tpu_torch.ldpc.decode import ALGOS  # noqa: E402
from esn_ofdm_mimo_tpu_torch.utils.device import resolve_device  # noqa: E402

EBNO_DB = -3.0
DIAG_NAMES = {1: "fixed", 3: "copy rule", 5: "no syndrome",
              9: "no var update", 15: "floor"}


def ptxas_report() -> bool:
    """Print registers and spills per BP kernel; True if none spills."""
    from esn_ofdm_mimo_tpu_torch.utils import build
    clean = True
    with tempfile.TemporaryDirectory() as tmp:
        procs = {n: subprocess.Popen(
            build._nvcc_cmd(n, os.path.join(tmp, f"{n}.so"))
            + ["-Xptxas", "-v"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for n in ("bp_decode", "bp_decode_layered")}
        for name, p in procs.items():
            log, _ = p.communicate()
            if p.returncode:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
            entry, spill = "?", ("?", "?")
            for line in log.splitlines():
                m = re.search(r"(bp_[a-z_]*kernel)((?:I|Li\d+E)*)", line)
                if m and "entry function" in line:
                    args = re.findall(r"Li(\d+)E", m.group(2))
                    entry = f"{m.group(1)}<{', '.join(args)}>"
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
                if m:
                    spill = m.groups()
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    print(f"[ptxas {name}] {entry}: {m.group(1)} registers, "
                          f"spill stores/loads {spill[0]}/{spill[1]} B",
                          flush=True)
                    clean &= spill == ("0", "0")
    return clean


def awgn_llrs(code, B: int, dev, seed: int = 1) -> torch.Tensor:
    """Channel LLRs of B random codewords, BPSK over AWGN at EBNO_DB."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    u = torch.randint(0, 2, (B, code.k), generator=g, device=dev,
                      dtype=torch.int8)
    x = 1.0 - 2.0 * ldpc_encode(code, u).float()
    sigma2 = 1.0 / (2.0 * code.k / code.n * 10.0 ** (EBNO_DB / 10.0))
    y = x + sigma2 ** 0.5 * torch.randn(x.shape, generator=g, device=dev)
    return (2.0 * y / sigma2).contiguous()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--lo", type=int, default=10)
    ap.add_argument("--hi", type=int, default=40)
    ap.add_argument("--batch", type=int, default=None,
                    help="codewords a code (default: chip_smoke.py's)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-diag", action="store_true",
                    help="leave out the attribution builds")
    ap.add_argument("--wide", action="store_true",
                    help="add the n = 3,072 and 4,096 codes")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
        if args.ptxas and not ptxas_report():
            print("bench_bp_torch: a BP build spills", file=sys.stderr)
            return 1
    else:
        print("cpu: plain versions, host clock (not a device time)")

    def ms(fn) -> float:
        fn()
        if not on_card:
            t0 = time.perf_counter()
            for _ in range(args.reps):
                fn()
            return 1e3 * (time.perf_counter() - t0) / args.reps
        torch.cuda.synchronize(dev)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(args.reps):
            fn()
        e1.record()
        torch.cuda.synchronize(dev)
        return e0.elapsed_time(e1) / args.reps

    def marginal(label: str, code, llr, run) -> float:
        """run(cap) -> stats; prints and returns ms per iteration."""
        t = {c: ms(lambda c=c: run(c)) for c in (args.lo, args.hi)}
        conv = int(run(args.hi)["converged"].sum())
        per = (t[args.hi] - t[args.lo]) / (args.hi - args.lo)
        edges = code.dv * code.n * llr.shape[0]
        print(f"[{label}] {llr.shape[0]} codewords of n = {code.n} at "
              f"{EBNO_DB} dB, converged {conv} | {args.lo} it "
              f"{t[args.lo]:.3f} ms, {args.hi} it {t[args.hi]:.3f} ms | "
              f"{per:.4f} ms an iteration, {1e9 * per / edges:.4f} ps an "
              f"edge-iteration (card-wide)", flush=True)
        return per

    nbf = mimo_4x8_nbf()
    codes = [(mimo_4x8_cdl(), 4, 75_776, True), (nbf, 4, 12_800, True)]
    if args.wide:
        codes += [(nbf, 6, 2_048, False), (nbf, 8, 2_048, False)]
    for cfg, bits, B, diag in codes:
        code = make_code(cfg.ldpc, cfg.ofdm.n_subcarriers * bits)
        llr = awgn_llrs(code, args.batch or B, dev)
        kw = dict(minsum_offset=cfg.ldpc.minsum_offset)
        for schedule in ("flooding", "layered"):
            for algo in ALGOS:
                marginal(f"{schedule} {algo}", code, llr,
                         lambda c, s=schedule, a=algo:
                         decode_cuda.ldpc_decode_bp_cuda(
                             code, llr, c, a, schedule=s, **kw)[1])
        for algo in ALGOS if diag and not args.no_diag else ():
            per = {d: marginal(
                f"diag {DIAG_NAMES[d]} {algo}", code, llr,
                lambda c, d=d, a=algo: decode_cuda.ldpc_decode_bp_diag(
                    code, llr, c, a, d, **kw)[1])
                for d in decode_cuda.DIAG_BUILDS}
            parts = {"check arithmetic": per[1] - per[3],
                     "syndrome": per[1] - per[5],
                     "var update": per[1] - per[9], "floor": per[15]}
            print(f"[diag split {algo} n = {code.n}] ms an iteration: fixed "
                  f"{per[1]:.4f} = " + " + ".join(
                      f"{k} {v:.4f}" for k, v in parts.items())
                  + f" + not additive {per[1] - sum(parts.values()):.4f}",
                  flush=True)
    print(f"launches: decode {decode_cuda.launches} layered "
          f"{decode_cuda.launches_layered} attribution builds "
          f"{decode_cuda.launches_diag}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
