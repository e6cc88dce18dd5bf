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

Then the attribution builds of both kernels (ldpc/decode_cuda.py:
DIAG_BUILDS; compile-time switches of csrc/bp_decode.cu and
csrc/bp_decode_layered.cu, launched only here through
`ldpc_decode_bp_diag(..., schedule=...)` and counted in `launches_diag`,
results wrong by design) the same way: the kernel at a fixed iteration
count without the exit vote ("fixed"), then with the check rule a copy of
its inputs, the syndrome removed, the variable update (layered: the
posterior write) removed, and all three ("floor"). "fixed" minus each build
is what that part costs an iteration; the floor is the barriers and the
shared-memory reads and writes that remain. One `[diag split ...]` line per
rule, code and schedule. --no-diag leaves them out.

--ptxas first compiles both BP sources with -Xptxas -v and prints the
registers and spill bytes of every kernel in them (the template arguments
in order); it exits 1 if a build spills. It then counts, with `cuobjdump
-sass`, the instructions of each decode kernel's sweep loop (the span of
its longest backward branch) for each check rule: the layered kernel's rule
is a template argument, the flooding kernel's a runtime one, so its source
is compiled once more per rule with the rule fixed (-DBP_SASS_ALGO). Over
the edges a thread covers in a sweep that is the issue slots an edge, and
edges x slots / (128 thread slots a clock per SM x SMs x the card's top SM
clock) the issue floor of a sweep over the batch, printed beside the
measured ms. --device cpu runs the
plain versions on a small batch against the host clock: a check that the
tool runs, not a time of the card.
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


_KERNEL = re.compile(r"(bp_[a-z_]*kernel)(I(?:L[ib]\d+E)+E)?")


def _entry(mangled_match) -> tuple:
    """(kernel name, template arguments) of a mangled kernel symbol."""
    return (mangled_match.group(1), tuple(
        int(a) for a in re.findall(r"L[ib](\d+)E",
                                   mangled_match.group(2) or "")))


def ptxas_report(tmp: str) -> tuple:
    """Print registers and spills per BP kernel; build into `tmp` the
    libraries whose SASS holds each (schedule, rule)'s decode kernel: the
    layered source's own, the flooding source once per rule with the rule
    fixed. Returns (True if no build spills, {(schedule, algo): library})."""
    from esn_ofdm_mimo_tpu_torch.utils import build
    clean = True
    out = lambda tag: os.path.join(tmp, f"{tag}.so")  # noqa: E731
    flood, layered = decode_cuda._SOURCES.values()
    jobs = {n: build._nvcc_cmd(n, out(n)) + ["-Xptxas", "-v"]
            for n in (flood, layered)}
    jobs.update({a: build._nvcc_cmd(flood, out(a)) + [f"-DBP_SASS_ALGO={i}"]
                 for i, a in enumerate(ALGOS)})
    procs = {key: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
             for key, cmd in jobs.items()}
    libs = {}
    for key, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        if key in ALGOS:
            libs[("flooding", key)] = out(key)
            continue
        entry, spill = "?", ("?", "?")
        for line in log.splitlines():
            m = _KERNEL.search(line)
            if m and "entry function" in line:
                k, args = _entry(m)
                entry = f"{k}<{', '.join(map(str, args))}>"
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spill = m.groups()
            m = re.search(r"Used (\d+) registers", line)
            if m:
                print(f"[ptxas {key}] {entry}: {m.group(1)} registers, "
                      f"spill stores/loads {spill[0]}/{spill[1]} B",
                      flush=True)
                clean &= spill == ("0", "0")
    libs.update({("layered", a): out(layered) for a in ALGOS})
    return clean, libs


def sweep_loops(lib: str) -> dict:
    """{(kernel, template arguments): instructions of its sweep loop} for
    every BP kernel in a built library: the span, in SASS instructions, of
    the function's longest backward branch."""
    from esn_ofdm_mimo_tpu_torch.utils import build
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    loops, key, addrs = {}, None, []

    def close():
        if key is not None:
            spans = [(a - t) for a, t in addrs if t < a]
            loops[key] = max(spans, default=0) // 16 + 1
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            close()
            k = _KERNEL.search(m.group(1))
            key, addrs = (_entry(k) if k else None), []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*)", line)
        if m and key is not None:
            b = re.search(r"\bBRA(?:\.\S+)?\s+(?:\S+,\s*)?(0x[0-9a-f]+)",
                          m.group(2))
            if b:
                addrs.append((int(m.group(1), 16), int(b.group(1), 16)))
    close()
    return loops


def sm_clock_hz() -> float:
    """The card's top SM clock (nvidia-smi clocks.max.sm)."""
    return 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])


def decode_kernel(schedule: str, Z: int, algo: str) -> tuple:
    """((kernel, template arguments), edges a thread covers in a sweep) of
    the decode build (no attribution switch) launched at lifting size Z for
    the rule `algo` (the flooding kernel's rule is a runtime argument: its
    count comes from the build with the rule fixed)."""
    dc, dv = decode_cuda._DC, decode_cuda._DV
    if schedule == "flooding":
        cpt = decode_cuda.checks_per_thread(Z)
        flip = int(cpt == 1 or Z & (Z - 1) == 0)
        return ("bp_flooding_kernel", (dc, dv, cpt, flip, 0)), dc * cpt
    return ("bp_layered_kernel", (ALGOS.index(algo), 0)), dv * dc


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
    loops = {}           # (schedule, algo) -> {(kernel, args): instructions}
    if on_card:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
        if args.ptxas:
            with tempfile.TemporaryDirectory() as tmp:
                clean, libs = ptxas_report(tmp)
                if not clean:
                    print("bench_bp_torch: a BP build spills",
                          file=sys.stderr)
                    return 1
                for key, lib in libs.items():
                    loops[key] = sweep_loops(lib)
            clock = sm_clock_hz()
            n_sm = torch.cuda.get_device_properties(
                dev).multi_processor_count
            print(f"[sass] issue rate: 128 thread slots a clock x {n_sm} "
                  f"SMs x {clock / 1e9:.3f} GHz (clocks.max.sm)", flush=True)
    else:
        print("cpu: plain versions, host clock (not a device time)")

    def issue_floor(schedule: str, algo: str, code, B: int):
        """(slots an edge, ms a sweep at the issue rate) of the decode
        kernel the code launches, from its sweep loop's instructions; None
        without --ptxas."""
        if (schedule, algo) not in loops:
            return None
        key, edges_thread = decode_kernel(schedule, code.qc.Z, algo)
        slots = loops[(schedule, algo)][key] / edges_thread
        edges = B * code.dv * code.n
        return slots, 1e3 * edges * slots / (128 * n_sm * clock)

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

    def marginal(label: str, code, llr, run, floor=None) -> float:
        """run(cap) -> stats; prints and returns ms per iteration."""
        t = {c: ms(lambda c=c: run(c)) for c in (args.lo, args.hi)}
        conv = int(run(args.hi)["converged"].sum())
        per = (t[args.hi] - t[args.lo]) / (args.hi - args.lo)
        edges = code.dv * code.n * llr.shape[0]
        issue = "" if floor is None else (
            f" | {floor[0]:.2f} slots an edge, issue floor {floor[1]:.4f} "
            f"ms an iteration ({floor[1] / per:.0%} of it)")
        print(f"[{label}] {llr.shape[0]} codewords of n = {code.n} at "
              f"{EBNO_DB} dB, converged {conv} | {args.lo} it "
              f"{t[args.lo]:.3f} ms, {args.hi} it {t[args.hi]:.3f} ms | "
              f"{per:.4f} ms an iteration, {1e9 * per / edges:.4f} ps an "
              f"edge-iteration (card-wide){issue}", flush=True)
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
                             code, llr, c, a, schedule=s, **kw)[1],
                         issue_floor(schedule, algo, code, llr.shape[0]))
        for schedule in ("flooding", "layered") if diag else ():
            for algo in ALGOS if not args.no_diag else ():
                names = {**DIAG_NAMES, **(
                    {9: "no posterior write"} if schedule == "layered"
                    else {})}
                per = {d: marginal(
                    f"diag {schedule} {names[d]} {algo}", code, llr,
                    lambda c, d=d, a=algo, s=schedule:
                    decode_cuda.ldpc_decode_bp_diag(
                        code, llr, c, a, d, schedule=s, **kw)[1])
                    for d in decode_cuda.DIAG_BUILDS}
                parts = {"check arithmetic": per[1] - per[3],
                         "syndrome": per[1] - per[5],
                         names[9].replace("no ", ""): per[1] - per[9],
                         "floor": per[15]}
                print(f"[diag split {algo} n = {code.n} {schedule}] ms an "
                      f"iteration: fixed {per[1]:.4f} = " + " + ".join(
                          f"{k} {v:.4f}" for k, v in parts.items())
                      + f" + not additive "
                      f"{per[1] - sum(parts.values()):.4f}", flush=True)
    print(f"launches: decode {decode_cuda.launches} layered "
          f"{decode_cuda.launches_layered} attribution builds "
          f"{decode_cuda.launches_diag}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
