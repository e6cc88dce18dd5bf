#!/usr/bin/env python3
"""The readings that set a cell's limits: for each seed, call 1 of the
cell's traffic through the program (the cell's own entry at its own
sizes, graphs captured once and replayed), the plain reference on the
same keys, and the control (the reference computed with TF32 matrix
products, the nearest precision below the configuration's fp32), put in
the program's place. One JSON line a seed on standard output: each side's
answer, every key's relative gap to the reference, and the cell's check
numbers for the program and for the control.

    python3 benchmark/readings.py --workload <cell> --seeds 11 12 13
        [--control N] [--device cuda|cpu]

The benchmark's runs never run this; the limits in the workload files
come from its output (PERF.md gives the readings).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))


def readings(cell: str, seeds, control=None, device: str = "cuda",
             out=sys.stdout) -> list:
    """One row a seed (printed to `out` as it comes); the control on the
    first `control` seeds (None: on every seed)."""
    import torch

    from benchmark import manifest, traffic
    from benchmark import reference
    from benchmark.reference import compare
    from benchmark.run import program_config

    wl = manifest.workload(cell)
    cfg_file = manifest.config(wl["config"])
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no card")
    sim = program_config(cfg_file)
    ref_cfg = reference.sim_config(cfg_file["sim"])
    entry = manifest.entry(wl["entry"]).Entry(sim, dev, wl)
    entry.setup()
    rows = []
    for n, seed in enumerate(seeds):
        keys = traffic.call_keys(seed, int(wl["snr_index"]), entry.rounds,
                                 int(wl["blocks"]), 1, dev)
        if n == 0:                       # the capture, on other keys
            entry.read(entry.issue(traffic.call_keys(
                seed, int(wl["snr_index"]), entry.rounds, int(wl["blocks"]),
                0, dev)))
        t = time.perf_counter()
        prog = entry.read(entry.issue(keys))
        t_prog = time.perf_counter() - t
        t = time.perf_counter()
        ref = entry.reference(ref_cfg, keys, tf32=False)
        t_ref = time.perf_counter() - t
        row = {"cell": cell, "seed": seed, "program_s": t_prog,
               "reference_s": t_ref, "program": prog, "reference": ref,
               "gaps": compare.gaps(prog, ref),
               "check": {k: v for k, (v, _) in
                         compare.check(wl["check"], prog, ref).items()}}
        if control is None or n < control:
            t = time.perf_counter()
            ctl = entry.reference(ref_cfg, keys, tf32=True)
            row["control_s"] = time.perf_counter() - t
            row["control"] = ctl
            row["control_gaps"] = compare.gaps(ctl, ref)
            row["control_check"] = {
                k: v for k, (v, _) in
                compare.check(wl["check"], ctl, ref).items()}
        print(json.dumps(row, default=repr), file=out, flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=None,
                    help="run the control on the first N seeds only "
                         "(default: every seed)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    readings(args.workload, args.seeds, args.control, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
