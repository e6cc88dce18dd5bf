#!/usr/bin/env python3
"""Run one cell of the benchmark of esn_ofdm_mimo_tpu_torch once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up (imports, the cell's CUDA libraries, its entry, one warm-up call
that captures its graphs), then a closed loop of the cell's calls for
`--seconds` seconds: each call on fresh block keys drawn from the seed,
the next issued once the last one's answer is on the host. Then, with
`--trace 1`, a few more calls under torch.profiler. Then the check: the
program's state is freed, and a sample of the window's calls, drawn from
the seed, is worked out again by the plain reference on the same keys and
compared number by number (reference/compare.py).

Prints on standard output an earlier line with the set-up's parts and, as
its last line, one JSON object: correct, attempted, failed, metrics
(the cell's end-to-end metrics, or with --trace 1 its per-layer ones),
device, with --trace 1 breakdown, and last `check`, each compared number
beside its limit; the same numbers end standard error. Exits non-zero,
with no result, without a card, with fewer cards than the cell asks for,
or where jax, jaxlib, flax or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "esn_ofdm_mimo_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package, compared whole (the program's own name begins with the JAX
    package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """What the metric readers read: the cell, its entry, the window's
    calls (host clock), the set-up time and, traced, the trace."""

    def __init__(self, cell, wl, entry, dev):
        self.cell, self.workload, self.entry, self.dev = cell, wl, entry, dev
        self.calls = []           # dicts: issue, enqueued, done, answer
        self.window = (0.0, 0.0)  # host perf_counter seconds
        self.setup_s = None
        self.trace = None

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def program_config(cfg_file: dict):
    """The program's SimConfig of a configuration file: built from its
    `sim` tree by the program's own dataclasses, and, where the file names
    a preset, checked to be what that preset yields, so that a change to
    the preset cannot move the yardstick silently."""
    import dataclasses
    from esn_ofdm_mimo_tpu_torch import config as pc
    from esn_ofdm_mimo_tpu_torch.experiments import presets
    tree = cfg_file["sim"]
    groups = {"ofdm": pc.OfdmConfig, "pa": pc.PaConfig,
              "channel": pc.ChannelConfig, "esn": pc.EsnConfig,
              "ldpc": pc.LdpcConfig, "calib": pc.CalibConfig}
    kw = {k: (groups[k](**v) if k in groups else v) for k, v in tree.items()}
    kw["ebno_db"] = tuple(kw["ebno_db"])
    sim = pc.SimConfig(**kw)
    as_json = json.loads(json.dumps(dataclasses.asdict(sim)))
    if as_json != tree:
        raise ValueError("the configuration's sim tree has fields the "
                         "program's SimConfig does not")
    if cfg_file.get("preset") is not None:
        preset = presets.get_preset(cfg_file["preset"])
        if json.loads(json.dumps(dataclasses.asdict(preset))) != tree:
            raise ValueError(f"the program's preset {cfg_file['preset']!r} "
                             f"no longer yields the configuration's sim tree")
    return sim


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the benchmark); cpu runs the program's "
                         "plain path at a tiny configuration, for tests")
    return ap


def _card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def _err(msg: str):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    """Run the cell; returns the exit code. `--device cpu` runs the
    program's plain path (tests only: nothing of a CPU run is a device
    metric, and its result says platform "cpu")."""
    args = _parser().parse_args(argv)
    from benchmark import manifest, traffic
    from benchmark.reference import compare
    import benchmark.reference as reference

    bench = manifest.benchmark()
    wl = manifest.workload(args.workload)
    cfg_file = manifest.config(wl["config"])
    entry_mod = manifest.entry(wl["entry"])

    import torch
    on_cpu = args.device == "cpu"
    if not on_cpu:
        if not torch.cuda.is_available():
            _err("torch.cuda.is_available() is False: no result")
            return 2
        if torch.cuda.device_count() < int(wl["chips"]):
            _err(f"{torch.cuda.device_count()} card(s), the cell asks for "
                 f"{wl['chips']}: no result")
            return 2
    dev = torch.device("cpu" if on_cpu else "cuda", None if on_cpu else 0)
    parts = {}

    # ---- set-up ------------------------------------------------------------
    t = time.perf_counter()
    import esn_ofdm_mimo_tpu_torch  # noqa: F401  (TF32 off at import)
    from esn_ofdm_mimo_tpu_torch.utils import build
    sim = program_config(cfg_file)
    parts["imports_s"] = time.perf_counter() - t
    t = time.perf_counter()
    parts["build_s"] = 0.0
    if not on_cpu:
        built = build.build_all(entry_mod.LIBS)
        parts["build_s"] = max(built.values(), default=0.0)
        parts["built"] = sorted(n for n, s in built.items() if s > 0)
    if not on_cpu:
        torch.cuda.set_device(dev)
    entry = entry_mod.Entry(sim, dev, wl)
    entry.setup()
    parts["entry_s"] = time.perf_counter() - t

    def keys_of(i):
        return traffic.call_keys(args.seed, int(wl["snr_index"]),
                                 entry.rounds, int(wl["blocks"]), i, dev)

    t = time.perf_counter()
    entry.read(entry.issue(keys_of(0)))         # warm-up: captures graphs
    parts["warmup_s"] = time.perf_counter() - t
    parts.update(entry.captured())
    from benchmark.entries._common import python_launches
    before = python_launches()
    run = Run(args.workload, wl, entry, dev)
    run.setup_s = time.perf_counter() - T_START
    parts["setup_s"] = run.setup_s
    print(json.dumps({"setup": parts}), flush=True)

    # ---- the window -----------------------------------------------------------
    sync = (torch.cuda.synchronize if not on_cpu else (lambda: None))
    i = 1
    sync()
    t0 = time.perf_counter()
    while True:
        keys = keys_of(i)
        sync()
        a = time.perf_counter()
        handle = entry.issue(keys)
        b = time.perf_counter()
        ans = entry.read(handle)
        c = time.perf_counter()
        run.calls.append({"i": i, "issue": a, "enqueued": b, "done": c,
                          "answer": ans})
        i += 1
        if c - t0 >= args.seconds:
            break
    run.window = (t0, run.calls[-1]["done"])
    if not on_cpu and python_launches() != before:
        _err("a timed call launched kernels from Python: it captured its "
             "graphs again")
        return 5

    # ---- the traced calls ------------------------------------------------------
    if args.trace:
        from torch.profiler import record_function
        from benchmark import trace as tr
        n_traced = int(wl["trace_calls"])

        def traced(j):
            with record_function("bench.call"):
                with record_function("bench.keys"):
                    k = keys_of(i + j)
                with record_function("bench.issue"):
                    h = entry.issue(k)
                with record_function("bench.read"):
                    return entry.read(h)

        if not on_cpu:
            run.trace = tr.traced_calls(traced, n_traced)

    # ---- metrics -------------------------------------------------------------
    metrics = {}
    units = {}
    for m in manifest.cell_metrics(bench, args.workload, bool(args.trace)):
        units[m["name"]] = m["unit"]
        if m["name"] == "setup_s":
            metrics["setup_s"] = {"value": run.setup_s, "unit": m["unit"]}
            continue
        v = manifest.metric(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if not on_cpu:
        mem = torch.cuda.max_memory_allocated(dev)
        device_info = {"platform": "gpu",
                       "kind": torch.cuda.get_device_name(dev),
                       "count": int(wl["chips"]),
                       "memory_peak_bytes": int(mem)}
        _err(f"card: {_card_line()}")
    else:
        device_info = {"platform": "cpu", "kind": "cpu", "count": 1,
                       "memory_peak_bytes": 0}
    if run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s

    # ---- the check ----------------------------------------------------------------
    expected = {k: v for k, v in wl.get("totals", {}).items()}
    failed = sum(1 for c in run.calls
                 if any(c["answer"].get(k) != v for k, v in expected.items()))
    sample = random.Random(args.seed).sample(
        range(len(run.calls)), min(int(wl["check_calls"]), len(run.calls)))
    del handle, ans
    entry.free()
    ref_cfg = reference.sim_config(cfg_file["sim"])
    worst = {}
    for j in sorted(sample):
        call = run.calls[j]
        ref = entry.reference(ref_cfg, keys_of(call["i"]), tf32=False)
        for name, (v, lim) in compare.check(wl["check"], call["answer"],
                                            ref).items():
            if name not in worst or not v <= worst[name][0]:
                worst[name] = (v, lim)
    correct = compare.passed(worst) and failed == 0

    bad = forbidden_modules()
    if bad:
        _err(f"modules loaded that the benchmark may not load: {bad}")
        return 3

    check = {n: {"value": v if v == v and abs(v) != float("inf")
                 else repr(v), "limit": lim}
             for n, (v, lim) in worst.items()}
    for n, (v, lim) in worst.items():
        _err(f"check {n} {v!r} limit {lim!r}")
    out = {"correct": bool(correct), "attempted": len(run.calls),
           "failed": failed, "metrics": metrics, "device": device_info}
    if run.trace is not None:
        out["breakdown"] = run.trace.breakdown()
    out["check"] = check
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
