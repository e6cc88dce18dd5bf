#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: detected symbols/s on the flagship
4x8 CDL pipeline (mimo_4x8_cdl) on one GPU. The port of bench.py, which
stays the JAX/TPU script: the same keys, shapes, FLOP count and pinned
baseline, the port's functions in place of the JAX ones.

    python3 bench_torch.py [--device cuda] [--blocks 128] [--rounds 64]
        [--cal-rounds 2] [--dec-rounds 6] [--iters 5]

Prints ONE JSON line on stdout, with bench.py's keys:

  value                      detected symbols/s: the best of `iters` calls
                             of run_cdl_cal_counters_chunks (chunks of
                             `blocks` calibration blocks at 12 dB, `rounds`
                             chunks a call, the chunk a CUDA graph replayed
                             once a chunk), rounds x blocks x (D + 1) over
                             its wall, key derivation and the read of the
                             counters included;
  e2e_decoded_symbols_per_s  the same for make_fused_cdl_snr_step: cal
                             rounds, the calibrator fit and LDPC-decoded
                             rounds, (cal + dec rounds) x blocks x (D + 1)
                             over the wall of a call that ends when every
                             field of its point is on the host;
  vs_baseline                value over the NumPy reference's symbols/s
                             (bench_baseline.json, pinned);
  mfu_detect, mfu_e2e        utils/flops.py's FLOPs of each call over its
                             best wall, against the H100's fp32 rate of 67
                             TFLOP/s (TF32 stays off);
  mfu_decode_useful          the BP FLOPs at the executed iteration counts
                             over the decode phase's estimated wall;
  bp_unconverged_frac, flops_per_detected_symbol, the spreads of the timed
                             calls, baseline_pinned: as in bench.py.

The card's name and power limit go to stderr. The default device is the
GPU; without one the script raises (`--device cpu` runs the plain versions
of the kernels, for tests at tiny shapes). Under torchrun each rank runs
both timers (the e2e step over the ranks) and rank 0 prints the line.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from esn_ofdm_mimo_tpu_torch.experiments.presets import mimo_4x8_cdl
from esn_ofdm_mimo_tpu_torch.ldpc import decode_cuda
from esn_ofdm_mimo_tpu_torch.models import esn_cuda, esn_states_cuda
from esn_ofdm_mimo_tpu_torch.parallel import (host_point,
                                              make_fused_cdl_snr_step,
                                              maybe_init_distributed,
                                              trials_mesh)
from esn_ofdm_mimo_tpu_torch.pipelines.cdl import run_cdl_cal_counters_chunks
from esn_ofdm_mimo_tpu_torch.utils import rng
from esn_ofdm_mimo_tpu_torch.utils.device import resolve_device
from esn_ofdm_mimo_tpu_torch.utils.flops import (BP_FLOPS_PER_EDGE,
                                                 calib_fit_flops, cdl_flops)

# H100 SXM fp32 rate outside the tensor cores (NVIDIA data sheet), the
# denominator of every mfu_*: the port runs fp32 with TF32 off
H100_FP32_FLOPS = 67e12
EBNO_DB = 12.0
METRIC = "cdl_4x8_detected_symbols_per_s_per_chip"
ROOT = os.path.dirname(os.path.abspath(__file__))


def detect_keys(i: int, rounds: int, n_blocks: int, device) -> torch.Tensor:
    """Call i's keys of the detection timer, (rounds, n_blocks, 2): block
    ids [i R B, (i + 1) R B) under SNR index 0 of PRNGKey(0)."""
    ids = torch.arange(i * rounds * n_blocks, (i + 1) * rounds * n_blocks,
                       device=device)
    keys = rng.block_keys(rng.prng_key(0, device), 0, ids)
    return keys.reshape(rounds, n_blocks, 2)


def e2e_keys(i: int, cal_rounds: int, dec_rounds: int, n_blocks: int,
             device) -> tuple:
    """Call i's (cal keys (Rc, B, 2), dec keys (Rd, B, 2)) of the e2e
    timer: block ids [i R B, (i + 1) R B), R = Rc + Rd, under SNR index 1
    of PRNGKey(0), the calibration rounds first."""
    R = cal_rounds + dec_rounds
    ids = torch.arange(i * R * n_blocks, (i + 1) * R * n_blocks,
                       device=device)
    keys = rng.block_keys(rng.prng_key(0, device), 1, ids)
    keys = keys.reshape(R, n_blocks, 2)
    return keys[:cal_rounds], keys[cal_rounds:]


def _python_launches() -> tuple:
    """K1, K2 and K3 launched from Python so far: a graph's warm-up and
    capture launch from Python, its replays do not."""
    return (decode_cuda.launches, esn_cuda.launches, esn_states_cuda.launches)


def _check_replayed(dev: torch.device, before: tuple, what: str):
    if dev.type == "cuda" and _python_launches() != before:
        raise RuntimeError(f"{what}: a timed call launched kernels from "
                           f"Python, so it captured its graphs again")


def _bench_detect(cfg, n_blocks: int = 128, rounds: int = 64,
                  iters: int = 3, device=None):
    """Detection throughput (bench.py:_bench_tpu): call 0 warms up (on the
    card an eager chunk and the capture of one), then `iters` timed calls
    on keys 1 .. iters, each deriving its keys and ending when its counters
    are on the host. Returns (symbols/s of the best call, its wall s,
    symbols a call, every wall, the last call's counters (errors a
    detector, total bits))."""
    dev = resolve_device(device)
    D = cfg.data_symbols_per_block

    def call(i):
        errs, total = run_cdl_cal_counters_chunks(
            cfg, EBNO_DB, detect_keys(i, rounds, n_blocks, dev))
        return {d: int(v) for d, v in errs.items()}, total

    call(0)
    before = _python_launches()
    times, counters = [], None
    for i in range(iters):
        t0 = time.perf_counter()
        counters = call(i + 1)
        times.append(time.perf_counter() - t0)
    _check_replayed(dev, before, "detect")
    best = min(times)
    symbols = rounds * n_blocks * (D + 1)  # pilot + data symbols per block
    return symbols / best, best, symbols, times, counters


def _bench_e2e(cfg, n_blocks: int = 128, cal_rounds: int = 2,
               dec_rounds: int = 6, iters: int = 3, device=None, mesh=None):
    """Decode-inclusive throughput (bench.py:_bench_tpu_e2e): one fused SNR
    point a call, make_fused_cdl_snr_step over `mesh` (default
    trials_mesh()): cal rounds, the per-bit calibrator fit, decode rounds.
    Each call's keys are made before its window opens; the window closes
    when every field of the point is on the host. Returns (symbols/s of
    the best call, its wall s, symbols a call, the last call's decoded
    counters (CdlCounts of ints), every wall)."""
    dev = resolve_device(device)
    D = cfg.data_symbols_per_block
    step = make_fused_cdl_snr_step(cfg, dev,
                                   trials_mesh() if mesh is None else mesh)
    host_point(step(EBNO_DB, *e2e_keys(0, cal_rounds, dec_rounds, n_blocks,
                                       dev)))
    before = _python_launches()
    times, dec = [], None
    for i in range(iters):
        ck, dk = e2e_keys(i + 1, cal_rounds, dec_rounds, n_blocks, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = host_point(step(EBNO_DB, ck, dk))
        times.append(time.perf_counter() - t0)
        dec = out.counts     # decoded counters incl. BP iteration telemetry
    _check_replayed(dev, before, "e2e")
    best = min(times)
    symbols = (cal_rounds + dec_rounds) * n_blocks * (D + 1)
    return symbols / best, best, symbols, dec, times


def _bench_numpy_reference(n_data_symbols: int = 3) -> float:
    """Per-symbol cost of a NumPy implementation with the reference's
    execution model (Python-loop ESN recurrence, per-subcarrier solves).
    Measures the data-symbol path only: training is amortised over L=75
    symbols in the reference, so the data path dominates."""
    rng_np = np.random.default_rng(0)
    N, cp, n_tx, n_rx, n_res, isi = 128, 7, 4, 8, 300, 8
    T = N + cp + 3
    W = rng_np.uniform(-0.5, 0.5, (n_res, n_res))
    W *= 0.9 / np.max(np.abs(np.linalg.eigvals(W)))
    W_in = rng_np.uniform(-1, 1, (n_res, 2 * n_rx))
    W_out = rng_np.standard_normal((2 * n_tx, n_res + 2 * n_rx))
    W_fb = rng_np.uniform(-1, 1, (n_res, 2 * n_tx))
    H = (rng_np.standard_normal((N, n_rx, n_tx))
         + 1j * rng_np.standard_normal((N, n_rx, n_tx)))
    t0 = time.perf_counter()
    for _ in range(n_data_symbols):
        u = rng_np.standard_normal((T, 2 * n_rx))
        # reference ESN predict loop (pyESN.py:249-253 execution model)
        s = np.zeros(n_res)
        o = np.zeros(2 * n_tx)
        outs = np.zeros((T, 2 * n_tx))
        for t in range(T):
            s = (np.tanh(W @ s + W_in @ u[t] + W_fb @ o)
                 + 1e-3 * (rng_np.random(n_res) - 0.5))
            o = W_out @ np.concatenate([s, u[t]])
            outs[t] = o
        # per-subcarrier MMSE solves (OFDM_SISO_NBF_LDPC.py:450-460 model)
        Y = (rng_np.standard_normal((N, n_rx))
             + 1j * rng_np.standard_normal((N, n_rx)))
        for k in range(N):
            Hk = H[k]
            G = Hk.conj().T @ Hk + 0.1 * np.eye(n_tx)
            np.linalg.solve(G, Hk.conj().T @ Y[k])
        # hard demap python loop over subcarriers x streams
        const = np.arange(16) + 1j
        for k in range(N):
            for tx in range(n_tx):
                int(np.argmin(np.abs(const - Y[k, tx % n_rx])))
    return n_data_symbols / (time.perf_counter() - t0)


def resolve_baseline(root: str = ROOT) -> tuple:
    """(NumPy symbols/s, pinned) in bench.py's order: the committed pin
    bench_baseline.json, else the local cache .bench_baseline.json, else a
    fresh median of 5 of `_bench_numpy_reference`, cached there."""
    pin = os.path.join(root, "bench_baseline.json")
    cache = os.path.join(root, ".bench_baseline.json")
    for path, pinned in ((pin, True), (cache, False)):
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)["numpy_symbols_per_s"], pinned
    base = statistics.median(_bench_numpy_reference() for _ in range(5))
    with open(cache, "w") as f:
        json.dump({"numpy_symbols_per_s": base,
                   "method": "median of 5 on this host"}, f)
    return base, False


def fit_samples(cfg, cal_rounds: int, n_blocks: int) -> int:
    """(LLR, bit) pairs a bit position that the calibrator fit takes: the
    cal rounds' B D n_tx N, stride-subsampled to calib.max_fit_samples as
    pipelines/cdl.py:fit_calibrators does (ceil(S / stride) kept)."""
    S = (cal_rounds * n_blocks * cfg.data_symbols_per_block
         * cfg.channel.n_tx * cfg.ofdm.n_subcarriers)
    cap = cfg.calib.max_fit_samples
    if cap is not None and S > cap:
        stride = -(-S // int(cap))
        S = -(-S // stride)
    return S


def _card_line(dev: torch.device) -> str:
    name = torch.cuda.get_device_name(dev)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError) as e:
        smi = f"nvidia-smi unavailable ({e})"
    return f"[bench_torch] {name} | {smi}"


def _spread(sym: float, ts: list) -> dict:
    """Throughput spread across the timed calls (`value` stays the best)."""
    rates = sorted(sym / t for t in ts)
    mid = rates[len(rates) // 2] if len(rates) % 2 else \
        0.5 * (rates[len(rates) // 2 - 1] + rates[len(rates) // 2])
    return {"min": round(rates[0], 1), "median": round(mid, 1),
            "max": round(rates[-1], 1), "n": len(rates)}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--blocks", type=int, default=128,
                    help="blocks a chunk and a round")
    ap.add_argument("--rounds", type=int, default=64,
                    help="chunks a detection call")
    ap.add_argument("--cal-rounds", type=int, default=2)
    ap.add_argument("--dec-rounds", type=int, default=6)
    ap.add_argument("--iters", type=int, default=5,
                    help="timed calls of each timer")
    return ap


def main(argv=None, cfg=None) -> None:
    """Run both timers and print the JSON line; `cfg` (default
    mimo_4x8_cdl) lets a test run a tiny configuration."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    maybe_init_distributed(dev)
    mesh = trials_mesh()
    if dev.type == "cuda":
        print(_card_line(dev), file=sys.stderr, flush=True)
    base, pinned = resolve_baseline()
    cfg = mimo_4x8_cdl() if cfg is None else cfg
    n_blocks, rounds = args.blocks, args.rounds
    cal_r, dec_r = args.cal_rounds, args.dec_rounds

    # analytic FLOPs of the executed programs (utils/flops.py) over the
    # best wall, against the H100's fp32 rate
    fl = cdl_flops(cfg, n_blocks)
    f_fit = calib_fit_flops(cfg.ofdm.bits_per_symbol,
                            fit_samples(cfg, cal_r, n_blocks),
                            cfg.calib.gd_steps)

    det, t_detect, sym_detect, t_det_all, _ = _bench_detect(
        cfg, n_blocks, rounds, args.iters, dev)
    e2e, t_e2e, sym_e2e, dec, t_e2e_all = _bench_e2e(
        cfg, n_blocks, cal_r, dec_r, args.iters, dev, mesh)

    f_detect = fl.cal_counters * rounds
    # decode FLOPs at the executed per-codeword iteration counts (each
    # codeword exits on its own), not at the max_iter cap
    code_n = cfg.ofdm.n_subcarriers * cfg.ofdm.bits_per_symbol
    it_exec = sum(int(v) for v in dec.ldpc_iter_sum.values())
    f_decode = (it_exec * float(code_n * cfg.ldpc.dv)
                * BP_FLOPS_PER_EDGE[cfg.ldpc.algo])
    f_e2e = (fl.cal_full * cal_r + f_fit
             + (fl.decode_blocks - fl.decode) * dec_r + f_decode)
    mfu_detect = f_detect / t_detect / H100_FP32_FLOPS
    mfu_e2e = f_e2e / t_e2e / H100_FP32_FLOPS
    # decode-phase wall: the e2e call minus its rounds at the detection
    # timer's per-chunk wall and the calibrator fit at peak; the residual
    # is the BP decode phase (an estimate, as in bench.py)
    t_round_detect = t_detect / rounds
    t_dec_phase = max(t_e2e - (cal_r + dec_r) * t_round_detect
                      - f_fit / H100_FP32_FLOPS, 1e-9)
    mfu_decode = f_decode / t_dec_phase / H100_FP32_FLOPS
    unconv = {d: int(dec.ldpc_unconverged[d]) / max(int(dec.ldpc_codewords),
                                                    1)
              for d in dec.ldpc_unconverged}

    if mesh.rank != 0:
        return
    print(json.dumps({
        "metric": METRIC,
        "value": round(det, 2),
        "unit": "symbols/s",
        "vs_baseline": round(det / base, 2),
        "e2e_decoded_symbols_per_s": round(e2e, 2),
        "mfu_detect": round(mfu_detect, 4),
        "mfu_e2e": round(mfu_e2e, 4),
        # useful work under early exit: the numerator counts each
        # codeword's own iterations, not the kernel's executed sweeps
        "mfu_decode_useful": round(mfu_decode, 4),
        "bp_unconverged_frac": {k: round(v, 4) for k, v in unconv.items()},
        "flops_per_detected_symbol": round(f_detect / sym_detect, 0),
        "detect_spread_symbols_per_s": _spread(sym_detect, t_det_all),
        "e2e_spread_symbols_per_s": _spread(sym_e2e, t_e2e_all),
        "baseline_pinned": pinned,
    }), flush=True)


if __name__ == "__main__":
    main()
