#!/usr/bin/env python3
"""Wall time of the full-width block-fading SNR point by phase, with the
ESN fits inside its `esn_fit` phase split into their pieces, and the
same split of the flagship point's ESN fits.

    python3 tools/bench_nbf_torch.py [--reps N] [--blocks G] [--device D]

It drives `parallel/montecarlo.py:nbf_snr_point` on `mimo_4x8_nbf` with
chip_smoke.py's `[nbf main]` keys and order: a warm-up on 8 blocks at 12 dB,
then 3 dB and 12 dB on G blocks (default 128, one round), N times. For each
point it prints the phase walls (`timings`) and, summed over the point's two
ESN fits (`models/esn_mimo.py:train_mimo_esn`, matched and 12 dB fixed,
through `models/esn.py:esn_fit`):

  * fit: the whole of each fit call;
  * states: the state harvest (`esn_states_cuda`: K3 on the card), from a
    device synchronisation before the call to one after it;
  * states host: the same call until it returns, before the second
    synchronisation: the wrapper's host work (plan, weight slices, launch);
  * solve: the ridge readout solve (`_readout_lstsq`).

Then, in each repetition, the flagship point `cdl_snr_point` on
`mimo_4x8_cdl` with chip_smoke.py's `[main]` keys (G blocks, one
calibration and one decode round at 12 dB: two ESN fits of G blocks), its
phases and the same split of its fits.

Each point's line ends with its counters (uncoded and info-bit errors;
the flagship's calibration round's, then the decode round's uncoded, info,
frame errors and BP iterations), so two trees' points compare bit for bit.

Each piece is timed on the host clock between device synchronisations, so
the split adds a few synchronisations to the phase it reads. The tool uses
only the package beside it: a copy of it in another checkout times that
checkout, which is how two trees are compared on one card (run them in one
call, in the order A, B, B, A). `--device cpu` with a few blocks checks that
the tool runs (host clock, not a device time).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import torch  # noqa: E402

from esn_ofdm_mimo_tpu_torch.experiments.presets import (  # noqa: E402
    mimo_4x8_cdl, mimo_4x8_nbf)
from esn_ofdm_mimo_tpu_torch.models import esn  # noqa: E402
from esn_ofdm_mimo_tpu_torch.models import esn_states_cuda  # noqa: E402
from esn_ofdm_mimo_tpu_torch.parallel import (  # noqa: E402
    cdl_snr_point, nbf_snr_point)
from esn_ofdm_mimo_tpu_torch.pipelines import common  # noqa: E402
from esn_ofdm_mimo_tpu_torch.utils import rng  # noqa: E402
from esn_ofdm_mimo_tpu_torch.utils.device import resolve_device  # noqa: E402


def _timed(split: dict, dev, fit, states, solve):
    """Wrappers of the fit, the state harvest and the solve that add their
    walls (ms) to `split`."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def wrap(fn, key, host_key=None):
        def run(*a, **kw):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if host_key:
                split[host_key] = split.get(host_key, 0.0) + 1e3 * (
                    time.perf_counter() - t0)
            sync()
            split[key] = split.get(key, 0.0) + 1e3 * (
                time.perf_counter() - t0)
            return out
        return run
    return (wrap(fit, "fit"), wrap(states, "states", "states host"),
            wrap(solve, "solve"))


def _counters(*dicts) -> str:
    """Counter dicts (detector -> int or scalar tensor) as one JSON list,
    to compare two trees' points bit for bit."""
    return json.dumps([{k: int(v) for k, v in sorted(d.items())}
                       for d in dicts])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--blocks", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    else:
        print("cpu: plain versions, host clock (not a device time)")
    nbf = mimo_4x8_nbf()
    G = args.blocks
    root = rng.prng_key(0)
    keys = {e: rng.block_keys(root, nbf.ebno_db.index(e), torch.arange(G))
            .reshape(1, G, 2).numpy() for e in (3.0, 12.0)}
    split: dict = {}
    # esn_fit (which train_mimo_esn calls) looks both up at each call
    common.train_mimo_esn, esn_states_cuda.esn_states_cuda, \
        esn._readout_lstsq = _timed(
            split, dev, common.train_mimo_esn, esn_states_cuda.esn_states_cuda,
            esn._readout_lstsq)
    cdl = mimo_4x8_cdl()
    ck = rng.block_keys(root, 0, torch.arange(2 * G)).reshape(2, 1, G, 2)
    nbf_snr_point(nbf, 12.0, keys[12.0][:, :min(8, G)], device=dev)
    cdl_snr_point(cdl, 12.0, ck[0][:, :min(8, G)], ck[1][:, :min(8, G)],
                  device=dev)
    for rep in range(args.reps):
        for ebno in (3.0, 12.0):
            split.clear()
            phases: dict = {}
            t0 = time.perf_counter()
            pt = nbf_snr_point(nbf, ebno, keys[ebno], device=dev,
                               timings=phases)
            wall = 1e3 * (time.perf_counter() - t0)
            print(f"[nbf point] rep {rep} {ebno} dB, {G} blocks: wall "
                  f"{wall:.1f} ms | phases "
                  f"{json.dumps({k: round(v, 1) for k, v in phases.items()})}"
                  f" | fits {json.dumps({k: round(v, 2) for k, v in split.items()})}"
                  f" | counters {_counters(pt.bit_errors, pt.info_errors)}",
                  flush=True)
        split.clear()
        phases = {}
        t0 = time.perf_counter()
        pt = cdl_snr_point(cdl, 12.0, ck[0], ck[1], device=dev,
                           timings=phases)
        wall = 1e3 * (time.perf_counter() - t0)
        fits = {k: round(v, 2) for k, v in split.items()}
        c = pt.counts
        print(f"[flagship point] rep {rep} 12.0 dB, {G} blocks x (1 cal + 1 "
              f"decode): wall {wall:.1f} ms | phases "
              f"{json.dumps({k: round(v, 1) for k, v in phases.items()})}"
              f" | fits {json.dumps(fits)} | counters "
              + _counters(pt.cal_bit_errors, c.bit_errors, c.info_errors,
                          c.frame_errors, c.ldpc_iter_sum), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
