"""One calibrated CDL SNR point on one GPU (port of the single-device part of
esn_ofdm_mimo_tpu/parallel/montecarlo.py: `_cdl_snr_point` as driven by
`make_fused_cdl_snr_step`).

    cal rounds     run_cdl_cal_blocks per round of G blocks: uncoded
                   counters + (llr, bit) calibration pairs
    calibrator fit fit_calibrators on the stacked pairs (per-bit GD)
    decode rounds  run_cdl_detect_llrs per round, then ONE
                   cdl_decode_counters on the round-stacked LLRs (per-codeword
                   decoding is independent, so this equals per-round decoding)

The JAX `lax.scan` over rounds becomes a Python loop; the shard_map over a
device mesh has no counterpart (one GPU). Counters are summed in int64 — the
JAX package's int32 guard goes away — and returned as Python ints.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import torch

from ..config import SimConfig
from ..pipelines.cdl import (CDL_DETECTORS, CdlCounts, cdl_decode_counters,
                             fit_calibrators, run_cdl_cal_blocks,
                             run_cdl_detect_llrs)
from ..utils import rng
from ..utils.device import resolve_device


class CdlSnrPoint(NamedTuple):
    cal_bit_errors: dict       # detector -> uncoded errors over the cal rounds
    cal_total_bits: int
    counts: CdlCounts          # decode rounds: uncoded + coded counters, BP
    #                            telemetry (iteration sum, unconverged)
    calib: dict                # detector -> (a (m,), b (m,)) calibrators


class _PhaseClock:
    """Wall time per phase, in ms, synchronising the device at each mark."""

    def __init__(self, dev: torch.device, out):
        self.dev, self.out = dev, out
        self.t = self._now() if out is not None else 0.0

    def _now(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        return time.perf_counter()

    def mark(self, name: str):
        if self.out is None:
            return
        t = self._now()
        self.out[name] = self.out.get(name, 0.0) + 1e3 * (t - self.t)
        self.t = t


def cdl_snr_point(cfg: SimConfig, ebno_db: float, cal_keys, dec_keys,
                  device=None, timings: dict | None = None) -> CdlSnrPoint:
    """Calibration rounds, calibrator fit and decode rounds at one Eb/N0.

    cal_keys (Rc, G, 2) and dec_keys (Rd, G, 2): per-block uint32 key data
    (numpy arrays, or tensors) as utils.rng.block_keys makes them — the JAX
    package's `jax.random.key_data` layout, so the same keys give the same
    per-block draws. `device` defaults to "cuda" and raises without CUDA
    unless "cpu" is asked for. `timings`, when given, receives the wall ms
    of each phase (cal, fit, detect, decode)."""
    dev = resolve_device(device)
    cal_keys = rng.as_keys(cal_keys, dev)
    dec_keys = rng.as_keys(dec_keys, dev)
    m = cfg.ofdm.bits_per_symbol
    clock = _PhaseClock(dev, timings)

    cal_errs = {d: 0 for d in CDL_DETECTORS}
    cal_bits, llrs, bits = 0, {d: [] for d in CDL_DETECTORS}, []
    for keys in cal_keys:
        out = run_cdl_cal_blocks(cfg, ebno_db, keys)
        for d in CDL_DETECTORS:
            cal_errs[d] = cal_errs[d] + out.bit_errors[d]
            llrs[d].append(out.llr[d].reshape(-1, m))
        cal_bits += out.total_bits
        bits.append(out.bits.reshape(-1, m))
    clock.mark("cal")
    calib = fit_calibrators(cfg, {d: torch.cat(v) for d, v in llrs.items()},
                            torch.cat(bits))
    clock.mark("fit")

    dec_errs = {d: 0 for d in CDL_DETECTORS}
    dec_bits, Lcs, us = 0, {d: [] for d in CDL_DETECTORS}, []
    for keys in dec_keys:
        errs, tot, Lc, u = run_cdl_detect_llrs(cfg, ebno_db, keys, calib)
        for d in CDL_DETECTORS:
            dec_errs[d] = dec_errs[d] + errs[d]
            Lcs[d].append(Lc[d])
        dec_bits += tot
        us.append(u)
    clock.mark("detect")
    u = torch.cat(us)
    dec = cdl_decode_counters(cfg, {d: torch.cat(v) for d, v in Lcs.items()},
                              u)
    clock.mark("decode")

    ints = lambda dct: {k: int(v) for k, v in dct.items()}       # noqa: E731
    counts = CdlCounts(
        bit_errors=ints(dec_errs), total_bits=dec_bits,
        info_errors=ints(dec["info_errors"]), total_info_bits=u.numel(),
        frame_errors=ints(dec["frame_errors"]),
        ldpc_iter_sum=ints(dec["iter_sum"]),
        ldpc_unconverged=ints(dec["unconv"]), ldpc_codewords=u.shape[0])
    return CdlSnrPoint(cal_bit_errors=ints(cal_errs), cal_total_bits=cal_bits,
                       counts=counts, calib=calib)
