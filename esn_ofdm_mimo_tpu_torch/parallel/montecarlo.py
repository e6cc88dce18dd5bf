"""Monte-Carlo SNR points and curves on one GPU (port of the single-device
part of esn_ofdm_mimo_tpu/parallel/montecarlo.py).

Calibrated CDL (`cdl_snr_point`, the JAX `_cdl_snr_point` as driven by
`make_fused_cdl_snr_step`):

    cal rounds     run_cdl_cal_blocks per round of G blocks: uncoded
                   counters + (llr, bit) calibration pairs
    calibrator fit fit_calibrators on the stacked pairs (per-bit GD)
    decode rounds  run_cdl_detect_llrs per round, then ONE
                   cdl_decode_counters on the round-stacked LLRs (per-codeword
                   decoding is independent, so this equals per-round decoding)

Block fading (`nbf_snr_point`, `run_nbf_curve`): rounds of run_nbf_blocks,
counters summed per SNR, per-SNR keys from block_keys(root, snr index,
global block ids) — the stream the JAX fused NBF grid folds on the device —
and `assemble_curve` into a `CurveResult`. The adaptive top-up,
checkpointing and multi-GPU are not ported yet.

The JAX `lax.scan` over rounds becomes a Python loop; the shard_map over a
device mesh has no counterpart (one GPU). Counters are summed in int64 — the
JAX package's int32 guard goes away — and returned as Python ints.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..config import SimConfig
from ..pipelines.blockfading import NbfCounts, run_nbf_blocks
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


def _host(x):
    """A counter leaf on the host: int, float, or an int64 numpy array."""
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if x.ndim > 0:
        return x.cpu().numpy().astype(np.int64)
    return float(x) if x.is_floating_point() else int(x)


def nbf_snr_point(cfg: SimConfig, ebno_db: float, keys, device=None,
                  timings: dict | None = None) -> NbfCounts:
    """Rounds of run_nbf_blocks at one Eb/N0, counters summed over rounds.

    keys (R, G, 2): per-block uint32 key data (numpy or tensors), as
    utils.rng.block_keys makes them. `device` defaults to "cuda" and raises
    without CUDA unless "cpu" is asked for. `timings`, when given, receives
    the wall ms of each phase summed over rounds (synth_fit, detect,
    decode, analytics). Returns NbfCounts of Python ints and floats, the
    histogram as an int64 numpy array."""
    dev = resolve_device(device)
    keys = rng.as_keys(keys, dev)
    clock = _PhaseClock(dev, timings)
    acc = None
    for bkeys in keys:
        c = run_nbf_blocks(cfg, ebno_db, bkeys, mark=clock.mark)
        acc = c if acc is None else NbfCounts(*(
            {k: x[k] + y[k] for k in x} if isinstance(x, dict) else x + y
            for x, y in zip(acc, c)))
    return NbfCounts(*(_host(x) for x in acc))


@dataclasses.dataclass
class CurveResult:
    """Assembled BER curves and channel analytics for one experiment."""
    ebno_db: np.ndarray
    ber: Dict[str, np.ndarray]          # uncoded, per detector
    ber_coded: Dict[str, np.ndarray]    # post-LDPC, per detector
    capacity_per_sc: np.ndarray
    frac_rank_full: np.ndarray
    cond_hist: np.ndarray               # (n_snr, nbins)
    total_bits: np.ndarray
    total_info_bits: np.ndarray
    n_blocks: np.ndarray
    # BP telemetry: mean iterations and the unconverged fraction
    ldpc_avg_iters: Dict[str, np.ndarray]
    ldpc_unconverged_frac: Dict[str, np.ndarray]


def run_nbf_curve(cfg: SimConfig, blocks_per_snr: int,
                  blocks_per_round: int = 4, seed: Optional[int] = None,
                  device=None) -> CurveResult:
    """The SNR sweep of a block-fading experiment at a fixed budget:
    blocks_per_snr rounded up to whole rounds of blocks_per_round blocks.
    Block keys are block_keys(PRNGKey(seed), snr index, 0 .. n - 1), the
    JAX package's stream, so the classical detectors draw the same blocks.
    """
    dev = resolve_device(device)
    G = blocks_per_round
    rounds = max(1, -(-blocks_per_snr // G))
    root = rng.prng_key(cfg.seed if seed is None else seed, dev)
    ebnos = np.asarray(cfg.ebno_db, dtype=np.float32)
    acc_per_snr = []
    for jj, ebno in enumerate(ebnos):
        keys = rng.block_keys(root, jj, torch.arange(rounds * G))
        acc_per_snr.append(nbf_snr_point(
            cfg, float(ebno), keys.reshape(rounds, G, 2), device=dev))
    return assemble_curve(cfg, ebnos, acc_per_snr)


def assemble_curve(cfg: SimConfig, ebnos, acc_per_snr) -> CurveResult:
    """Per-SNR host counters -> BER curves and channel analytics."""
    det = sorted(acc_per_snr[0].bit_errors)
    n = len(ebnos)
    ber = {d: np.zeros(n) for d in det}
    berc = {d: np.zeros(n) for d in det}
    avg_it = {d: np.zeros(n) for d in det}
    unconv = {d: np.zeros(n) for d in det}
    cap, frk, tot, toti, nblk = (np.zeros(n) for _ in range(5))
    chist = np.zeros((n, len(acc_per_snr[0].cond_hist)))
    for jj, acc in enumerate(acc_per_snr):
        tot[jj], toti[jj] = acc.total_bits, acc.total_info_bits
        nblk[jj] = acc.n_blocks
        ncw = max(acc.ldpc_codewords, 1)
        for d in det:
            ber[d][jj] = acc.bit_errors[d] / max(acc.total_bits, 1)
            berc[d][jj] = acc.info_errors[d] / max(acc.total_info_bits, 1)
            avg_it[d][jj] = acc.ldpc_iter_sum[d] / ncw
            unconv[d][jj] = acc.ldpc_unconverged[d] / ncw
        cap[jj] = acc.capacity_sum / max(acc.n_blocks, 1)
        frk[jj] = acc.rank_full_sum / max(acc.rank_count, 1)
        chist[jj] = acc.cond_hist
    return CurveResult(ebno_db=np.asarray(ebnos), ber=ber, ber_coded=berc,
                       capacity_per_sc=cap, frac_rank_full=frk,
                       cond_hist=chist, total_bits=tot, total_info_bits=toti,
                       n_blocks=nblk, ldpc_avg_iters=avg_it,
                       ldpc_unconverged_frac=unconv)
