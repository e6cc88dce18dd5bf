"""4x8 CDL-B coded/uncoded pipeline with per-bit LLR calibration (port of
esn_ofdm_mimo_tpu/pipelines/cdl.py; reference
Demo_MIMO_4x8_Sionna_CDL_ESN_v2.py):

  * uncoded BER on every data symbol (:450-456);
  * calibration blocks give (llr, bit) pairs per bit position (:476-482);
    per-bit logistic calibrators p = sigmoid(a*llr + b) are fit by
    full-batch gradient descent (:105-119, 513-523);
  * decode blocks run calibrated LLRs clip(-(a*llr + b), +-clip),
    y_obs = llr/2 and the pyldpc contract snr = 1 (:483-506) through BP.

Detectors are "esn" and "mmse" (CDL_DETECTORS). Counters are int64.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import SimConfig
from ..ldpc import ldpc_decode_bp_counts, llr_from_yobs, make_code
from ..ops import est_sigma2_from_decision, qam_llrs_maxlog, \
    symbols_to_bits_hard
from .common import data_bits_for_blocks, detect_data_symbols, synth_block

CDL_DETECTORS = ("esn", "mmse")


class CdlCalData(NamedTuple):
    bit_errors: dict            # uncoded code-bit errors per detector
    total_bits: int
    llr: dict                   # detector -> (B, D, n_tx, N, m) raw LLRs
    bits: torch.Tensor          # (B, D, n_tx, N, m) true code bits


class CdlCounts(NamedTuple):
    bit_errors: dict
    total_bits: int
    info_errors: dict
    total_info_bits: int
    frame_errors: dict          # codewords with any info-bit error
    # BP telemetry per detector: sum of per-codeword iterations (the cap for
    # unconverged codewords), unconverged codewords; codewords per detector
    ldpc_iter_sum: dict
    ldpc_unconverged: dict
    ldpc_codewords: int


def _llrs_for(Xh: torch.Tensor, m: int) -> torch.Tensor:
    """Raw max-log LLRs with the v2 script's stream-averaged sigma^2 (:459)."""
    z = Xh.transpose(-1, -2)                               # (B, D, n_tx, N)
    sigma2 = est_sigma2_from_decision(z, m).mean(-1)       # (B, D)
    return qam_llrs_maxlog(z, sigma2[..., None], m)        # (B, D, n_tx, N, m)


def _uncoded_counts(code_bits: torch.Tensor, X_hat: dict, m: int) -> dict:
    return {name: (symbols_to_bits_hard(Xh.transpose(-1, -2), m)
                   != code_bits).sum()
            for name, Xh in X_hat.items()}


def _detect(cfg: SimConfig, ebno_db: float, bkeys: torch.Tensor):
    N, m = cfg.ofdm.n_subcarriers, cfg.ofdm.bits_per_symbol
    code = make_code(cfg.ldpc, N * m)
    state = synth_block(cfg, ebno_db, bkeys)
    code_bits, info_bits = data_bits_for_blocks(
        cfg, bkeys, cfg.data_symbols_per_block, code)
    data = detect_data_symbols(cfg, state, ebno_db, bkeys, code_bits,
                               CDL_DETECTORS)
    return code, code_bits, info_bits, data


def run_cdl_cal_blocks(cfg: SimConfig, ebno_db: float, bkeys: torch.Tensor
                       ) -> CdlCalData:
    """Calibration phase: uncoded counts + (llr, bit) calibration data."""
    N, m = cfg.ofdm.n_subcarriers, cfg.ofdm.bits_per_symbol
    _, code_bits, _, data = _detect(cfg, ebno_db, bkeys)
    B, D, n_tx = code_bits.shape[:3]
    return CdlCalData(
        bit_errors=_uncoded_counts(code_bits, data.X_hat, m),
        total_bits=code_bits.numel(),
        llr={name: _llrs_for(Xh, m) for name, Xh in data.X_hat.items()},
        bits=code_bits.reshape(B, D, n_tx, N, m))


def fit_logreg_1d(x: torch.Tensor, y: torch.Tensor, steps: int = 400,
                  lr: float = 0.1, l2: float = 1e-3
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-bit 1-D logistic regression by full-batch GD (reference
    :108-119). x, y (..., S) -> (a, b) of shape (...)."""
    xf, yf = x.to(torch.float32), y.to(torch.float32)
    a = torch.ones(x.shape[:-1], dtype=torch.float32, device=x.device)
    b = torch.zeros_like(a)
    for _ in range(steps):
        p = torch.sigmoid(a[..., None] * xf + b[..., None])
        ga = ((p - yf) * xf).mean(-1) + l2 * a
        gb = (p - yf).mean(-1)
        a, b = a - lr * ga, b - lr * gb
    return a, b


def fit_calibrators(cfg: SimConfig, cal: dict, bits: torch.Tensor) -> dict:
    """cal: detector -> (S, m) LLRs; bits (S, m) -> detector -> (a, b),
    each (m,). Above calib.max_fit_samples per bit position a deterministic
    stride subsample feeds the fit."""
    if cfg.calib.fit_method != "gd":
        raise NotImplementedError(
            f"calibrator fit {cfg.calib.fit_method!r} is not ported yet")
    cap = cfg.calib.max_fit_samples
    out = {}
    for name, llr in cal.items():
        x, y = llr.T, bits.T                                # (m, S)
        if cap is not None and x.shape[-1] > cap:
            stride = -(-x.shape[-1] // int(cap))
            x, y = x[..., ::stride], y[..., ::stride]
        out[name] = fit_logreg_1d(x, y, steps=cfg.calib.gd_steps,
                                  lr=cfg.calib.lr, l2=cfg.calib.l2)
    return out


def run_cdl_detect_llrs(cfg: SimConfig, ebno_db: float, bkeys: torch.Tensor,
                        calib: dict):
    """Decode-phase detection: (uncoded errs dict, total_bits, Lc dict
    detector -> (ncw, n) calibrated channel LLRs, info_bits (ncw, k)),
    ncw = B*D*n_tx codewords."""
    N, m = cfg.ofdm.n_subcarriers, cfg.ofdm.bits_per_symbol
    code, code_bits, info_bits, data = _detect(cfg, ebno_db, bkeys)
    B, D, n_tx = code_bits.shape[:3]
    clip = cfg.ldpc.llr_clip
    Lcs = {}
    for name, Xh in data.X_hat.items():
        a, b = calib[name]
        llr_cal = torch.clamp(-(a * _llrs_for(Xh, m) + b), -clip, clip)
        y_obs = 0.5 * llr_cal.reshape(B, D, n_tx, N * m)
        Lcs[name] = llr_from_yobs(y_obs, snr_db=1.0).reshape(-1, N * m)
    return (_uncoded_counts(code_bits, data.X_hat, m), code_bits.numel(),
            Lcs, info_bits.reshape(-1, code.k))


def cdl_decode_counters(cfg: SimConfig, Lcs: dict, info_bits: torch.Tensor
                        ) -> dict:
    """One BP decode of all detectors' stacked LLRs (sorted name order):
    detector -> info errors, frame errors, iteration sum, unconverged."""
    N, m = cfg.ofdm.n_subcarriers, cfg.ofdm.bits_per_symbol
    code = make_code(cfg.ldpc, N * m)
    names = sorted(Lcs)
    ncw = Lcs[names[0]].shape[0]
    err, st = ldpc_decode_bp_counts(
        code, torch.cat([Lcs[n] for n in names]),
        torch.cat([info_bits] * len(names)), cfg.ldpc.max_iter,
        algo=cfg.ldpc.algo, minsum_scale=cfg.ldpc.minsum_scale,
        minsum_offset=cfg.ldpc.minsum_offset, schedule=cfg.ldpc.schedule,
        pass1_iters=cfg.ldpc.pass1_iters)
    out = {"info_errors": {}, "frame_errors": {}, "iter_sum": {},
           "unconv": {}}
    for i, name in enumerate(names):
        sl = slice(i * ncw, (i + 1) * ncw)
        out["info_errors"][name] = err[sl].sum(dtype=torch.int64)
        out["frame_errors"][name] = (err[sl] > 0).sum()
        out["iter_sum"][name] = st["iterations"][sl].sum(dtype=torch.int64)
        out["unconv"][name] = (~st["converged"][sl]).sum()
    return out


def run_cdl_decode_blocks(cfg: SimConfig, ebno_db: float, bkeys: torch.Tensor,
                          calib: dict) -> CdlCounts:
    """Decode phase for one batch: uncoded counts on every symbol and the
    calibrated-LLR decode of every codeword (reference :483-511)."""
    errs, total_bits, Lcs, u = run_cdl_detect_llrs(cfg, ebno_db, bkeys, calib)
    dec = cdl_decode_counters(cfg, Lcs, u)
    return CdlCounts(bit_errors=errs, total_bits=total_bits,
                     info_errors=dec["info_errors"], total_info_bits=u.numel(),
                     frame_errors=dec["frame_errors"],
                     ldpc_iter_sum=dec["iter_sum"],
                     ldpc_unconverged=dec["unconv"],
                     ldpc_codewords=u.shape[0])
