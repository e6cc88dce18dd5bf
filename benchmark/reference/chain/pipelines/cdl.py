"""4x8 CDL-B coded/uncoded pipeline with per-bit LLR calibration (port of
esn_ofdm_mimo_tpu/pipelines/cdl.py; reference
Demo_MIMO_4x8_Sionna_CDL_ESN_v2.py):

  * uncoded BER on every data symbol (:450-456);
  * calibration blocks give (llr, bit) pairs per bit position (:476-482);
    per-bit logistic calibrators p = sigmoid(a*llr + b) are fit by
    full-batch gradient descent (:105-119, 513-523), or under
    CalibConfig(fit_method="newton") by damped Newton steps on the same
    penalised likelihood;
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
from ..utils import rng
from .common import (EbnoRow, data_bits_for_blocks, detect_data_symbols,
                     synth_block)
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


def _detect(cfg: SimConfig, ebno_db: float | EbnoRow, bkeys: torch.Tensor):
    N, m = cfg.ofdm.n_subcarriers, cfg.ofdm.bits_per_symbol
    code = make_code(cfg.ldpc, N * m)
    state = synth_block(cfg, ebno_db, bkeys)
    code_bits, info_bits = data_bits_for_blocks(
        cfg, bkeys, cfg.data_symbols_per_block, code)
    data = detect_data_symbols(cfg, state, ebno_db, bkeys, code_bits,
                               CDL_DETECTORS)
    return code, code_bits, info_bits, data


def _cal_counters(cfg: SimConfig, ebno_db: float | EbnoRow,
                  bkeys: torch.Tensor):
    """The calibration round up to its uncoded counters: (code_bits (B, D,
    n_tx, n), X_hat detector -> (B, D, N, n_tx), bit errors detector -> int64
    scalar)."""
    _, code_bits, _, data = _detect(cfg, ebno_db, bkeys)
    return code_bits, data.X_hat, _uncoded_counts(
        code_bits, data.X_hat, cfg.ofdm.bits_per_symbol)


def run_cdl_cal_blocks(cfg: SimConfig, ebno_db: float | EbnoRow,
                       bkeys: torch.Tensor) -> CdlCalData:
    """Calibration phase: uncoded counts + (llr, bit) calibration data.
    ebno_db a float or its EbnoRow (pipelines/common.py), as in every
    function of this module that takes one."""
    N, m = cfg.ofdm.n_subcarriers, cfg.ofdm.bits_per_symbol
    code_bits, X_hat, errs = _cal_counters(cfg, ebno_db, bkeys)
    B, D, n_tx = code_bits.shape[:3]
    return CdlCalData(
        bit_errors=errs, total_bits=code_bits.numel(),
        llr={name: _llrs_for(Xh, m) for name, Xh in X_hat.items()},
        bits=code_bits.reshape(B, D, n_tx, N, m))


def run_cdl_cal_counters_chunks(cfg: SimConfig, ebno_db: float, bkeys2d
                                ) -> Tuple[dict, int]:
    """Uncoded counters over R x B calibration blocks: bkeys2d (R, B, 2)
    keys -> (bit_errors: detector -> int64 scalar tensor, total_bits), the
    chunks one after another."""
    bkeys2d = rng.as_keys(bkeys2d)
    errs = {name: torch.zeros((), dtype=torch.int64, device=bkeys2d.device)
            for name in CDL_DETECTORS}
    total = 0
    for r in range(bkeys2d.shape[0]):
        code_bits, _, e = _cal_counters(cfg, ebno_db, bkeys2d[r])
        for name in errs:
            errs[name] += e[name]
        total += code_bits.numel()
    return errs, total


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


def fit_logreg_1d_newton(x: torch.Tensor, y: torch.Tensor, steps: int = 8,
                         l2: float = 1e-3, max_step: float = 8.0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The penalised likelihood of `fit_logreg_1d` (l2 on the slope only)
    minimised by `steps` Newton steps (JAX fit_logreg_1d_newton). Each step
    solves the 2 x 2 Hessian [[mean(w x^2) + l2, mean(w x)], [mean(w x),
    mean(w)]], w = p (1 - p), in closed form, clips the step to
    +-max_step, and keeps the best of the full step and three halvings by
    penalised NLL (or stays put), so a saturated start backtracks instead
    of overshooting. x, y (..., S) -> (a, b) of shape (...)."""
    xf, yf = x.to(torch.float32), y.to(torch.float32)
    a = torch.ones(x.shape[:-1], dtype=torch.float32, device=x.device)
    b = torch.zeros_like(a)

    def pnll(a, b):
        z = a[..., None] * xf + b[..., None]
        ce = (torch.clamp_min(z, 0.0) - yf * z
              + torch.log1p(torch.exp(-z.abs())))
        return ce.mean(-1) + 0.5 * l2 * a * a

    for _ in range(steps):
        p = torch.sigmoid(a[..., None] * xf + b[..., None])
        ga = ((p - yf) * xf).mean(-1) + l2 * a
        gb = (p - yf).mean(-1)
        w = p * (1.0 - p)
        haa = (w * xf * xf).mean(-1) + l2
        hab = (w * xf).mean(-1)
        hbb = w.mean(-1)
        det = torch.clamp_min(haa * hbb - hab * hab, 1e-12)
        da = torch.clamp((hbb * ga - hab * gb) / det, -max_step, max_step)
        db = torch.clamp((haa * gb - hab * ga) / det, -max_step, max_step)
        best_a, best_b, best_f = a, b, pnll(a, b)
        for t in (1.0, 0.5, 0.25, 0.125):
            ca, cb = a - t * da, b - t * db
            cf = pnll(ca, cb)
            take = cf < best_f
            best_a = torch.where(take, ca, best_a)
            best_b = torch.where(take, cb, best_b)
            best_f = torch.minimum(cf, best_f)
        a, b = best_a, best_b
    return a, b


def fit_calibrators(cfg: SimConfig, cal: dict, bits: torch.Tensor) -> dict:
    """cal: detector -> (S, m) LLRs; bits (S, m) -> detector -> (a, b),
    each (m,): `fit_logreg_1d_newton` where calib.fit_method is "newton",
    else `fit_logreg_1d`. Above calib.max_fit_samples per bit position a
    deterministic stride subsample feeds the fit."""
    cap = cfg.calib.max_fit_samples
    out = {}
    for name, llr in cal.items():
        x, y = llr.T, bits.T                                # (m, S)
        if cap is not None and x.shape[-1] > cap:
            stride = -(-x.shape[-1] // int(cap))
            x, y = x[..., ::stride], y[..., ::stride]
        if cfg.calib.fit_method == "newton":
            out[name] = fit_logreg_1d_newton(x, y, l2=cfg.calib.l2)
        else:
            out[name] = fit_logreg_1d(x, y, steps=cfg.calib.gd_steps,
                                      lr=cfg.calib.lr, l2=cfg.calib.l2)
    return out


def run_cdl_detect_llrs(cfg: SimConfig, ebno_db: float | EbnoRow,
                        bkeys: torch.Tensor, calib: dict):
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


def run_cdl_decode_blocks(cfg: SimConfig, ebno_db: float | EbnoRow,
                          bkeys: torch.Tensor, calib: dict) -> CdlCounts:
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
