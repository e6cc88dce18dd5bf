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

import os
import time
import traceback
from typing import NamedTuple, Tuple

import torch

from ..config import SimConfig
from ..ldpc import ldpc_decode_bp_counts, llr_from_yobs, make_code
from ..ops import est_sigma2_from_decision, qam_llrs_maxlog, \
    symbols_to_bits_hard
from ..utils import rng
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


def _cal_counters(cfg: SimConfig, ebno_db: float, bkeys: torch.Tensor):
    """The calibration round up to its uncoded counters: (code_bits (B, D,
    n_tx, n), X_hat detector -> (B, D, N, n_tx), bit errors detector -> int64
    scalar)."""
    _, code_bits, _, data = _detect(cfg, ebno_db, bkeys)
    return code_bits, data.X_hat, _uncoded_counts(
        code_bits, data.X_hat, cfg.ofdm.bits_per_symbol)


def run_cdl_cal_blocks(cfg: SimConfig, ebno_db: float, bkeys: torch.Tensor
                       ) -> CdlCalData:
    """Calibration phase: uncoded counts + (llr, bit) calibration data."""
    N, m = cfg.ofdm.n_subcarriers, cfg.ofdm.bits_per_symbol
    code_bits, X_hat, errs = _cal_counters(cfg, ebno_db, bkeys)
    B, D, n_tx = code_bits.shape[:3]
    return CdlCalData(
        bit_errors=errs, total_bits=code_bits.numel(),
        llr={name: _llrs_for(Xh, m) for name, Xh in X_hat.items()},
        bits=code_bits.reshape(B, D, n_tx, N, m))


class CalGraph(NamedTuple):
    """One calibration chunk captured as a CUDA graph
    (`run_cdl_cal_counters_chunks`): replaying it reads the chunk's keys
    from `keys` and adds its bit errors into `acc`."""
    key: tuple                  # (cfg, B, ebno_db, device, predict switch)
    graph: torch.cuda.CUDAGraph
    keys: torch.Tensor          # (B, 2) int64, the replay's input
    acc: dict                   # detector -> int64 scalar accumulator
    total_bits: int             # code bits of one chunk
    capture_ms: float           # the capture's host wall time
    pool_bytes: int             # device memory of the graph's pool


# the most recent capture; a call with another key releases it
_GRAPH: CalGraph | None = None


def _capture(cfg: SimConfig, ebno_db: float, first_keys: torch.Tensor,
             key: tuple) -> CalGraph:
    """Warm one eager chunk up on a side stream (the nvcc builds, cuFFT
    plans, the code's host construction, the kernels' attribute and
    occupancy queries, the device constants), then capture one chunk.
    Raises where the capture fails, naming the port's line that broke it."""
    dev = first_keys.device
    keys = first_keys.clone()
    acc = {name: torch.zeros((), dtype=torch.int64, device=dev)
           for name in CDL_DETECTORS}
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        code_bits, _, _ = _cal_counters(cfg, ebno_db, keys)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    try:
        with torch.cuda.graph(graph):
            # after the capture's own empty_cache: what the chunk reserves
            # from here on is the graph's private pool
            reserved = torch.cuda.memory_reserved(dev)
            _, _, errs = _cal_counters(cfg, ebno_db, keys)
            for name, a in acc.items():
                a.add_(errs[name])
            pool_bytes = torch.cuda.memory_reserved(dev) - reserved
    except Exception as e:
        here = [f for f in traceback.extract_tb(e.__traceback__)
                if f"{os.sep}esn_ofdm_mimo_tpu_torch{os.sep}" in f.filename]
        at = (f"{here[-1].filename}:{here[-1].lineno} ({here[-1].line})"
              if here else "outside the package")
        raise RuntimeError(f"CUDA graph capture of the calibration chunk "
                           f"failed at {at}: {e}") from e
    capture_ms = 1e3 * (time.perf_counter() - t0)
    return CalGraph(key=key, graph=graph, keys=keys, acc=acc,
                    total_bits=code_bits.numel(), capture_ms=capture_ms,
                    pool_bytes=pool_bytes)


def cal_graph(cfg: SimConfig, ebno_db: float, bkeys: torch.Tensor
              ) -> CalGraph:
    """The captured chunk of (cfg, B = bkeys.shape[0], ebno_db, the keys'
    card), captured on first use with `bkeys` as its warm-up keys. Only the
    most recent capture is kept: another key releases it, its graph and
    its memory pool first."""
    global _GRAPH
    dev = bkeys.device
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    key = (cfg, bkeys.shape[0], float(ebno_db), dev,
           os.environ.get("ESN_TPU_PREDICT_READOUT"))
    if _GRAPH is not None and _GRAPH.key == key:
        return _GRAPH
    if _GRAPH is not None:
        _GRAPH.graph.reset()
        _GRAPH = None
    with torch.cuda.device(dev):
        _GRAPH = _capture(cfg, float(ebno_db), bkeys.to(dev), key)
    return _GRAPH


def run_cdl_cal_counters_chunks(cfg: SimConfig, ebno_db: float, bkeys2d
                                ) -> Tuple[dict, int]:
    """Uncoded counters over R x B calibration blocks: bkeys2d (R, B, 2)
    keys -> (bit_errors: detector -> int64 scalar tensor, total_bits), the
    sums over the chunks r of `run_cdl_cal_blocks(cfg, ebno_db,
    bkeys2d[r])`'s. No LLRs are computed. The JAX package's
    detection-throughput path (its lax.scan over chunks, one traced
    program, counters accumulated on the device).

    CPU keys run the chunks one after another with the plain kernels. CUDA
    keys run one chunk captured as a CUDA graph (`cal_graph`, after one
    eager warm-up chunk) and replay it R times, copying chunk r's keys into
    its key buffer before replay r; nothing syncs the host until the caller
    reads the counters. The kernels' launch counters count the launches
    made from Python, the warm-up's and the capture's: a replay launches
    the captured kernels from the graph and adds nothing to them (a trace
    of the card counts those). A capture that fails raises: the card never
    falls back to an eager loop."""
    bkeys2d = rng.as_keys(bkeys2d)
    R = bkeys2d.shape[0]
    if bkeys2d.device.type == "cpu" or R == 0:
        errs = {name: torch.zeros((), dtype=torch.int64,
                                  device=bkeys2d.device)
                for name in CDL_DETECTORS}
        total = 0
        for r in range(R):
            code_bits, _, e = _cal_counters(cfg, ebno_db, bkeys2d[r])
            for name in errs:
                errs[name] += e[name]
            total += code_bits.numel()
        return errs, total
    g = cal_graph(cfg, ebno_db, bkeys2d[0])
    with torch.cuda.device(g.keys.device):
        for a in g.acc.values():
            a.zero_()
        for r in range(R):
            g.keys.copy_(bkeys2d[r])
            g.graph.replay()
        return ({name: a.clone() for name, a in g.acc.items()},
                R * g.total_bits)


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
