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
                     ebno_rows, row_view, synth_block)
# the graph machinery, which the CDL and block-fading pipelines share; its
# names stay importable from here
from .graphs import (Body, GraphCaptureError,  # noqa: F401
                     cached_graphs, capture_graph, graph_key,
                     graph_pool_bytes, release_graphs)

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


class CalGraph:
    """One calibration chunk captured as a CUDA graph
    (`run_cdl_cal_counters_chunks`): replaying it reads the Eb/N0 row from
    `row` and the chunk's keys from `keys`, and adds its bit errors into
    `acc`."""

    def __init__(self, cfg: SimConfig, ebno_db: float, first_keys):
        dev = first_keys.device
        self.cfg = cfg
        self.row = ebno_rows(cfg, (ebno_db,), dev)[0].clone()
        self.keys = first_keys.clone()          # (B, 2) int64
        self.acc = {name: torch.zeros((), dtype=torch.int64, device=dev)
                    for name in CDL_DETECTORS}
        B, D = first_keys.shape[0], cfg.data_symbols_per_block
        self.total_bits = (B * D * cfg.channel.n_tx * cfg.ofdm.n_subcarriers
                           * cfg.ofdm.bits_per_symbol)
        self.body = Body(self._chunk, "the calibration chunk", dev)
        self.capture_ms, self.pool_bytes = (self.body.capture_ms,
                                            self.body.pool_bytes)

    def _chunk(self):
        _, _, errs = _cal_counters(self.cfg, row_view(self.row), self.keys)
        for name, a in self.acc.items():
            a.add_(errs[name])

    def release(self):
        self.body.release()


def cal_graph(cfg: SimConfig, ebno_db: float, bkeys: torch.Tensor
              ) -> CalGraph:
    """The captured chunk of (cfg, B = bkeys.shape[0], the keys' card, the
    predict switch), captured on first use with `bkeys` as its warm-up keys
    at `ebno_db`; a replay reads the Eb/N0 from the graph's row buffer, so
    one capture serves every Eb/N0. Kept in the graph cache beside the
    fused CDL route's sets."""
    key = graph_key(cfg, bkeys.shape[0], bkeys.device, "chunk")
    return cached_graphs(key, lambda: CalGraph(key[1], float(ebno_db),
                                               bkeys.to(key[3])))


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
    eager warm-up chunk) and replay it R times, copying the Eb/N0 row into
    its row buffer and chunk r's keys into its key buffer before replay r;
    nothing syncs the host until the caller reads the counters. The
    kernels' launch counters count the launches made from Python, the
    warm-up's and the capture's: a replay launches the captured kernels
    from the graph and adds nothing to them (a trace of the card counts
    those). A capture that fails raises: the card never falls back to an
    eager loop."""
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
        g.row.copy_(ebno_rows(cfg, (ebno_db,), g.keys.device)[0])
        for a in g.acc.values():
            a.zero_()
        for r in range(R):
            g.keys.copy_(bkeys2d[r])
            g.body.run()
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


# the decode counters a CdlRounds set accumulates, in its dec_acc's rows
DEC_COUNTERS = ("bit_errors", "info_errors", "frame_errors", "iter_sum",
                "unconv")


class CdlRounds:
    """The calibrated point's bodies for rounds of G blocks on one device
    (the fused CDL route, parallel/montecarlo.py). Each body reads and
    writes only the buffers below, made before any capture:

        cal     row, keys -> cal_acc += uncoded errors; llr, bits = the
                round's raw (llr, bit) pairs, (S, m) a detector
        fit     the pairs stacked over Rc rounds -> calib (a, b) a
                detector (`fit_calibrators`); one body for each Rc, since
                the max_fit_samples stride depends on it
        detect  row, keys, calib -> dec_acc[bit_errors] += uncoded errors;
                Lc, u = the round's calibrated LLRs and info bits
        decode  Lc, u -> dec_acc[info/frame errors, iteration sum,
                unconverged] += K1's counts (`cdl_decode_counters`)

    Counters are int64 on the device, detectors in CDL_DETECTORS order. On
    the card each body is a CUDA graph captured on first use (after one
    eager call on a side stream, which warms up every first-use host step,
    K1's code tensors among them) and replayed; on the CPU it runs. A
    decode round is detect then decode: BP decodes each codeword alone,
    with its own exit, so decoding each round alone counts what one decode
    of the round-stacked LLRs counts."""

    def __init__(self, cfg: SimConfig, G: int, dev: torch.device):
        N, m = cfg.ofdm.n_subcarriers, cfg.ofdm.bits_per_symbol
        code = make_code(cfg.ldpc, N * m)
        n_det = len(CDL_DETECTORS)
        self.cfg, self.G, self.dev, self.m = cfg, G, dev, m
        ncw = G * cfg.data_symbols_per_block * cfg.channel.n_tx
        self.code_bits = ncw * code.n             # code bits of a round
        self.info_bits, self.codewords = ncw * code.k, ncw
        S = self.code_bits // m                   # (llr, bit) pairs a round

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.row = zeros(7)
        self.keys = zeros(G, 2, dtype=torch.int64)
        self.calib = zeros(n_det, 2, m)
        self.cal_acc = zeros(n_det, dtype=torch.int64)
        self.dec_acc = zeros(len(DEC_COUNTERS), n_det, dtype=torch.int64)
        self.llr, self.bits = zeros(n_det, S, m), zeros(S, m,
                                                        dtype=torch.int8)
        self.Lc = zeros(n_det, ncw, code.n)
        self.u = zeros(ncw, code.k, dtype=torch.int8)
        self.bodies, self.stacks = {}, {}

    def body(self, name: str, Rc: int = 0) -> Body:
        """The body `name` ("cal", "fit", "detect", "decode"; the fit's of
        Rc rounds), captured on first use from the buffers as they are."""
        key = (name, Rc) if name == "fit" else name
        if key not in self.bodies:
            fn = (self._fit_fn(Rc) if name == "fit"
                  else getattr(self, f"_{name}"))
            self.bodies[key] = Body(fn, f"the CDL {name} body", self.dev)
        return self.bodies[key]

    def stack(self, Rc: int):
        """(llr (n_det, Rc, S, m), bits (Rc, S, m)): the pairs of Rc
        calibration rounds, the fit's input."""
        if Rc not in self.stacks:
            self.stacks[Rc] = (
                self.llr.new_zeros((self.llr.shape[0], Rc)
                                   + self.llr.shape[1:]),
                self.bits.new_zeros((Rc,) + self.bits.shape))
        return self.stacks[Rc]

    def _calib(self) -> dict:
        return {d: (self.calib[i, 0], self.calib[i, 1])
                for i, d in enumerate(CDL_DETECTORS)}

    def _cal(self):
        out = run_cdl_cal_blocks(self.cfg, row_view(self.row), self.keys)
        for i, d in enumerate(CDL_DETECTORS):
            self.cal_acc[i].add_(out.bit_errors[d])
            self.llr[i].copy_(out.llr[d].reshape(-1, self.m))
        self.bits.copy_(out.bits.reshape(-1, self.m))

    def _fit_fn(self, Rc: int):
        llr, bits = self.stack(Rc)

        def fit():
            calib = fit_calibrators(
                self.cfg, {d: llr[i].reshape(-1, self.m)
                           for i, d in enumerate(CDL_DETECTORS)},
                bits.reshape(-1, self.m))
            for i, d in enumerate(CDL_DETECTORS):
                self.calib[i, 0].copy_(calib[d][0])
                self.calib[i, 1].copy_(calib[d][1])
        return fit

    def _detect(self):
        errs, _, Lcs, u = run_cdl_detect_llrs(
            self.cfg, row_view(self.row), self.keys, self._calib())
        for i, d in enumerate(CDL_DETECTORS):
            self.dec_acc[0, i].add_(errs[d])
            self.Lc[i].copy_(Lcs[d])
        self.u.copy_(u)

    def _decode(self):
        dec = cdl_decode_counters(
            self.cfg, {d: self.Lc[i] for i, d in enumerate(CDL_DETECTORS)},
            self.u)
        for j, f in enumerate(("info_errors", "frame_errors", "iter_sum",
                               "unconv"), start=1):
            for i, d in enumerate(CDL_DETECTORS):
                self.dec_acc[j, i].add_(dec[f][d])

    def cal_rounds(self, keys: torch.Tensor, clock=None):
        """Calibration rounds of keys (Rc, G, 2): cal_acc and the pairs
        stacked for the fit of Rc rounds (cal_acc is not zeroed)."""
        Rc = keys.shape[0]
        llr, bits = self.stack(Rc)
        for r in range(Rc):
            self.keys.copy_(keys[r])
            self.body("cal").run()
            llr[:, r].copy_(self.llr)
            bits[r].copy_(self.bits)
        if clock is not None:
            clock.mark("cal")

    def prepare_decode(self, keys: torch.Tensor):
        """Capture the detect and decode bodies where not yet, warmed up on
        the first round of keys (Rd, G, 2)."""
        self.keys.copy_(keys[0])
        self.body("detect")
        self.body("decode")

    def decode_rounds(self, keys: torch.Tensor, clock=None):
        """Decode rounds of keys (Rd, G, 2) with the calibrators in calib,
        adding into dec_acc (not zeroed)."""
        for r in range(keys.shape[0]):
            self.keys.copy_(keys[r])
            self.body("detect").run()
            if clock is not None:
                clock.mark("detect")
            self.body("decode").run()
            if clock is not None:
                clock.mark("decode")

    def point(self, cal_keys: torch.Tensor, dec_keys: torch.Tensor,
              clock=None):
        """One SNR point at the Eb/N0 in row: Rc calibration rounds, the
        fit, Rd decode rounds; the results in cal_acc, dec_acc and calib.
        The bodies of a first call are captured before the run, so their
        warm-up calls leave no trace in the results."""
        Rc = cal_keys.shape[0]
        self.keys.copy_(cal_keys[0])
        self.body("cal")
        self.body("fit", Rc)
        self.prepare_decode(dec_keys)
        self.cal_acc.zero_()
        self.dec_acc.zero_()
        self.cal_rounds(cal_keys, clock)
        self.body("fit", Rc).run()
        if clock is not None:
            clock.mark("fit")
        self.decode_rounds(dec_keys, clock)

    def capture_stats(self):
        """(the captures' host ms, bytes the pool grew by), summed."""
        return (sum(b.capture_ms for b in self.bodies.values()),
                sum(b.pool_bytes for b in self.bodies.values()))

    def release(self):
        for b in self.bodies.values():
            b.release()
        self.bodies.clear()
