"""Block-fading (NBF) pipeline: uncoded and LDPC-coded errors of the ESN
(matched and fixed-training-SNR), perfect-CSI ZF, LS ZF and MMSE detectors,
and the channel's SVD analytics (port of
esn_ofdm_mimo_tpu/pipelines/blockfading.py; reference OFDM_SISO_NBF_LDPC.py
and its 1x2 / 2x2 / 4x8 clones, which differ only in n_tx, n_rx, N and the
reservoir).

One call simulates B coherence blocks at one Eb/N0 and returns counters:
uncoded bit errors on every data symbol, and on every `decode_every`-th one
the info-bit, frame and BP-iteration counts of ONE stacked decode of all
detectors' LLRs (sorted name order; per-codeword BP is independent of its
batch neighbours, so stacking changes nothing). The BP budget is max_iter,
doubled below `low_snr_double_iter_below_db`, as a runtime cap under the
bound 2 * max_iter: the JAX package's traced `jnp.where` on Eb/N0, here a
host int the caller picks (`bp_iter_cap`). With LdpcConfig.enabled False
there is no code and no decode: the data symbols carry raw bits and the
coded counters stay 0, as the JAX package fills them. Counters are int64
tensors on the batch's device.

The Eb/N0 is a float or its EbnoRow (pipelines/common.py): every scalar the
round derives from it, the analytics' Pi included, is read from the row, so
`NbfRounds` captures one round as a CUDA graph that serves every Eb/N0 with
the same BP cap (the fused NBF route, parallel/montecarlo.py).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SimConfig
from ..ldpc import ldpc_decode_bp_counts, llr_from_yobs, make_code
from ..ops import channel_svd_metrics, est_sigma2_from_decision, \
    qam_llrs_maxlog, symbols_to_bits_hard
from ..utils.device import device_constant
from ..utils.metrics import check_finite, span
from .common import (DETECTORS, EbnoRow, _as_row, data_bits_for_blocks,
                     detect_data_symbols, row_view, synth_block)
from .graphs import Body

# log10 bins of the condition-number histogram: edges [0, COND_BINS, inf]
COND_BINS = np.asarray([10.0 ** (i / 8.0) for i in range(0, 49)],
                       dtype=np.float32)


class NbfCounts(NamedTuple):
    bit_errors: dict          # detector -> uncoded code-bit errors
    total_bits: torch.Tensor
    info_errors: dict         # detector -> post-LDPC info-bit errors
    total_info_bits: torch.Tensor
    frame_errors: dict        # detector -> codewords with any info-bit error
    capacity_sum: torch.Tensor   # sum over blocks of mean capacity/subcarrier
    rank_full_sum: torch.Tensor  # (subcarrier, block) pairs of full rank
    rank_count: torch.Tensor
    cond_hist: torch.Tensor      # (len(COND_BINS) + 1,) histogram counts
    n_blocks: torch.Tensor
    ldpc_iter_sum: dict          # detector -> sum of per-codeword iterations
    ldpc_unconverged: dict       # detector -> codewords never converged
    ldpc_codewords: torch.Tensor  # decoded codewords per detector


def decoded_symbol_indices(cfg: SimConfig, device=None) -> torch.Tensor:
    """Data-symbol indices that get LDPC-decoded: every decode_every-th
    (reference LDPC_DECODE_EVERY, OFDM_SISO_NBF_LDPC.py:202,389)."""
    return torch.arange(0, cfg.data_symbols_per_block, cfg.ldpc.decode_every,
                        device=device)


def bp_iter_cap(cfg: SimConfig, ebno_db: float) -> int:
    """The BP iteration cap at `ebno_db`: max_iter, doubled below
    low_snr_double_iter_below_db (JAX blockfading.py:103)."""
    if isinstance(ebno_db, EbnoRow):
        raise ValueError("an EbnoRow carries no Eb/N0 the host can read: "
                         "give run_nbf_blocks the BP cap as iter_cap")
    lc = cfg.ldpc
    return (lc.max_iter if ebno_db >= lc.low_snr_double_iter_below_db
            else 2 * lc.max_iter)


def _cond_edges() -> np.ndarray:
    return np.concatenate([[0.0], COND_BINS, [np.inf]]).astype(np.float32)


def cond_histogram(cond: torch.Tensor) -> torch.Tensor:
    """Counts of `cond` over the edges [0, COND_BINS..., inf] with
    jnp.histogram's (numpy's) rule: half-open bins [e_i, e_{i+1}), the last
    closed; values outside the edges are not counted. A fixed-length
    index_add_ (torch.bincount would read its length on the host)."""
    edges = device_constant(_cond_edges, device=cond.device)
    x = cond.reshape(-1).to(torch.float32)
    idx = torch.bucketize(x, edges, right=True)     # searchsorted side=right
    idx = torch.where(x == edges[-1], edges.numel() - 1, idx)
    counts = torch.zeros(edges.numel() + 1, dtype=torch.int64,
                         device=cond.device)
    counts.index_add_(0, idx, torch.ones_like(idx))
    return counts[1:edges.numel()]


def run_nbf_blocks(cfg: SimConfig, ebno_db: float | EbnoRow,
                   bkeys: torch.Tensor, detectors=DETECTORS, mark=None,
                   esn_over=None, iter_cap: int | None = None) -> NbfCounts:
    """Simulate one coherence block per key of bkeys (B, 2); return the
    counters (JAX run_nbf_blocks). ebno_db a float or its EbnoRow on the
    keys' device; `iter_cap` the BP cap, by default `bp_iter_cap` of the
    float Eb/N0 (with a row of a coded config it must be given).
    `mark(phase)`, when given, is called as each phase ends: "synth",
    "esn_fit" (synth_block), "detect", "decode" (coded runs only),
    "analytics". `esn_over` replaces ESN hyperparameters
    (pipelines/common.py:synth_block)."""
    mark = mark or (lambda phase: None)
    ofdm, lc = cfg.ofdm, cfg.ldpc
    N, m = ofdm.n_subcarriers, ofdm.bits_per_symbol
    n_tx = cfg.channel.n_tx
    D = cfg.data_symbols_per_block
    dev = bkeys.device
    row = _as_row(cfg, ebno_db, dev, cfg.esn.input_scaler)

    def i64(v):
        return torch.full((), int(v), dtype=torch.int64, device=dev)

    code = make_code(lc, N * m) if lc.enabled else None
    if code is not None and iter_cap is None:
        iter_cap = bp_iter_cap(cfg, ebno_db)
    state = synth_block(cfg, ebno_db, bkeys, esn_over, mark=mark)
    code_bits, info_bits = data_bits_for_blocks(cfg, bkeys, D, code)
    data = detect_data_symbols(cfg, state, row, bkeys, code_bits, detectors)

    # ---- uncoded BER on every data symbol ----
    bit_errors = {name: (symbols_to_bits_hard(Xh.transpose(-1, -2), m)
                         != code_bits).sum()
                  for name, Xh in data.X_hat.items()}
    mark("detect")

    # ---- coded BER on every decode_every-th data symbol ----
    zero = {name: i64(0) for name in data.X_hat}
    info_errors, frame_errors = dict(zero), dict(zero)
    iter_sum, unconv = dict(zero), dict(zero)
    total_info = n_codewords = 0
    if code is not None:
        sel = decoded_symbol_indices(cfg, dev)
        u_sel = info_bits[:, sel]                        # (B, Dd, n_tx, k)
        B, Dd = u_sel.shape[:2]
        names = sorted(data.X_hat)
        Lc_all = []
        for name in names:
            z = data.X_hat[name][:, sel].transpose(-1, -2)  # (B, Dd, n_tx, N)
            if lc.sigma2_mode == "true_no":
                sigma2 = device_constant(np.float32, ofdm.noise_psd,
                                         device=dev)
            else:
                sigma2 = est_sigma2_from_decision(z, m)  # per stream
            llr = qam_llrs_maxlog(z, sigma2, m).reshape(B, Dd, n_tx, N * m)
            llr = torch.clamp(llr * lc.llr_scale, -lc.llr_clip, lc.llr_clip)
            y_obs = llr / 2.0 if lc.yobs_half else llr
            Lc_all.append(llr_from_yobs(y_obs, snr_db=1.0).reshape(-1, N * m))
        check_finite("the decode LLRs", *Lc_all)
        ncw = Lc_all[0].shape[0]
        err, st = ldpc_decode_bp_counts(
            code, torch.cat(Lc_all), torch.cat(
                [u_sel.reshape(-1, code.k)] * len(names)), 2 * lc.max_iter,
            algo=lc.algo, minsum_scale=lc.minsum_scale, iter_cap=iter_cap,
            schedule=lc.schedule, pass1_iters=lc.pass1_iters,
            minsum_offset=lc.minsum_offset)
        for i, name in enumerate(names):
            sl = slice(i * ncw, (i + 1) * ncw)
            info_errors[name] = err[sl].sum(dtype=torch.int64)
            frame_errors[name] = (err[sl] > 0).sum()
            iter_sum[name] = st["iterations"][sl].sum(dtype=torch.int64)
            unconv[name] = (~st["converged"][sl]).sum()
        total_info, n_codewords = u_sel.numel(), B * Dd * n_tx
        mark("decode")

    # ---- channel analytics from the true H (:369-384) ----
    met = channel_svd_metrics(state.H_true, row.pi, ofdm.noise_psd)
    full = min(cfg.channel.n_tx, cfg.channel.n_rx)
    counts = NbfCounts(
        bit_errors=bit_errors, total_bits=i64(code_bits.numel()),
        info_errors=info_errors, total_info_bits=i64(total_info),
        frame_errors=frame_errors,
        # in float64, exact for float32 terms: the sum does not depend on
        # how the blocks are cut into rounds and ranks
        capacity_sum=met.capacity_per_sc.to(torch.float64).sum(),
        rank_full_sum=(met.rank >= full).sum(),
        rank_count=i64(met.rank.numel()),
        cond_hist=cond_histogram(met.cond), n_blocks=i64(bkeys.shape[0]),
        ldpc_iter_sum=iter_sum, ldpc_unconverged=unconv,
        ldpc_codewords=i64(n_codewords))
    mark("analytics")
    return counts


# the per-detector counters an NbfRounds set accumulates, in det_acc's rows
NBF_DET_COUNTERS = ("bit_errors", "info_errors", "frame_errors",
                    "ldpc_iter_sum", "ldpc_unconverged")
# the round totals, in totals' slots
NBF_TOTALS = ("total_bits", "total_info_bits", "rank_full_sum", "rank_count",
              "n_blocks", "ldpc_codewords")


class NbfRounds:
    """The block-fading round's body for rounds of G blocks on one device
    (the fused NBF route, parallel/montecarlo.py). The body reads the Eb/N0
    row from `row` (7,) and the round's keys from `keys` (G, 2) and adds
    `run_nbf_blocks`'s counters into buffers made before any capture:
    det_acc (5, n_det) int64 (NBF_DET_COUNTERS x the detectors: DETECTORS,
    "esn_fixed" only with a fixed training Eb/N0), totals
    (6,) int64 (NBF_TOTALS), capacity_sum float64, cond_hist (50,) int64.

    The counters are this rank's where a layout of several ranks runs the
    rounds: the caller sums `accs` over the ranks after a call's rounds,
    outside the graphs (parallel/montecarlo.py).

    There is one body for each BP cap (max_iter and 2 * max_iter; None for
    an uncoded config), made on first use. On the card it is a CUDA graph
    captured after one eager call on a side stream and replayed; on the CPU
    it runs eagerly with the kernels' plain versions. Every cap's body is
    named `nbf.round` (pipelines/graphs.py: its spans and record)."""

    def __init__(self, cfg: SimConfig, G: int, dev: torch.device):
        self.cfg, self.G, self.dev = cfg, G, dev
        self.dets = tuple(d for d in DETECTORS if d != "esn_fixed"
                          or cfg.esn.train_ebno_fixed_db is not None)

        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.row = zeros(7, dtype=torch.float32)
        self.keys = zeros(G, 2)
        self.det_acc = zeros(len(NBF_DET_COUNTERS), len(self.dets))
        self.totals = zeros(len(NBF_TOTALS))
        self.capacity_sum = zeros(dtype=torch.float64)
        self.cond_hist = zeros(len(COND_BINS) + 1)
        self.accs = (self.det_acc, self.totals, self.capacity_sum,
                     self.cond_hist)
        self.bodies = {}

    def body(self, cap: int | None) -> Body:
        """The body of BP cap `cap`, captured on first use from the buffers
        as they are (its warm-up adds into the accumulators: zero them
        after)."""
        if cap not in self.bodies:
            self.bodies[cap] = Body(
                lambda mark=None: self._round(cap, mark), "nbf.round",
                self.dev)
        return self.bodies[cap]

    def _round(self, cap, mark=None):
        c = run_nbf_blocks(self.cfg, row_view(self.row), self.keys,
                           mark=mark, iter_cap=cap)
        if tuple(c.bit_errors) != self.dets:
            raise ValueError(f"the round counted {tuple(c.bit_errors)}, "
                             f"not {self.dets}")
        for j, f in enumerate(NBF_DET_COUNTERS):
            for i, d in enumerate(self.dets):
                self.det_acc[j, i].add_(getattr(c, f)[d])
        for j, f in enumerate(NBF_TOTALS):
            self.totals[j].add_(getattr(c, f))
        self.capacity_sum.add_(c.capacity_sum)
        self.cond_hist.add_(c.cond_hist)

    def zero(self):
        for t in self.accs:
            t.zero_()

    def rounds(self, keys: torch.Tensor, cap: int | None):
        """Rounds of keys (R, G, 2) at the Eb/N0 in row with BP cap `cap`:
        the accumulators zeroed, then one replay a round (the body captured
        first, warmed up on the first round's keys)."""
        with span("mc.stage"):
            self.keys.copy_(keys[0])
        body = self.body(cap)
        self.zero()
        for r in range(keys.shape[0]):
            with span("mc.stage"):
                self.keys.copy_(keys[r])
            body.run()

    def counts(self, det_acc=None, totals=None, capacity_sum=None,
               cond_hist=None) -> NbfCounts:
        """NbfCounts of the given packed counters, by default clones of the
        accumulators: tensors give tensor views, host values (nested lists,
        ints, a float, a numpy histogram) give host values."""
        if det_acc is None:
            det_acc, totals, capacity_sum, cond_hist = (
                t.clone() for t in self.accs)

        def per(j):
            return {d: det_acc[j][i] for i, d in enumerate(self.dets)}

        tot = dict(zip(NBF_TOTALS, totals))
        return NbfCounts(
            bit_errors=per(0), total_bits=tot["total_bits"],
            info_errors=per(1), total_info_bits=tot["total_info_bits"],
            frame_errors=per(2), capacity_sum=capacity_sum,
            rank_full_sum=tot["rank_full_sum"],
            rank_count=tot["rank_count"], cond_hist=cond_hist,
            n_blocks=tot["n_blocks"], ldpc_iter_sum=per(3),
            ldpc_unconverged=per(4), ldpc_codewords=tot["ldpc_codewords"])

    def capture_stats(self):
        """(the captures' host ms, bytes the pool grew by), summed."""
        return (sum(b.capture_ms for b in self.bodies.values()),
                sum(b.pool_bytes for b in self.bodies.values()))

    def release(self):
        for b in self.bodies.values():
            b.release()
        self.bodies.clear()
