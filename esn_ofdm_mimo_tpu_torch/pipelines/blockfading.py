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
bound 2 * max_iter. With LdpcConfig.enabled False there is no code and no
decode: the data symbols carry raw bits and the coded counters stay 0, as
the JAX package fills them. Counters are int64 tensors on the batch's
device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SimConfig
from ..ldpc import ldpc_decode_bp_counts, llr_from_yobs, make_code
from ..ops import channel_svd_metrics, est_sigma2_from_decision, \
    qam_llrs_maxlog, symbols_to_bits_hard
from ..utils.metrics import check_finite
from .common import (DETECTORS, data_bits_for_blocks, detect_data_symbols,
                     link_budget, synth_block)

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


def decoded_symbol_indices(cfg: SimConfig) -> torch.Tensor:
    """Data-symbol indices that get LDPC-decoded: every decode_every-th
    (reference LDPC_DECODE_EVERY, OFDM_SISO_NBF_LDPC.py:202,389)."""
    return torch.arange(0, cfg.data_symbols_per_block, cfg.ldpc.decode_every)


def cond_histogram(cond: torch.Tensor) -> torch.Tensor:
    """Counts of `cond` over the edges [0, COND_BINS..., inf] with
    jnp.histogram's (numpy's) rule: half-open bins [e_i, e_{i+1}), the last
    closed; values outside the edges are not counted."""
    edges = torch.as_tensor(np.concatenate(
        [[0.0], COND_BINS, [np.inf]]).astype(np.float32), device=cond.device)
    x = cond.reshape(-1).to(torch.float32)
    idx = torch.bucketize(x, edges, right=True)     # searchsorted side=right
    idx = torch.where(x == edges[-1], edges.numel() - 1, idx)
    counts = torch.bincount(idx, minlength=edges.numel() + 1)
    return counts[1:edges.numel()]


def run_nbf_blocks(cfg: SimConfig, ebno_db: float, bkeys: torch.Tensor,
                   detectors=DETECTORS, mark=None, esn_over=None
                   ) -> NbfCounts:
    """Simulate one coherence block per key of bkeys (B, 2); return the
    counters (JAX run_nbf_blocks). `mark(phase)`, when given, is called as
    each phase ends: "synth_fit", "detect", "decode" (coded runs only),
    "analytics". `esn_over` replaces ESN hyperparameters
    (pipelines/common.py:synth_block)."""
    mark = mark or (lambda phase: None)
    ofdm, lc = cfg.ofdm, cfg.ldpc
    N, m = ofdm.n_subcarriers, ofdm.bits_per_symbol
    n_tx = cfg.channel.n_tx
    D = cfg.data_symbols_per_block
    lb = link_budget(cfg, ebno_db)
    dev = bkeys.device
    i64 = lambda v: torch.tensor(int(v), dtype=torch.int64,     # noqa: E731
                                 device=dev)

    code = make_code(lc, N * m) if lc.enabled else None
    state = synth_block(cfg, ebno_db, bkeys, esn_over)
    mark("synth_fit")
    code_bits, info_bits = data_bits_for_blocks(cfg, bkeys, D, code)
    data = detect_data_symbols(cfg, state, ebno_db, bkeys, code_bits,
                               detectors)

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
        sel = decoded_symbol_indices(cfg).to(dev)
        u_sel = info_bits[:, sel]                        # (B, Dd, n_tx, k)
        B, Dd = u_sel.shape[:2]
        cap = (lc.max_iter if ebno_db >= lc.low_snr_double_iter_below_db
               else 2 * lc.max_iter)
        names = sorted(data.X_hat)
        Lc_all = []
        for name in names:
            z = data.X_hat[name][:, sel].transpose(-1, -2)  # (B, Dd, n_tx, N)
            if lc.sigma2_mode == "true_no":
                sigma2 = torch.tensor(np.float32(ofdm.noise_psd), device=dev)
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
            algo=lc.algo, minsum_scale=lc.minsum_scale, iter_cap=cap,
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
    met = channel_svd_metrics(state.H_true, lb.pi, ofdm.noise_psd)
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
