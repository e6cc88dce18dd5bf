"""The frozen FLOP model of the benchmark: a copy of the program's
utils/flops.py as it stood when the benchmark was defined, so that a later
change to the program cannot move the count it is measured by. The
counting conventions:
The executed algebra is counted from the static config shapes; the
conventions are the JAX module's, so the two sets of counts compare:
  * one multiply-accumulate = 2 FLOPs; a real (M,K)@(K,N) dot = 2*M*K*N, a
    complex multiply-accumulate 8;
  * transcendentals (tanh, sigmoid, exp) count as 1 FLOP;
  * RNG draws, gathers/scatters, reshapes and bit ops count as 0.

Where the port runs the JAX package's algebra the count is the same: the
ESN harvest and predict recurrences (K3, K2), the 40-iteration
Newton-Schulz readout solve (models/esn.py:_readout_lstsq), BP's edge
updates, the calibrator fit and the encoder's GEMM. Where it runs other
algebra the count is the port's:
  * a DFT is `torch.fft` (cuFFT), counted as a radix-2 FFT, 5 L log2 L a
    complex row of length L; the JAX package runs it as four real matmuls,
    8 L^2 a row (its `fft_flops`);
  * the FIR channel is the direct tap loop of ops/channel.py:
    apply_fir_channel, a complex (n_rx, n_tx) @ (n_tx, T - k) product for
    every tap k (`fir_direct_flops`); the JAX package's is a zero-padded
    DFT product (its `fir_dft_flops`, which the port does not run);
  * the MMSE weights are a complex n_tx x n_tx LU solve with n_rx
    right-hand sides (ops/equalize.py:equalizer_weights); the JAX package
    factors the real 2n_tx x 2n_tx embedding by Cholesky.

At the flagship (mimo_4x8_cdl) a calibration round of 128 blocks,
`cdl_flops(cfg, 128).cal_counters`, is 318,408,976,554.7 FLOPs: ESN
predict 261.1 G, readout solve 44.9 G, encoder 5.0 G, harvest 3.4 G, the
FIR 2.8 G, the FFTs 0.7 G, the MMSE weights and their apply 0.3 G, then
Rapp, the demapper and the LS divide. The JAX count is 357.96 GFLOP: its
DFT matmuls (FFTs and FIR) make the difference.

All functions are pure Python arithmetic over a configuration object with
the fields of the program's SimConfig: nothing here touches torch or a
device. `nbf_round_flops` is the benchmark's own: one round of the
block-fading pipeline, composed from the same functions.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


# Per-edge FLOPs of one flooding BP iteration (ldpc/decode.py and the CUDA
# kernels run the JAX package's update):
#   sumprod: L_tot accumulate (2) + q form/clip (3) + tanh (1) +
#            leave-one-out product fwd/bwd (3) + clip (1) + arctanh (1) +
#            scale (1) + syndrome (2) = 14
#   minsum:  sign/abs bookkeeping + two-min reduction + scale + syndrome = 11
BP_FLOPS_PER_EDGE = {"sumprod": 14.0, "minsum": 11.0,
                     "offset-minsum": 12.0}

NS_ITERS = 40      # ops/linalg.ns_solver(iters=40), models/esn._readout_lstsq
NS_REFINE = 2      # ns_solver(..., refine=2)
RAPP_FLOPS = 10.0  # |x|, ratio, pow, div per sample (ops/pa.rapp_pa)


def dot(m: float, k: float, n: float = 1.0) -> float:
    """Real (m,k)@(k,n) matmul."""
    return 2.0 * m * k * n


def fft_flops(rows: float, length: float) -> float:
    """torch.fft.fft / ifft of `rows` complex rows of `length` points:
    5 L log2 L a row (the JAX package's DFT matmuls: 8 L^2 + 2 L)."""
    return 5.0 * rows * length * math.log2(length)


def fir_direct_flops(batch: float, n_tx: int, n_rx: int, T: int,
                     isi: int) -> float:
    """ops/channel.apply_fir_channel on `batch` waveforms of T samples: for
    each tap k a complex (n_rx, n_tx) @ (n_tx, T - k) product (8 FLOPs a
    complex multiply-accumulate), and for k >= 1 its complex add into the
    output's last T - k samples."""
    samples = isi * T - isi * (isi - 1) / 2.0      # sum over k of T - k
    return batch * n_rx * (8.0 * n_tx * samples + 2.0 * (samples - T))


def esn_states_flops(B: float, T: int, n_res: int, n_in: int,
                     n_out: int) -> float:
    """models/esn.esn_states (K3 runs the same algebra): the drive
    projection (input + teacher in one dot) + the (T-1)-step recurrence of
    (B,n_res)@(n_res,n_res) + tanh."""
    steps = T - 1
    drive = dot(B * steps, n_in + n_out, n_res)
    scan = steps * (dot(B, n_res, n_res) + B * n_res)
    return drive + scan


def esn_predict_flops(B: float, T: int, n_res: int, n_in: int,
                      n_out: int) -> float:
    """models/esn.esn_predict (K2 runs the same algebra): input drive +
    input-readout, then per step the state dot, feedback projection,
    grouped state readout, and tanh."""
    drive = dot(B * T, n_in, n_res) + dot(B * T, n_in, n_out)
    per_step = (dot(B, n_res, n_res) + dot(B, n_out, n_res)
                + dot(B, n_res, n_out) + B * n_res)
    return drive + T * per_step


def readout_lstsq_flops(B: float, R: int, F: int, n_out: int) -> float:
    """models/esn._readout_lstsq (the ridge Newton-Schulz solve). Dual form
    when F > R (the flagship: F = 316 features, R = 128 rows), primal
    otherwise; a Newton-Schulz iteration is 2 (n,n) matmuls, each of the two
    solve() calls 1 + 2*refine matmuls, plus the refinement's products of
    ext."""
    if F <= R:  # primal: F x F gram
        gram = 2.0 * B * R * F * F            # ext^T ext
        ns = NS_ITERS * 2.0 * 2.0 * B * F ** 3
        solve = 2 * (1 + 2 * NS_REFINE) * 2.0 * B * F * F * n_out
        rhs = 3 * dot(B * R, F, n_out)        # ext^T tgt + the refinement
        return gram + ns + solve + rhs
    # dual: R x R gram K = ext ext^T
    gram = 2.0 * B * R * R * F
    ns = NS_ITERS * 2.0 * 2.0 * B * R ** 3
    solve = 2 * (1 + 2 * NS_REFINE) * 2.0 * B * R * R * n_out
    # ext (ext^T z) in the refinement + the final ext^T z
    rhs = 3 * (2.0 * B * R * F * n_out)
    return gram + ns + solve + rhs


def equalizer_flops(B: float, N: int, n_tx: int, n_rx: int,
                    D: float) -> float:
    """ops/equalize.equalizer_weights + apply_equalizer: per (block,
    subcarrier) the complex Gram H^H H, the LU of the n_tx x n_tx system
    (n^3 / 3 complex multiply-accumulates) and its two triangular solves
    for the n_rx columns of H^H; then per data symbol W y (the JAX
    package's real-embedded Cholesky count gives way to this one)."""
    gram = 8.0 * n_tx * n_rx * n_tx
    lu = 8.0 * n_tx ** 3 / 3.0
    tri = 8.0 * n_tx * n_tx * n_rx        # forward + backward, n_rx columns
    weights = B * N * (gram + lu + tri)
    apply = 8.0 * B * D * N * n_tx * n_rx
    return weights + apply


def bp_decode_flops(n_cw: float, n: int, dv: int, max_iter: int,
                    algo: str = "sumprod") -> float:
    """Flooding BP at max_iter (the JAX package's count: every codeword
    runs to the cap)."""
    edges = float(n) * dv
    return n_cw * max_iter * edges * BP_FLOPS_PER_EDGE[algo]


def calib_fit_flops(m: int, S: float, gd_steps: int,
                    n_detectors: int = 2) -> float:
    """pipelines/cdl.fit_logreg_1d: per GD step over (m, S) LLRs: affine,
    sigmoid, residual, two gradient means ~ 10 FLOPs/sample."""
    return n_detectors * gd_steps * 10.0 * m * S


@dataclass(frozen=True)
class CdlFlops:
    """FLOPs of one B-block round of each flagship program (pipelines/cdl)."""
    synth: float          # synth_block: channel + pilot + chanest + ESN fit
    detect: float         # detect_data_symbols: TX/channel/ESN/MMSE per D syms
    llr: float            # _llrs_for both detectors
    encode: float         # data_bits_for_blocks LDPC encode
    decode: float         # calibrated-LLR BP decode, both detectors
    calib_apply: float    # per-bit affine + clip

    @property
    def cal_counters(self) -> float:
        """A chunk of run_cdl_cal_counters_chunks: no LLRs."""
        return self.synth + self.detect + self.encode

    @property
    def cal_full(self) -> float:
        """run_cdl_cal_blocks with the calibration LLRs."""
        return self.cal_counters + self.llr

    @property
    def decode_blocks(self) -> float:
        """run_cdl_decode_blocks: detection + LLR + calibrated decode."""
        return self.cal_full + self.calib_apply + self.decode


def cdl_flops(cfg, n_blocks: int) -> CdlFlops:
    """FLOPs of one B-block round of each flagship program.

    Models the CDL pipeline only (detectors esn + mmse, one SNR-matched ESN
    fit); the NBF pipelines run two fits and five detectors, which this
    model does not count, hence the guard."""
    if not cfg.calib.enabled or cfg.esn.train_ebno_fixed_db is not None:
        raise ValueError("cdl_flops models the calibrated CDL pipeline only")
    ofdm, ch, esn = cfg.ofdm, cfg.channel, cfg.esn
    N, m, isi, cp = (ofdm.n_subcarriers, ofdm.bits_per_symbol,
                     ofdm.isi_duration, ofdm.cp_len)
    n_tx, n_rx = ch.n_tx, ch.n_rx
    B = float(n_blocks)
    D = cfg.data_symbols_per_block
    T = N + cp
    delay = esn.shared_delay(isi)
    T_esn = T + delay
    n_in, n_out = 2 * n_rx, 2 * n_tx
    n_res = esn.n_reservoir
    F = n_res + n_in
    R = T_esn - (delay + cp)          # solve rows after n_forget discard

    # ---- synth_block ----
    synth = 0.0
    synth += fft_flops(B * n_rx * n_tx, N)               # taps -> H_true
    synth += 2 * (fft_flops(B * n_tx, N)                 # pilot x_cp, x_ls_cp
                  + RAPP_FLOPS * B * n_tx * T)
    synth += 2 * fir_direct_flops(B, n_tx, n_rx, T, isi)
    synth += fft_flops(B * n_rx, N)                      # demod Y_ls
    synth += 8.0 * B * n_rx * N                          # LS comb divide
    synth += 2 * fft_flops(B * n_rx * n_tx, N)           # MMSE TD refine
    synth += esn_states_flops(B, T_esn, n_res, n_in, n_out)
    synth += readout_lstsq_flops(B, R, F, n_out)

    # ---- detect_data_symbols (both flagship detectors: esn + mmse) ----
    BD = B * D
    det = 0.0
    det += fft_flops(BD * n_tx, N) + RAPP_FLOPS * BD * n_tx * T   # TX mod+PA
    det += fir_direct_flops(BD, n_tx, n_rx, T, isi)
    det += fft_flops(BD * n_rx, N)                       # demod
    det += esn_predict_flops(BD, T_esn, n_res, n_in, n_out)
    det += fft_flops(BD * n_tx, N)                       # ESN TD -> freq
    det += equalizer_flops(B, N, n_tx, n_rx, D)          # MMSE
    det += 4.0 * BD * n_tx * N * m * len(("esn", "mmse"))  # hard demap both

    # ---- LLRs (both detectors) ----
    llr = 2 * (6.0 * BD * n_tx * N            # decision-directed sigma^2
               + 8.0 * BD * n_tx * N * m)     # separable max-log PAM LLRs

    # ---- encode / decode / calibration ----
    n_code = N * m
    n_cw = BD * n_tx
    k = n_code // 2                            # rate-1/2 (dv=4, dc=8)
    encode = dot(n_cw, k, n_code - k)
    decode = 2 * bp_decode_flops(n_cw, n_code, cfg.ldpc.dv,
                                 cfg.ldpc.max_iter, cfg.ldpc.algo)
    calib_apply = 2 * 4.0 * n_cw * n_code      # affine+clip+yobs per bit

    return CdlFlops(synth=synth, detect=det, llr=llr, encode=encode,
                    decode=decode, calib_apply=calib_apply)


def cdl_point_flops(cfg, n_blocks: int, cal_rounds: int, dec_rounds: int,
                    fit_samples: int, bp_iterations: int) -> float:
    """One calibrated SNR point: `cal_rounds` rounds with their LLRs, the
    calibrator fit on `fit_samples` pairs a bit position, `dec_rounds`
    decode rounds, and BP at the iterations its codewords ran
    (`bp_iterations`, summed over the detectors and rounds), not at the
    cap."""
    fl = cdl_flops(cfg, n_blocks)
    n_code = cfg.ofdm.n_subcarriers * cfg.ofdm.bits_per_symbol
    f_fit = calib_fit_flops(cfg.ofdm.bits_per_symbol, fit_samples,
                            cfg.calib.gd_steps)
    f_decode = (float(bp_iterations) * n_code * cfg.ldpc.dv
                * BP_FLOPS_PER_EDGE[cfg.ldpc.algo])
    return (fl.cal_full * cal_rounds + f_fit
            + (fl.decode_blocks - fl.decode) * dec_rounds + f_decode)


def fit_samples(cfg, cal_rounds: int, n_blocks: int) -> int:
    """(LLR, bit) pairs a bit position that the calibrator fit takes: the
    cal rounds' B D n_tx N, stride-subsampled to calib.max_fit_samples
    (ceil(S / stride) kept)."""
    S = (cal_rounds * n_blocks * cfg.data_symbols_per_block
         * cfg.channel.n_tx * cfg.ofdm.n_subcarriers)
    cap = cfg.calib.max_fit_samples
    if cap is not None and S > cap:
        stride = -(-S // int(cap))
        S = -(-S // stride)
    return S


NBF_DETECTORS = 5          # esn, esn_fixed, zf_perfect, zf_ls, mmse


def nbf_round_flops(cfg, n_blocks: int, bp_iterations: int) -> float:
    """One round of the block-fading pipeline (pipelines/blockfading.py:
    run_nbf_blocks) on `n_blocks` blocks, composed from the functions
    above: the matched and the fixed-SNR ESN fits (harvest and readout
    solve each), the three pilot waveforms, both ESN detectors, ZF on the
    true and the LS channel and MMSE, the hard decisions of five
    detectors, the LLRs of every decode_every-th data symbol, the encoder
    of every data symbol, and BP at the iterations its codewords ran
    (`bp_iterations`, summed over the detectors). The SVD analytics count
    their Gram only (8 n_rx n_tx^2 a subcarrier): the Jacobi sweeps do
    work that depends on the data."""
    ofdm, ch, esn = cfg.ofdm, cfg.channel, cfg.esn
    N, m, isi, cp = (ofdm.n_subcarriers, ofdm.bits_per_symbol,
                     ofdm.isi_duration, ofdm.cp_len)
    n_tx, n_rx = ch.n_tx, ch.n_rx
    B = float(n_blocks)
    D = cfg.data_symbols_per_block
    Dd = len(range(0, D, cfg.ldpc.decode_every))
    T = N + cp
    delay = esn.shared_delay(isi)
    T_esn = T + delay
    n_in, n_out = 2 * n_rx, 2 * n_tx
    n_res = esn.n_reservoir
    F = n_res + n_in
    R = T_esn - (delay + cp)

    synth = fft_flops(B * n_rx * n_tx, N)                   # taps -> H_true
    synth += 3 * (fft_flops(B * n_tx, N) + RAPP_FLOPS * B * n_tx * T)
    synth += 3 * fir_direct_flops(B, n_tx, n_rx, T, isi)
    synth += fft_flops(B * n_rx, N) + 8.0 * B * n_rx * N    # demod, LS
    synth += 2 * fft_flops(B * n_rx * n_tx, N)              # MMSE refine
    synth += 2 * (esn_states_flops(B, T_esn, n_res, n_in, n_out)
                  + readout_lstsq_flops(B, R, F, n_out))

    BD = B * D
    det = fft_flops(BD * n_tx, N) + RAPP_FLOPS * BD * n_tx * T
    det += fir_direct_flops(BD, n_tx, n_rx, T, isi)
    det += fft_flops(BD * n_rx, N)
    det += 2 * (esn_predict_flops(BD, T_esn, n_res, n_in, n_out)
                + fft_flops(BD * n_tx, N))
    det += 3 * equalizer_flops(B, N, n_tx, n_rx, D)
    det += 4.0 * BD * n_tx * N * m * NBF_DETECTORS

    n_code = N * m
    k = n_code // 2
    llr = NBF_DETECTORS * (6.0 + 8.0 * m) * B * Dd * n_tx * N
    encode = dot(BD * n_tx, k, n_code - k)
    decode = (float(bp_iterations) * n_code * cfg.ldpc.dv
              * BP_FLOPS_PER_EDGE[cfg.ldpc.algo])
    svd = 8.0 * B * N * n_rx * n_tx * n_tx
    return synth + det + llr + encode + decode + svd
