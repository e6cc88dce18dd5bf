"""Typed configuration dataclasses: a frozen copy of the program's
config.py, with the same classes, fields and defaults, so the reference
builds its configuration from a configuration file's tree without the
program. The comments that speak of kernels describe the program's
routing; here every field selects plain PyTorch.

The reference keeps configuration as module-level constants in each script
(e.g. reference system_model_2/OFDM_SISO_NBF_LDPC.py:114-203) plus one
result-embedded meta dict (Demo_MIMO_4x8_Sionna_CDL_ESN_v2.py:565-585).
Here the same parameter surface is a frozen dataclass tree so that configs are
hashable and presets are plain constructors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class OfdmConfig:
    """OFDM modem parameters.

    Conventions (must match reference exactly, see SURVEY.md §2.3):
      TX time-domain signal  x = N * ifft(X); CP = last `cp` samples prepended
      RX frequency symbols   Y = (1/N) * fft(y[cp:])
    """
    n_subcarriers: int = 512          # N
    bits_per_symbol: int = 4          # m (16-QAM)
    bits_per_pilot_symbol: int = 4    # m_pilot
    isi_duration: int = 8             # channel memory in taps
    sample_rate_hz: float = 2 * 1.024e6   # W
    doppler_hz: float = 100.0         # f_D
    noise_psd: float = 1e-5           # No
    # explicit coherence length override (the SISO-AWGN demo trains once per
    # SNR point: one "block" spans the whole run)
    coherence_override: Optional[int] = None

    @property
    def cp_len(self) -> int:
        return self.isi_duration - 1

    @property
    def symbol_duration_s(self) -> float:
        # (N + IsiDuration - 1) / W, reference OFDM_SISO_NBF_LDPC.py:151
        return (self.n_subcarriers + self.isi_duration - 1) / self.sample_rate_hz

    @property
    def coherence_symbols(self) -> int:
        # L = floor((0.5/f_D) / T_OFDM_Total), reference :152-153
        if self.coherence_override is not None:
            return self.coherence_override
        tau_c = 0.5 / max(self.doppler_hz, 1e-9)
        return max(1, math.floor(tau_c / self.symbol_duration_s))


@dataclasses.dataclass(frozen=True)
class PaConfig:
    """Rapp power-amplifier soft clipping: x / (1+(|x|/A)^(2p))^(1/(2p)).

    A = sqrt(var_x) * 10^(clip_db/20), reference OFDM_SISO_NBF_LDPC.py:235.
    """
    smoothness: float = 1.0           # p_smooth
    clip_level_db: float = 3.0        # ClipLeveldB
    enabled: bool = True


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """Multipath channel model.

    kind="exp_pdp": one-sided exponential power-delay profile block fading
      (reference OFDM_SISO_NBF_LDPC.py:162-164, 272-279).
    kind="cdl_b": 3GPP TR 38.901 TDL-B 23-tap profile scaled to delay_spread_ns
      with linear fractional-delay splitting (Demo_MIMO_4x8_Sionna_CDL_ESN_v2.py:127-165).
    kind="cdl_a"/"cdl_c": TR 38.901 TDL-A / TDL-C profiles (Tables
      7.7.2-1/-3), same scaling/splitting — framework extensions; the
      reference only implements TDL-B.
    kind="awgn_flat": single random unit-magnitude complex tap
      (Demo_SISO_QPSK_AWGN_LDPC_ESN_with_ZF_LS.py:205-206).
    """
    kind: str = "exp_pdp"
    n_tx: int = 1
    n_rx: int = 1
    delay_spread_ns: float = 300.0    # CDL-B only
    # SISO-AWGN demo quirks (Demo_SISO_QPSK_AWGN...py:213-216,260-266):
    # scalar subcarrier-averaged LS estimate, and the MMSE/ZF equalizers use
    # the TRUE channel rather than an estimate
    flat_scalar_ls: bool = False


@dataclasses.dataclass(frozen=True)
class EsnConfig:
    """Echo-state-network detector hyperparameters.

    Matches the reference's pyESN usage (SURVEY.md §2.3 "ESN hyperparameters"):
    reservoir size 300 (600 for 4x8 @ N=512), spectral radius 0.9, sparsity 0.1,
    input_scaling = 0.005/sqrt(var_x), teacher_scaling 5e-7, state noise 1e-3,
    shared delay (min+max)//2 with max = ceil(isi/2)+2, nForget = delay + CP.
    """
    n_reservoir: int = 300
    spectral_radius: float = 0.9
    sparsity: float = 0.1
    noise: float = 1e-3
    input_scaler: float = 0.005
    input_offset: float = 0.0
    teacher_scaling: float = 5e-7
    # ESN training target waveform — THE root cause of the framework's ESN
    # curves beating the reference's (PARITY.md "ESN deviation"):
    #   "pre_pa" (parity/ablation mode) — the clean scaled TX waveform
    #     BEFORE the Rapp PA, exactly the reference's `x_CP` (the PA output
    #     `x_CP_NLD` enters the channel but NOT the trainer,
    #     Demo_MIMO_4x8_Sionna_CDL_ESN_v2.py:344,391; OFDM_SISO_NBF_LDPC.py
    #     :300,344; Demo_MIMO_2x2_all...:290,310): the ESN must jointly
    #     invert channel AND PA. Reproduces the reference's ESN curve
    #     (uncoded 11/11 in ±0.5 dB incl. the 0.155 floor,
    #     results/mimo_4x8_cdl_tpu_prepa).
    #   "post_pa" (default) — the PA output: an easier target (pure channel
    #     inversion; the mild deterministic clipping distortion passes
    #     through to the demapper instead of being inverted by a 300-unit
    #     reservoir). ~30% lower uncoded floor / up to 4x lower coded BER
    #     at high SNR than the reference. Default because the framework
    #     goal is match-or-beat; flip via --esn-target for parity runs.
    # Identical when the PA is disabled.
    target_waveform: str = "post_pa"
    min_delay: int = 0
    # max_delay defaults to ceil(isi_duration/2)+2 at pipeline level when None
    max_delay: Optional[int] = None
    train_ebno_fixed_db: Optional[float] = 12.0   # second, fixed-SNR-trained ESN
    # ESN recurrence matmul precision override. None (default) inherits the
    # process default (1-pass bf16 dot + the fused Pallas predict kernel,
    # validated BER-neutral down to the flagship's ~0.1 floors and ~25%
    # faster detect). A non-None value routes detect/fit onto the XLA scan
    # at that dot precision. Deep-floor presets need it: measured round 3
    # on TPU (SISO-QPSK-AWGN, 21 dB, 6.5M bits), the PALLAS predict kernel
    # floors the ESN at ~7.8e-4 uncoded BER — any code family, any data,
    # diffuse <=3 errs/symbol — while the XLA scan is clean at BOTH bf16
    # (15 errs) and f32 (16 errs) dot precision; the kernel's aggressive
    # whole-operand bf16 casts (drive/feedback/readout), not the recurrence
    # dot, carry the quantization. The flagship's ~0.1 floors sit far above
    # it, so the kernel stays the default elsewhere.
    recurrence_precision: Optional[str] = None
    # ESN randomness granularity:
    #   "batch" (default) — one reservoir draw + one state-noise stream
    #     shared by the local batch (pipelines/common.py module docstring):
    #     the recurrence is a single (B, n) @ (n, n) MXU matmul, but ESN
    #     counters are only *statistically* reproducible across device
    #     layouts (the classical detectors are always bit-identical).
    #   "block" — reservoir, fit- and detect-noise streams all fold from
    #     each block's own key: every counter is bit-identical for any
    #     sharding/batching (SURVEY.md §4 contract), at the cost of a
    #     batched (B, 1, n) @ (B, n, n) recurrence that re-streams B weight
    #     matrices from HBM per step (measured throughput cost: PARITY.md
    #     "ESN layout invariance").
    rng_mode: str = "batch"

    def resolved_max_delay(self, isi_duration: int) -> int:
        if self.max_delay is not None:
            return self.max_delay
        return int(math.ceil(isi_duration / 2) + 2)

    def shared_delay(self, isi_duration: int) -> int:
        # DelayFlag == 0 path: d = (min+max)//2  (helper_mimo_esn_generic.py:59-61)
        return (self.min_delay + self.resolved_max_delay(isi_duration)) // 2


@dataclasses.dataclass(frozen=True)
class LdpcConfig:
    """Regular Gallager LDPC code + BP decoding parameters.

    Reference: pyldpc make_ldpc(n=N*m, dv=4, dc=8, systematic, sparse) and the
    decode contract llr*1.5 clip ±20, y_obs=llr/2, snr=1.0
    (OFDM_SISO_NBF_LDPC.py:186-202, 477-499).
    """
    enabled: bool = True
    # code family: "gallager" = random ensemble draw (pyldpc-style, the
    # parity default); "qc" = quasi-cyclic girth-conditioned draw from the
    # same (dv, dc)-regular ensemble — identical rate, same-or-better BER
    # (girth >= 6 guaranteed), and BP decode routes via static cyclic
    # shifts, unlocking the fused Pallas decoder (ldpc/decode_pallas.py);
    # "pyldpc" = construction-faithful replica of pyldpc's make_ldpc
    # (legacy RandomState strips, BP on the FULL untrimmed row set —
    # ldpc/code.make_pyldpc_ldpc, VERDICT r02 #10 ablation family)
    family: str = "gallager"
    dv: int = 4
    dc: int = 8
    max_iter: int = 100
    low_snr_double_iter_below_db: float = 6.0   # DEC_MAXITER doubled below 6 dB
    llr_scale: float = 1.5
    llr_clip: float = 20.0
    decode_every: int = 4            # decode every k-th data symbol
    seed: int = 0                    # construction seed (host-side, cached)
    # pyldpc observation contract: y_obs = llr/2 in the NBF scripts (:483) but
    # y_obs = llr (unhalved) in the SISO-AWGN demo (Demo_SISO...:289-296)
    yobs_half: bool = True
    # noise variance for max-log LLRs: decision-directed (NBF/CDL) or the raw
    # noise PSD constant (SISO-AWGN demo uses sigma2 = No, Demo_SISO...:283)
    sigma2_mode: str = "decision"
    # BP check-node rule: "sumprod" = pyldpc's exact tanh rule (the parity
    # default); "minsum" = normalised min-sum (minsum_scale x second-min,
    # exact leave-one-out) — no transcendentals per iteration, the classic
    # hardware decoder, typically within 0.1-0.2 dB at rate 1/2;
    # "offset-minsum" = offset min-sum (max(second-min - minsum_offset, 0),
    # the λ-subtract variant — the standard next step when normalized
    # min-sum misses the parity band, VERDICT r04 #3; sweep in
    # tools/sweep_minsum_offset.py)
    algo: str = "sumprod"
    minsum_scale: float = 0.75
    # validated at the flagship waterfall (round-5 sweep + full-grid run:
    # β=0.625 passes the ±0.5 dB band where minsum@0.75 failed)
    minsum_offset: float = 0.625
    # BP update schedule: "flooding" = pyldpc's parallel updates (the parity
    # default); "layered" (QC family only) = serial-C row-layered sweeps —
    # converges in ~half the flooding iterations at equal-or-better BER
    # (measured: tools/bench_ldpc_sched.py on TPU). NOTE the measured
    # caveat: one layered sweep costs ~2.4x a flooding iteration inside the
    # fused kernel (the dv row updates serialise), so layered@K/2 is NOT a
    # wall-clock win over flooding@K on TPU — the straggler-compaction
    # two-pass below is the decode-time lever; flooding stays the default.
    schedule: str = "flooding"
    # Two-pass straggler compaction (Pallas QC decoder only): decode at a
    # small budget first, then stable-sort-pack the unconverged codewords
    # into dense tiles and re-run them from scratch at the full budget.
    # BIT-EXACT vs the single-pass decode (per-codeword BP trajectories are
    # deterministic; equality asserted in tests/test_ldpc_qc.py), it only
    # removes the iterations wasted by converged lanes sharing a tile with
    # a straggler. None disables.
    pass1_iters: Optional[int] = 16


@dataclasses.dataclass(frozen=True)
class CalibConfig:
    """Per-bit 1D logistic-regression LLR calibration (4x8 CDL pipeline).

    p(bit=1|llr) = sigmoid(a*llr + b), fit by full-batch GD
    (Demo_MIMO_4x8_Sionna_CDL_ESN_v2.py:105-119, 476-523).
    """
    enabled: bool = False
    cal_fraction: float = 0.3
    gd_steps: int = 400
    lr: float = 0.1
    l2: float = 1e-3
    # fit solver: "gd" = the reference's 400-step full-batch gradient
    # descent (parity default); "newton" = damped Newton-Raphson on the
    # SAME penalized logistic MLE — ~8 iterations instead of 400, so the
    # fit's sequential-step count (and with it the multi-chip model's
    # dominant 400-small-all-reduce term, docs/SCALING.md) drops ~50x.
    # Validated option: lands on the same optimum wherever GD@400 has
    # converged; kept off the parity default because GD@400's
    # early-stopping bias IS the reference's fit semantics on separated
    # high-SNR cal sets.
    fit_method: str = "gd"
    # cap on calibration samples per bit position entering the GD fit
    # (stride-subsampled when the stacked cal set is larger). The reference
    # fits on ~154k samples (30% of 1000 symbols x N x n_tx,
    # Demo_..._v2.py:476-482); large sharded runs stack 50-100x that, and
    # the full-batch fit is memory-bound (~160 ms at 9.7M samples vs ~14 ms
    # at 1M, tools/bench_decode_pieces.py) for no statistical gain (a, b
    # estimates tighten as 1/sqrt(S): 1M samples put their standard error
    # far below the run-to-run band). None = fit on everything.
    max_fit_samples: int | None = 1 << 20


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Top-level Monte-Carlo experiment configuration."""
    name: str = "siso_nbf"
    ofdm: OfdmConfig = OfdmConfig()
    pa: PaConfig = PaConfig()
    channel: ChannelConfig = ChannelConfig()
    esn: EsnConfig = EsnConfig()
    ldpc: LdpcConfig = LdpcConfig()
    calib: CalibConfig = CalibConfig()
    ebno_db: Tuple[float, ...] = tuple(float(x) for x in range(0, 31, 3))
    num_ofdm_symbols: int = 1000
    seed: int = 42

    @property
    def n_blocks(self) -> int:
        """Number of coherence blocks that cover num_ofdm_symbols.

        The reference's `kk % L == 1` schedule yields one pilot + (L-1) data
        symbols per block; we round up to whole blocks.
        """
        return max(1, math.ceil(self.num_ofdm_symbols / self.ofdm.coherence_symbols))

    @property
    def data_symbols_per_block(self) -> int:
        return self.ofdm.coherence_symbols - 1
