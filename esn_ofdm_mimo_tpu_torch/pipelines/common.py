"""Shared coherence-block machinery (port of
esn_ofdm_mimo_tpu/pipelines/common.py).

One coherence block = channel draw + pilot symbol + ESN training + D data
symbols (the reference's `kk % L == 1` schedule, OFDM_SISO_NBF_LDPC.py:270).
B blocks run as one batch: keys (B, 2) give each block its own taps, bits
and noise through the key-compatible RNG (utils/rng.py), so every per-block
draw equals the JAX package's at the same keys. Under EsnConfig.rng_mode
"batch" (the default), as there, the ESN reservoir and its state-noise
streams are shared by the batch and tied to its first key. Under "block"
each block draws its reservoir from fold_in(its key, _K_RESERVOIR) and
seeds its fits and detections from its own folded keys, and runs its ESN
alone (models/esn_mimo.py, the *_per_block functions): the counters then do
not depend on how the blocks are cut into rounds or ranks.

The link budget (var_x, Pi, sqrt(Pi), A_clip, No/Pi) is evaluated in
float32, as the JAX package evaluates it with a traced float32 Eb/N0.
`synth_block` and `detect_data_symbols` read every scalar they derive from
Eb/N0 from an `EbnoRow`: 0-d float32 tensors on the blocks' device (views
of one small tensor), made on the host as `link_budget` makes its floats.
Given a float they build the row themselves (`ebno_row`); given a row they
read it where it lies, so a CUDA graph captured with a row buffer serves
every Eb/N0 (parallel/montecarlo.py, the fused CDL route).

Channels: exp_pdp (block fading), cdl_a/b/c and awgn_flat (the SISO-AWGN
preset: one unit-magnitude tap of random phase, with its scalar LS estimate
under ChannelConfig.flat_scalar_ls). Detectors: "esn" (matched ESN),
"esn_fixed" (ESN trained at EsnConfig.train_ebno_fixed_db), "zf_perfect" (ZF
on the true channel), "zf_ls" (ZF on the LS estimate), "mmse".
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import SimConfig
from ..ldpc import ldpc_encode
from ..models.esn import (EsnReservoir, EsnScale, init_reservoir,
                          key_seed_tensor)
from ..models.esn_mimo import (esn_detect_symbols,
                               esn_detect_symbols_per_block, stack_reservoirs,
                               train_mimo_esn, train_mimo_esn_per_block)
from ..ops import (apply_fir_channel, awgn, bits_to_symbols,
                   draw_exp_pdp_taps, draw_flat_awgn_tap, draw_tdl_taps,
                   estimate_channel, ofdm_demodulate, ofdm_modulate,
                   taps_to_freq_response)
from ..ops.equalize import apply_equalizer, equalizer_weights
from ..ops.pa import clip_amplitude, rapp_pa
from ..utils import rng
from ..utils.device import device_constant

# purpose tags folded into block keys (the JAX package's values)
_K_CHAN, _K_PBITS, _K_PNOISE, _K_ESNFIT = 1, 2, 3, 5
_K_PNOISE_F, _K_ESNFIT_F, _K_DBITS, _K_DNOISE, _K_DETECT = 6, 7, 8, 9, 10
_K_RESERVOIR = 11

DETECTORS = ("esn", "esn_fixed", "zf_perfect", "zf_ls", "mmse")


def _vbits(keys: torch.Tensor, shape) -> torch.Tensor:
    """Per-block random bits: keys (B, 2) -> (B, *shape) int8."""
    return rng.bernoulli(keys, 0.5, shape).to(torch.int8)


class LinkBudget(NamedTuple):
    var_x: float
    pi: float
    sqrt_pi: float
    a_clip: float


class EbnoRow(NamedTuple):
    """Every scalar a coherence block derives from its Eb/N0, each a 0-d
    float32 tensor: var_x, Pi, sqrt(Pi), the Rapp clip A_clip, the matched
    ESN's input scaling input_scaler / sqrt(var_x), the TD-MMSE scaler
    (No/Pi)/(N/2) and the LMMSE load No/Pi. Each value is bit-identical to
    the float `link_budget` and the block functions computed from it."""
    var_x: torch.Tensor
    pi: torch.Tensor
    sqrt_pi: torch.Tensor
    a_clip: torch.Tensor
    input_scaling: torch.Tensor
    mmse_scaler: torch.Tensor
    no_over_pi: torch.Tensor


def _row_values(noise_psd: float, n_subcarriers: int, clip_level_db: float,
                input_scaler: float, ebnos: tuple) -> np.ndarray:
    """The rows of the Eb/N0s `ebnos`, (len(ebnos), 7) float32, in numpy
    float32 arithmetic."""
    No, N = np.float32(noise_psd), np.float32(n_subcarriers)
    rows = []
    for ebno_db in ebnos:
        var_x = (np.float32(10.0) ** (np.float32(ebno_db) / np.float32(10.0))
                 * No * N)
        pi = var_x / N
        rows.append((var_x, pi, np.sqrt(pi),
                     clip_amplitude(var_x, clip_level_db),
                     np.float32(input_scaler) / np.sqrt(var_x),
                     No / pi / np.float32(n_subcarriers / 2.0), No / pi))
    return np.asarray(rows, dtype=np.float32)


def ebno_rows(cfg: SimConfig, ebnos, device=None,
              input_scaler: float | None = None) -> torch.Tensor:
    """The rows of several Eb/N0s as one (len(ebnos), 7) float32 tensor on
    `device`, in EbnoRow's field order, made once per device and kept
    (utils/device.py:device_constant): a row a captured round reads is a
    device-to-device copy from it. `input_scaler` replaces the config's
    (synth_block's esn_over)."""
    scaler = cfg.esn.input_scaler if input_scaler is None else input_scaler
    return device_constant(
        _row_values, float(cfg.ofdm.noise_psd), int(cfg.ofdm.n_subcarriers),
        float(cfg.pa.clip_level_db), float(scaler),
        tuple(float(e) for e in ebnos), device=device)


def ebno_row(cfg: SimConfig, ebno_db: float, device=None,
             input_scaler: float | None = None) -> EbnoRow:
    """The row of one Eb/N0 on `device` (views of `ebno_rows`'s tensor)."""
    return row_view(ebno_rows(cfg, (ebno_db,), device, input_scaler)[0])


def row_view(values: torch.Tensor) -> EbnoRow:
    """An EbnoRow of views of a (7,) float32 tensor."""
    return EbnoRow(*values.unbind(0))


def _as_row(cfg: SimConfig, ebno_db, device, input_scaler: float
            ) -> EbnoRow:
    """`ebno_db` as a row on `device`: a float's row, or the row given."""
    if not isinstance(ebno_db, EbnoRow):
        return ebno_row(cfg, ebno_db, device, input_scaler)
    if float(input_scaler) != float(cfg.esn.input_scaler):
        raise ValueError("an EbnoRow carries the config's ESN input scaling; "
                         "pass the Eb/N0 as a float with an input_scaler "
                         "override")
    return ebno_db


def link_budget(cfg: SimConfig, ebno_db: float) -> LinkBudget:
    var_x, pi, sqrt_pi, a_clip = _row_values(
        cfg.ofdm.noise_psd, cfg.ofdm.n_subcarriers, cfg.pa.clip_level_db,
        cfg.esn.input_scaler, (ebno_db,))[0, :4]
    return LinkBudget(float(var_x), float(pi), float(sqrt_pi), float(a_clip))


def fixed_link_budget(cfg: SimConfig) -> LinkBudget:
    """The budget at the fixed ESN training Eb/N0, a static float the JAX
    package evaluates in double before its float32 sqrt (:233-235)."""
    No, N = cfg.ofdm.noise_psd, cfg.ofdm.n_subcarriers
    var_f = 10.0 ** (cfg.esn.train_ebno_fixed_db / 10.0) * No * N
    pi_f = np.float32(var_f / N)
    return LinkBudget(float(np.float32(var_f)), float(pi_f),
                      float(np.sqrt(pi_f)),
                      clip_amplitude(var_f, cfg.pa.clip_level_db))


def _f32(x) -> float:
    return float(np.float32(x))


class BlockState(NamedTuple):
    """What the data symbols need from their coherence block (batch B)."""
    taps: torch.Tensor        # (B, n_rx, n_tx, isi)
    H_true: torch.Tensor      # (B, N, n_rx, n_tx)
    H_ls: torch.Tensor        # (B, N, n_rx, n_tx)
    H_mmse: torch.Tensor      # (B, N, n_rx, n_tx)
    reservoir: EsnReservoir   # shared across the batch; rng_mode "block":
    #                           one a block (weights with a leading B axis)
    scale_m: EsnScale         # SNR-matched input scaling
    scale_f: EsnScale | None  # fixed-training-SNR scaling (None if off)
    Wt_out_m: torch.Tensor    # (B, F, 2*n_tx) matched readout
    Wt_out_f: torch.Tensor | None  # fixed-SNR readout


def _per_block(cfg: SimConfig) -> bool:
    """Whether the ESN runs one block at a time (rng_mode "block")."""
    if cfg.esn.rng_mode not in ("batch", "block"):
        raise ValueError(f"unknown esn rng_mode {cfg.esn.rng_mode!r}")
    return cfg.esn.rng_mode == "block"


def _draw_taps(cfg: SimConfig, keys: torch.Tensor) -> torch.Tensor:
    ch, ofdm = cfg.channel, cfg.ofdm
    if ch.kind == "exp_pdp":
        return draw_exp_pdp_taps(keys, ch.n_rx, ch.n_tx, ofdm.isi_duration)
    if ch.kind in ("cdl_a", "cdl_b", "cdl_c"):
        return draw_tdl_taps(keys, ch.n_rx, ch.n_tx, ofdm.isi_duration,
                             ofdm.sample_rate_hz, ch.delay_spread_ns,
                             profile=ch.kind[-1])
    if ch.kind == "awgn_flat":
        return draw_flat_awgn_tap(keys, ch.n_rx, ch.n_tx)
    raise ValueError(f"unknown channel kind {ch.kind}")


def _tx_chain(cfg: SimConfig, X: torch.Tensor, lb: LinkBudget | EbnoRow
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frequency symbols (..., n_tx, N) -> (PA output, clean scaled TD
    waveform), each (..., n_tx, N + cp); `lb` a budget of floats or a
    row."""
    x_clean = ofdm_modulate(X, cfg.ofdm.cp_len) * lb.sqrt_pi
    x_cp = (rapp_pa(x_clean, lb.a_clip, cfg.pa.smoothness)
            if cfg.pa.enabled else x_clean)
    return x_cp, x_clean


def _esn_target(cfg: SimConfig, x_cp, x_clean):
    mode = cfg.esn.target_waveform
    if mode == "pre_pa":
        return x_clean
    if mode == "post_pa":
        return x_cp
    raise ValueError(f"unknown esn target_waveform {mode!r}")


# the ESN hyperparameters `synth_block`'s esn_over may replace
ESN_OVERRIDES = ("spectral_radius", "sparsity", "noise", "input_scaler",
                 "teacher_scaling")


def synth_block(cfg: SimConfig, ebno_db: float | EbnoRow,
                bkeys: torch.Tensor, esn_over: dict | None = None,
                return_pilot: bool = False, mark=None):
    """Channel draw, pilot synthesis, channel estimation and ESN training
    for B blocks (reference OFDM_SISO_NBF_LDPC.py:270-384). bkeys (B, 2);
    ebno_db a float or its EbnoRow on the keys' device.
    With EsnConfig.train_ebno_fixed_db set, a second ESN is trained on the
    same pilot re-synthesised at that Eb/N0 (:347-357, detector
    "esn_fixed").

    esn_over: ESN hyperparameters (keys of ESN_OVERRIDES) that replace the
    config's, as in the JAX package: the reservoir draw takes the spectral
    radius, sparsity and noise, both fits the input scaler, the matched fit
    alone the teacher scaling; the input shift stays the config's.

    return_pilot: also return the pilot's waveforms (y_cp, x_tgt), the
    received pilot and the teacher the ESN trained on (the reference
    trains every zoo model on them, Demo_MIMO_2x2_all_DL_model_comparion.py
    :310), as (BlockState, (y_cp, x_tgt)).

    mark(phase), when given, is called as "synth" ends (channel, pilots,
    estimates, reservoir draw) and as "esn_fit" ends (K3 and the readout
    solve of each fit)."""
    mark = mark or (lambda phase: None)
    per_block = _per_block(cfg)
    ofdm, esn_cfg, ch = cfg.ofdm, cfg.esn, cfg.channel
    N, cp, isi = ofdm.n_subcarriers, ofdm.cp_len, ofdm.isi_duration
    n_tx, n_rx, mp = ch.n_tx, ch.n_rx, ofdm.bits_per_pilot_symbol
    T = N + cp
    ov = esn_over or {}
    unknown = set(ov) - set(ESN_OVERRIDES)
    if unknown:
        raise ValueError(f"unknown ESN overrides {sorted(unknown)}")
    hyper = {k: float(ov.get(k, getattr(esn_cfg, k))) for k in ESN_OVERRIDES}
    lb = _as_row(cfg, ebno_db, bkeys.device, hyper["input_scaler"])

    chan_keys = rng.fold_in(bkeys, _K_CHAN)
    # block mode draws each block's taps alone: the TDL draw's matmul folds
    # the blocks into its rows, and on the card the kernel it runs, and so
    # its summation order, depends on their number
    taps = (torch.cat([_draw_taps(cfg, k[None]) for k in chan_keys])
            if per_block else _draw_taps(cfg, chan_keys))
    H_true = taps_to_freq_response(taps, N)

    pbits = _vbits(rng.fold_in(bkeys, _K_PBITS), (n_tx, N * mp))
    X_p = bits_to_symbols(pbits, mp)                        # (B, n_tx, N)
    dev = bkeys.device
    comb = (torch.arange(N, device=dev)[None, :] % n_tx
            == torch.arange(n_tx, device=dev)[:, None])
    X_ls = X_p * comb

    x_cp, x_clean = _tx_chain(cfg, X_p, lb)
    x_tgt = _esn_target(cfg, x_cp, x_clean)
    x_ls_cp, _ = _tx_chain(cfg, X_ls, lb)
    # the same noise realisation on the full and comb pilots (:309-311)
    noise = awgn(rng.fold_in(bkeys, _K_PNOISE), (n_rx, T), ofdm.noise_psd, T)
    y_cp = apply_fir_channel(taps, x_cp) + noise
    y_ls_cp = apply_fir_channel(taps, x_ls_cp) + noise

    Y_ls = ofdm_demodulate(y_ls_cp, cp)
    if ch.flat_scalar_ls:
        # SISO-AWGN demo: one LS estimate averaged over the subcarriers, and
        # MMSE on the true channel (Demo_SISO...:213-216, 260-266)
        h = (Y_ls / (X_p * lb.sqrt_pi)).mean(-1)                # (B, n_rx)
        H_ls = h[:, None, :, None].expand(H_true.shape).to(H_true.dtype)
        H_mmse = H_true
    else:
        H_ls, H_mmse = estimate_channel(Y_ls, X_ls, lb.sqrt_pi, n_tx, isi,
                                        lb.mmse_scaler)

    def draw(key):
        return init_reservoir(key, 2 * n_rx, 2 * n_tx, esn_cfg.n_reservoir,
                              hyper["spectral_radius"], hyper["sparsity"],
                              hyper["noise"])

    res_keys = rng.fold_in(bkeys, _K_RESERVOIR)
    res = (stack_reservoirs([draw(k) for k in res_keys]) if per_block
           else draw(res_keys[0]))
    delay = esn_cfg.shared_delay(isi)

    def fit(input_scaling, y, x, tag, teacher_scaling):
        scale = EsnScale(
            input_scaling=input_scaling,
            input_shift=_f32(esn_cfg.input_offset / esn_cfg.input_scaler),
            teacher_scaling=_f32(teacher_scaling))
        if per_block:
            return scale, train_mimo_esn_per_block(
                res, scale, y, x, delay, cp,
                key_seed_tensor(rng.fold_in(bkeys, tag)))
        seed = key_seed_tensor(rng.fold_in(bkeys[0], tag))
        return scale, train_mimo_esn(res, scale, y, x, delay, cp, seed)

    fixed = None
    if esn_cfg.train_ebno_fixed_db is not None:
        # the same pilot and channel, re-synthesised at the fixed training
        # Eb/N0 with its own noise draw (:347-357)
        lb_f = fixed_link_budget(cfg)
        x_cp_f, x_clean_f = _tx_chain(cfg, X_p, lb_f)
        y_cp_f = apply_fir_channel(taps, x_cp_f) + awgn(
            rng.fold_in(bkeys, _K_PNOISE_F), (n_rx, T), ofdm.noise_psd, T)
        fixed = (_f32(np.float32(hyper["input_scaler"])
                      / np.sqrt(np.float32(lb_f.var_x))),
                 y_cp_f, _esn_target(cfg, x_cp_f, x_clean_f))
    mark("synth")
    scale_m, Wt_out_m = fit(lb.input_scaling, y_cp, x_tgt, _K_ESNFIT,
                            hyper["teacher_scaling"])
    scale_f = Wt_out_f = None
    if fixed is not None:
        scale_f, Wt_out_f = fit(*fixed, _K_ESNFIT_F, esn_cfg.teacher_scaling)
    mark("esn_fit")
    state = BlockState(taps=taps, H_true=H_true, H_ls=H_ls, H_mmse=H_mmse,
                       reservoir=res, scale_m=scale_m, scale_f=scale_f,
                       Wt_out_m=Wt_out_m, Wt_out_f=Wt_out_f)
    return (state, (y_cp, x_tgt)) if return_pilot else state


class DataSymbols(NamedTuple):
    """Per-detector frequency-domain estimates for D data symbols."""
    X_true: torch.Tensor     # (B, D, N, n_tx)
    Y: torch.Tensor          # (B, D, n_rx, N)
    X_hat: dict              # detector -> (B, D, N, n_tx)


def detect_data_symbols(cfg: SimConfig, state: BlockState,
                        ebno_db: float | EbnoRow,
                        bkeys: torch.Tensor, code_bits: torch.Tensor,
                        detectors: Tuple[str, ...] = DETECTORS,
                        return_td: bool = False):
    """D data symbols through TX -> channel -> detectors
    (reference OFDM_SISO_NBF_LDPC.py:387-460). code_bits (B, D, n_tx, N*m);
    ebno_db a float or its EbnoRow on the keys' device.
    The ESN detectors run the CUDA predict kernel (or its plain version on
    the CPU); "esn_fixed" only where the block state has a fixed-SNR
    readout.

    return_td: also return the time-domain waveforms (y_cp, x_tgt), each
    (B, D, n_*, N + cp): the received symbols and the ESN's teacher
    waveform of the transmitted ones (EsnConfig.target_waveform), as
    (DataSymbols, (y_cp, x_tgt))."""
    unknown = set(detectors) - set(DETECTORS)
    if unknown:
        raise ValueError(f"unknown detectors {sorted(unknown)}")
    ofdm = cfg.ofdm
    N, cp, m = ofdm.n_subcarriers, ofdm.cp_len, ofdm.bits_per_symbol
    n_tx, n_rx = cfg.channel.n_tx, cfg.channel.n_rx
    T = N + cp
    B, D = code_bits.shape[:2]
    lb = _as_row(cfg, ebno_db, bkeys.device, cfg.esn.input_scaler)

    X = bits_to_symbols(code_bits, m)                       # (B, D, n_tx, N)
    x_cp, x_clean = _tx_chain(cfg, X, lb)
    noise = awgn(rng.fold_in(bkeys, _K_DNOISE), (D, n_rx, T), ofdm.noise_psd,
                 T)
    y_cp = apply_fir_channel(state.taps[:, None], x_cp) + noise
    Y = ofdm_demodulate(y_cp, cp)                           # (B, D, n_rx, N)

    delay = cfg.esn.shared_delay(ofdm.isi_duration)

    def esn(scale, Wt_out, tag):
        if _per_block(cfg):
            # block b's symbols on its own reservoir, seeded from its key
            return esn_detect_symbols_per_block(
                state.reservoir, scale, Wt_out, y_cp, delay, cp, N,
                lb.sqrt_pi,
                key_seed_tensor(rng.fold_key(bkeys, _K_DETECT, tag)),
                cfg.esn.recurrence_precision)
        # rows are block-major (D symbols per block), so the (B, F, n_out)
        # readout passes grouped: row r uses readout r // D
        seed = key_seed_tensor(rng.fold_key(bkeys[0], _K_DETECT, tag))
        Xh = esn_detect_symbols(
            state.reservoir, scale, Wt_out, y_cp.reshape(B * D, n_rx, T),
            delay, cp, N, lb.sqrt_pi, seed, cfg.esn.recurrence_precision)
        return Xh.reshape(B, D, N, n_tx)

    # the channel is block-constant: each equaliser is solved once per
    # (block, subcarrier) and applied to all D symbols
    def equalize(H, reg):
        return apply_equalizer(equalizer_weights(H, reg), Y, lb.sqrt_pi)

    X_hat = {}
    if "esn" in detectors:
        X_hat["esn"] = esn(state.scale_m, state.Wt_out_m, 0)
    if "esn_fixed" in detectors and state.Wt_out_f is not None:
        X_hat["esn_fixed"] = esn(state.scale_f, state.Wt_out_f, 1)
    if "zf_perfect" in detectors:
        X_hat["zf_perfect"] = equalize(state.H_true, _f32(1e-12))
    if "zf_ls" in detectors:
        X_hat["zf_ls"] = equalize(state.H_ls, _f32(1e-12))
    if "mmse" in detectors:
        X_hat["mmse"] = equalize(state.H_mmse, lb.no_over_pi)
    data = DataSymbols(X_true=X.transpose(-1, -2), Y=Y, X_hat=X_hat)
    if return_td:
        return data, (y_cp, _esn_target(cfg, x_cp, x_clean))
    return data


def data_bits_for_blocks(cfg: SimConfig, bkeys: torch.Tensor, n_data: int,
                         code=None):
    """Info bits per block, LDPC-encoded: -> (code_bits (B, D, n_tx, n),
    info_bits (B, D, n_tx, k)) int8. With no code the raw bits fill the
    symbols: -> (bits (B, D, n_tx, N*m), None)."""
    keys = rng.fold_in(bkeys, _K_DBITS)
    n_tx = cfg.channel.n_tx
    if code is None:
        return _vbits(keys, (n_data, n_tx, cfg.ofdm.n_subcarriers
                             * cfg.ofdm.bits_per_symbol)), None
    u = _vbits(keys, (n_data, n_tx, code.k))
    return ldpc_encode(code, u), u
