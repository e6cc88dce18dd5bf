"""Shared coherence-block machinery (port of
esn_ofdm_mimo_tpu/pipelines/common.py, rng_mode="batch").

One coherence block = channel draw + pilot symbol + ESN training + D data
symbols (the reference's `kk % L == 1` schedule, OFDM_SISO_NBF_LDPC.py:270).
B blocks run as one batch: keys (B, 2) give each block its own taps, bits
and noise through the key-compatible RNG (utils/rng.py), so every per-block
draw equals the JAX package's at the same keys. As there, the ESN reservoir
and its state-noise streams are shared by the batch and tied to its first
key.

The link budget (var_x, Pi, sqrt(Pi), A_clip, No/Pi) is evaluated in
float32, as the JAX package evaluates it with a traced float32 Eb/N0.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import SimConfig
from ..ldpc import ldpc_encode
from ..models.esn import EsnReservoir, EsnScale, init_reservoir, \
    generator_for, key_seed
from ..models.esn_mimo import train_mimo_esn, esn_detect_symbols
from ..ops import (apply_fir_channel, bits_to_symbols, draw_tdl_taps,
                   estimate_channel, ofdm_demodulate, ofdm_modulate,
                   taps_to_freq_response)
from ..ops.equalize import apply_equalizer, equalizer_weights
from ..ops.pa import clip_amplitude, rapp_pa
from ..utils import rng

# purpose tags folded into block keys (the JAX package's values)
_K_CHAN, _K_PBITS, _K_PNOISE, _K_ESNFIT = 1, 2, 3, 5
_K_DBITS, _K_DNOISE, _K_DETECT = 8, 9, 10
_K_RESERVOIR = 11


def _vbits(keys: torch.Tensor, shape) -> torch.Tensor:
    """Per-block random bits: keys (B, 2) -> (B, *shape) int8."""
    return rng.bernoulli(keys, 0.5, shape).to(torch.int8)


def _vawgn(keys: torch.Tensor, shape, noise_psd: float, seq_len: int
           ) -> torch.Tensor:
    """Per-block complex AWGN, std per real dimension sqrt(seq_len*No/2)
    (reference OFDM_SISO_NBF_LDPC.py:309,425)."""
    std = float(np.sqrt(np.float32(seq_len * noise_psd / 2.0)))
    kri = rng.split(keys)
    return torch.complex(std * rng.normal(kri[..., 0, :], shape),
                         std * rng.normal(kri[..., 1, :], shape))


class LinkBudget(NamedTuple):
    var_x: float
    pi: float
    sqrt_pi: float
    a_clip: float


def link_budget(cfg: SimConfig, ebno_db: float) -> LinkBudget:
    No = np.float32(cfg.ofdm.noise_psd)
    N = np.float32(cfg.ofdm.n_subcarriers)
    var_x = (np.float32(10.0) ** (np.float32(ebno_db) / np.float32(10.0))
             * No * N)
    pi = var_x / N
    return LinkBudget(float(var_x), float(pi), float(np.sqrt(pi)),
                      clip_amplitude(var_x, cfg.pa.clip_level_db))


def _f32(x) -> float:
    return float(np.float32(x))


class BlockState(NamedTuple):
    """What the data symbols need from their coherence block (batch B)."""
    taps: torch.Tensor        # (B, n_rx, n_tx, isi)
    H_true: torch.Tensor      # (B, N, n_rx, n_tx)
    H_ls: torch.Tensor        # (B, N, n_rx, n_tx)
    H_mmse: torch.Tensor      # (B, N, n_rx, n_tx)
    reservoir: EsnReservoir   # shared across the batch
    scale_m: EsnScale         # SNR-matched input scaling
    Wt_out_m: torch.Tensor    # (B, F, 2*n_tx) matched readout


def _check_supported(cfg: SimConfig):
    if cfg.esn.rng_mode != "batch":
        raise NotImplementedError("rng_mode='block' is not ported yet")
    if cfg.channel.kind not in ("cdl_a", "cdl_b", "cdl_c"):
        raise NotImplementedError(
            f"channel kind {cfg.channel.kind!r} is not ported yet")
    if cfg.channel.flat_scalar_ls:
        raise NotImplementedError("flat_scalar_ls is not ported yet")


def _tx_chain(cfg: SimConfig, X: torch.Tensor, lb: LinkBudget
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frequency symbols (..., n_tx, N) -> (PA output, clean scaled TD
    waveform), each (..., n_tx, N + cp)."""
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


def synth_block(cfg: SimConfig, ebno_db: float, bkeys: torch.Tensor
                ) -> BlockState:
    """Channel draw, pilot synthesis, channel estimation and ESN training
    for B blocks (reference OFDM_SISO_NBF_LDPC.py:270-384). bkeys (B, 2).

    The fixed-SNR second ESN (EsnConfig.train_ebno_fixed_db, detector
    "esn_fixed") is not ported yet; the CDL pipeline does not use it."""
    _check_supported(cfg)
    ofdm, esn_cfg, ch = cfg.ofdm, cfg.esn, cfg.channel
    N, cp, isi = ofdm.n_subcarriers, ofdm.cp_len, ofdm.isi_duration
    n_tx, n_rx, mp = ch.n_tx, ch.n_rx, ofdm.bits_per_pilot_symbol
    T = N + cp
    lb = link_budget(cfg, ebno_db)

    taps = draw_tdl_taps(rng.fold_in(bkeys, _K_CHAN), n_rx, n_tx, isi,
                         ofdm.sample_rate_hz, ch.delay_spread_ns,
                         profile=ch.kind[-1])
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
    noise = _vawgn(rng.fold_in(bkeys, _K_PNOISE), (n_rx, T), ofdm.noise_psd,
                   T)
    y_cp = apply_fir_channel(taps, x_cp) + noise
    y_ls_cp = apply_fir_channel(taps, x_ls_cp) + noise

    Y_ls = ofdm_demodulate(y_ls_cp, cp)
    mmse_scaler = _f32(np.float32(ofdm.noise_psd) / np.float32(lb.pi)
                       / np.float32(N / 2.0))
    H_ls, H_mmse = estimate_channel(Y_ls, X_ls, lb.sqrt_pi, n_tx, isi,
                                    mmse_scaler)

    res = init_reservoir(rng.fold_in(bkeys[0], _K_RESERVOIR), 2 * n_rx,
                         2 * n_tx, esn_cfg.n_reservoir,
                         esn_cfg.spectral_radius, esn_cfg.sparsity,
                         esn_cfg.noise)
    scale_m = EsnScale(
        input_scaling=_f32(np.float32(esn_cfg.input_scaler)
                           / np.sqrt(np.float32(lb.var_x))),
        input_shift=_f32(esn_cfg.input_offset / esn_cfg.input_scaler),
        teacher_scaling=_f32(esn_cfg.teacher_scaling))
    gen = generator_for(rng.fold_in(bkeys[0], _K_ESNFIT), dev)
    Wt_out_m = train_mimo_esn(res, scale_m, y_cp, x_tgt,
                              esn_cfg.shared_delay(isi), cp, gen)
    return BlockState(taps=taps, H_true=H_true, H_ls=H_ls, H_mmse=H_mmse,
                      reservoir=res, scale_m=scale_m, Wt_out_m=Wt_out_m)


class DataSymbols(NamedTuple):
    """Per-detector frequency-domain estimates for D data symbols."""
    X_true: torch.Tensor     # (B, D, N, n_tx)
    Y: torch.Tensor          # (B, D, n_rx, N)
    X_hat: dict              # detector -> (B, D, N, n_tx)


def detect_data_symbols(cfg: SimConfig, state: BlockState, ebno_db: float,
                        bkeys: torch.Tensor, code_bits: torch.Tensor,
                        detectors: Tuple[str, ...] = ("esn", "mmse")
                        ) -> DataSymbols:
    """D data symbols through TX -> channel -> detectors
    (reference OFDM_SISO_NBF_LDPC.py:387-460). code_bits (B, D, n_tx, N*m).
    Detectors: "esn" (CUDA predict kernel / its plain version) and "mmse"."""
    unknown = set(detectors) - {"esn", "mmse"}
    if unknown:
        raise NotImplementedError(f"detectors {sorted(unknown)} are not "
                                  "ported yet")
    ofdm = cfg.ofdm
    N, cp, m = ofdm.n_subcarriers, ofdm.cp_len, ofdm.bits_per_symbol
    n_tx, n_rx = cfg.channel.n_tx, cfg.channel.n_rx
    T = N + cp
    B, D = code_bits.shape[:2]
    lb = link_budget(cfg, ebno_db)

    X = bits_to_symbols(code_bits, m)                       # (B, D, n_tx, N)
    x_cp, _ = _tx_chain(cfg, X, lb)
    noise = _vawgn(rng.fold_in(bkeys, _K_DNOISE), (D, n_rx, T),
                   ofdm.noise_psd, T)
    y_cp = apply_fir_channel(state.taps[:, None], x_cp) + noise
    Y = ofdm_demodulate(y_cp, cp)                           # (B, D, n_rx, N)

    X_hat = {}
    if "esn" in detectors:
        # rows are block-major (D symbols per block), so the (B, F, n_out)
        # readout passes grouped: row r uses readout r // D
        seed = key_seed(rng.fold_key(bkeys[0], _K_DETECT, 0))
        Xh = esn_detect_symbols(
            state.reservoir, state.scale_m, state.Wt_out_m,
            y_cp.reshape(B * D, n_rx, T), cfg.esn.shared_delay(
                ofdm.isi_duration), cp, N, lb.sqrt_pi, seed)
        X_hat["esn"] = Xh.reshape(B, D, N, n_tx)
    if "mmse" in detectors:
        reg = _f32(np.float32(ofdm.noise_psd) / np.float32(lb.pi))
        W = equalizer_weights(state.H_mmse, reg)
        X_hat["mmse"] = apply_equalizer(W, Y, lb.sqrt_pi)
    return DataSymbols(X_true=X.transpose(-1, -2), Y=Y, X_hat=X_hat)


def data_bits_for_blocks(cfg: SimConfig, bkeys: torch.Tensor, n_data: int,
                         code):
    """Info bits per block, LDPC-encoded: -> (code_bits (B, D, n_tx, n),
    info_bits (B, D, n_tx, k)) int8."""
    u = _vbits(rng.fold_in(bkeys, _K_DBITS),
               (n_data, cfg.channel.n_tx, code.k))
    return ldpc_encode(code, u), u
