"""2x2 model-zoo comparison: the ESN against CNN / RNN / FNN / ELM and the
classical equalisers (port of esn_ofdm_mimo_tpu/pipelines/zoo2x2.py; the
reference's system_model_2_all_comparision.py and
Demo_MIMO_2x2_all_DL_model_comparion.py).

Every model shares the ESN's time-domain layout: input (T + d, 2 n_rx),
the received waveform; target (T + d, 2 n_tx), the delayed teacher
waveform. Each is trained per coherence block on that block's pilot and
detects by predicting the waveform, slicing the delay, FFT and 1/sqrt(Pi).
CNN, RNN and FNN train with 50 full-batch Adam epochs on the one pilot
sequence, one model a block, all blocks at once
(models/zoo.py:train_regressor_per_block; the GRU is trained and predicts
through torch.nn.GRU: train_rnn_per_block); the ELM is one shared random
layer with a batched closed-form readout. NMSE: per block ||pred -
target||^2 / ||target||^2, train over the pilot, test over the D data
symbols, the ESN's by the reference's nmse_for_delay
(models/esn_mimo.py:esn_nmse); sums over blocks are returned.

On the card the ESN's fits run K3 and its detection and both NMSEs K2,
as on every other path; the zoo's training and predictions are PyTorch
library calls, as the JAX package runs them in XLA.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SimConfig
from ..models import zoo
from ..models.elm import elm_fit, init_elm
from ..models.esn import key_seed_tensor
from ..models.esn_mimo import _deinterleave_reim, build_esn_io, esn_nmse
from ..ops import symbols_to_bits_hard
from ..utils import rng
from ..utils.device import resolve_device
from ..utils.metrics import PhaseClock
from .common import (_K_DETECT, data_bits_for_blocks, detect_data_symbols,
                     link_budget, synth_block)

_K_ZOO = 21
WINDOW = 8
DETECTORS = ("esn", "zf_perfect", "zf_ls", "mmse", "cnn", "rnn", "fnn",
             "elm")


class ZooCounts(NamedTuple):
    bit_errors: dict      # detector -> errors over total_bits
    total_bits: int
    train_nmse: dict      # model -> NMSE summed over blocks
    test_nmse: dict       # model -> NMSE summed over blocks
    n_blocks: int


def _td_to_symbols(pred: torch.Tensor, delay: int, cp: int, N: int,
                   sqrt_pi: float) -> torch.Tensor:
    """TD output rows (B, T + d, 2 n_tx) -> symbols (B, N, n_tx): rows
    delay + cp .. delay + cp + N - 1 are the payload, as on the ESN's
    detect path."""
    x_td = _deinterleave_reim(pred[:, delay + cp:delay + cp + N])
    return (torch.fft.fft(x_td, dim=-1) / N / sqrt_pi).transpose(-1, -2)


def _nmse_sum(pred: torch.Tensor, target: torch.Tensor) -> float:
    """Sum over blocks (the leading axis) of ||pred - target||^2 /
    ||target||^2."""
    err = (pred - target).pow(2).flatten(1).sum(1)
    ref = target.pow(2).flatten(1).sum(1) + 1e-12
    return float((err / ref).sum())


def run_zoo_blocks(cfg: SimConfig, ebno_db: float, bkeys, epochs: int = 50,
                   device=None, timings: dict | None = None) -> ZooCounts:
    """B coherence blocks with the eight detectors of DETECTORS. bkeys
    (B, 2) per-block keys (numpy or tensor, utils.rng.block_keys). `device`
    defaults to "cuda" and raises without CUDA unless "cpu" is asked for.
    `timings`, when given, receives each phase's wall ms: synth (channel,
    pilot, the ESN fits), detect, cnn, rnn, fnn, elm (training), preds
    (the zoo's predictions), nmse (the ESN's two) and bits. The ESN's
    NMSEs take one batch-shared reservoir: EsnConfig.rng_mode "block" is
    refused, as the JAX package's run_zoo_blocks cannot take it either."""
    if cfg.esn.rng_mode != "batch":
        raise ValueError("run_zoo_blocks takes EsnConfig.rng_mode 'batch' "
                         f"only, not {cfg.esn.rng_mode!r}")
    dev = resolve_device(device)
    bkeys = rng.as_keys(bkeys, dev)
    clock = PhaseClock(dev, timings)
    ofdm = cfg.ofdm
    N, cp, m = ofdm.n_subcarriers, ofdm.cp_len, ofdm.bits_per_symbol
    n_tx, n_rx = cfg.channel.n_tx, cfg.channel.n_rx
    D = cfg.data_symbols_per_block
    B = bkeys.shape[0]
    T = N + cp
    delay = cfg.esn.shared_delay(ofdm.isi_duration)
    sqrt_pi = link_budget(cfg, ebno_db).sqrt_pi

    state, (y_cp, x_cp) = synth_block(cfg, ebno_db, bkeys, return_pilot=True)
    clock.mark("synth")
    code_bits, _ = data_bits_for_blocks(cfg, bkeys, D, None)
    data, (y_cp_d, x_cp_d) = detect_data_symbols(
        cfg, state, ebno_db, bkeys, code_bits,
        detectors=("esn", "zf_perfect", "zf_ls", "mmse"), return_td=True)
    clock.mark("detect")

    # the pilot in the ESN's layout, standardised per block for the NN and
    # ELM models with the population std (jnp.std); the reference fits the
    # mean and std on the pilot and applies them at detection
    # (Demo_MIMO_2x2_all_DL_model_comparion.py:163-170)
    X_in, X_out = build_esn_io(y_cp, x_cp, delay)        # (B, T+d, 2n_*)
    feat_mu = X_in.mean(1, keepdim=True)
    feat_sd = X_in.std(1, keepdim=True, correction=0) + 1e-9
    X_in_std = (X_in - feat_mu) / feat_sd

    kc, kr, kf, ke = rng.split(rng.fold_key(bkeys[0], _K_ZOO), 4).unbind(0)

    def per_block(key):
        return rng.split(key, B).unbind(0)

    win = lambda x: zoo.window_flatten(x, WINDOW)          # noqa: E731
    X, Y = X_in_std[:, None], X_out[:, None]    # one pilot sequence a block
    # each trained model as a function of (B, ..., 2 n_rx) inputs
    nets = {}
    cnn = zoo.train_regressor_per_block(
        zoo.cnn_apply, [zoo.cnn_init(k, 2 * n_rx, 2 * n_tx, channels=(32, 32))
                        for k in per_block(kc)], X, Y, epochs, 3e-3).params
    nets["cnn"] = lambda x: zoo.apply_per_block(cnn, x)
    clock.mark("cnn")
    nets["rnn"] = zoo.train_rnn_per_block(                 # GruBlocks
        [zoo.rnn_init(k, 2 * n_rx, 32, 2 * n_tx) for k in per_block(kr)], X,
        Y, epochs, 1e-2).params
    clock.mark("rnn")
    fnn = zoo.train_regressor_per_block(
        zoo.mlp_apply, [zoo.mlp_init(k, (WINDOW * 2 * n_rx, 64, 2 * n_tx))
                        for k in per_block(kf)], win(X), Y, epochs,
        3e-3).params
    nets["fnn"] = lambda x: zoo.apply_per_block(fnn, win(x))
    clock.mark("fnn")
    elm_p = elm_fit(init_elm(ke, WINDOW * 2 * n_rx, 128, 2 * n_tx),
                    win(X_in_std), X_out)               # batched closed form
    clock.mark("elm")

    def zoo_preds(xin_std):
        """Each model's TD prediction of standardised inputs (B, ...,
        2 n_rx), block b by block b's model."""
        with torch.no_grad():
            out = {k: net(xin_std) for k, net in nets.items()}
            H = torch.tanh(win(xin_std) @ elm_p.W1.T + elm_p.b1)
            out["elm"] = (H.reshape(B, -1, H.shape[-1]) @ elm_p.W2).reshape(
                *H.shape[:-1], -1)
        return out

    train_nmse = {k: _nmse_sum(p, X_out)
                  for k, p in zoo_preds(X_in_std).items()}

    # the data symbols in the same layout, the pilot's standardisation
    Yin_flat, Xout_flat = build_esn_io(y_cp_d.reshape(B * D, n_rx, T),
                                       x_cp_d.reshape(B * D, n_tx, T), delay)
    Yin = ((Yin_flat.reshape(B, D, -1, 2 * n_rx) - feat_mu[:, None])
           / feat_sd[:, None])
    Xout_d = Xout_flat.reshape(B, D, -1, 2 * n_tx)
    test_preds = zoo_preds(Yin)
    test_nmse = {k: _nmse_sum(p, Xout_d) for k, p in test_preds.items()}
    X_hat = dict(data.X_hat)
    for name, pred in test_preds.items():
        X_hat[name] = _td_to_symbols(pred.reshape(B * D, -1, 2 * n_tx), delay,
                                     cp, N, sqrt_pi).reshape(B, D, N, n_tx)
    clock.mark("preds")

    res, scale, W = state.reservoir, state.scale_m, state.Wt_out_m
    train_nmse["esn"] = float(esn_nmse(
        res, scale, W, y_cp, x_cp, delay, cp, ofdm.isi_duration,
        key_seed_tensor(rng.fold_key(bkeys[0], _K_ZOO, 1))).sum())
    test_nmse["esn"] = float(esn_nmse(
        res, scale, W, y_cp_d.reshape(B * D, n_rx, T),
        x_cp_d.reshape(B * D, n_tx, T), delay, cp, ofdm.isi_duration,
        key_seed_tensor(rng.fold_key(bkeys[0], _K_DETECT, 2))).reshape(B, D)
        .mean(1).sum())
    clock.mark("nmse")

    bit_errors = {
        name: int((symbols_to_bits_hard(Xh.transpose(-1, -2), m)
                   != code_bits).sum())
        for name, Xh in X_hat.items()}
    clock.mark("bits")
    # keys in sorted order, as the JAX package's jitted run returns them
    return ZooCounts(bit_errors=dict(sorted(bit_errors.items())),
                     total_bits=code_bits.numel(),
                     train_nmse=dict(sorted(train_nmse.items())),
                     test_nmse=dict(sorted(test_nmse.items())), n_blocks=B)
