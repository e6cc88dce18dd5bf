"""The 2x2 model-zoo comparison in plain PyTorch, written for the
benchmark's reference (system_model_2_all_comparision.py; the JAX
package's pipelines/zoo2x2.py): B coherence blocks of the block-fading
link with no code, detected by the ESN, ZF on the true and the LS
channel, MMSE, and by a CNN, a GRU, an FNN and an ELM trained on each
block's own pilot.

Every model reads the ESN's time-domain layout: the received pilot
waveform (T + d, 2 n_rx), standardised per block by the pilot's mean and
population std, against the delayed teacher waveform (T + d, 2 n_tx). The
CNN and the GRU read it as it is, the FNN and the ELM its window of the
last 8 steps. CNN, GRU and FNN train with `epochs` full-batch Adam steps
(lr 3e-3, 1e-2, 3e-3); the ELM (128 tanh units, shared) fits its readout
per block in closed form. Each predicts the D data symbols' waveforms
from theirs (standardised by the pilot's statistics), which are cut at
the delay, transformed (FFT / N / sqrt(Pi)) and hard-demapped. NMSE per
block: ||pred - target||^2 / ||target||^2 over the pilot (train) and the
D data symbols (test); the ESN's per TX over the first T - isi + 1
samples (the reference's nmse_for_delay), its test NMSE the mean over
the D symbols. Sums over the blocks are returned.

Keys: the models draw from split(fold_in(keys[0], 21), 4) (CNN, GRU, FNN,
ELM), each CNN, GRU and FNN then from that key split B ways; the ESN's
NMSE noise from fold_in(keys[0], 21, 1) and fold_in(keys[0], 10, 2).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SimConfig
from ..models import zoo
from ..models.elm import elm_fit, hidden, init_elm
from ..models.esn import esn_predict, key_seed_tensor, noise_generator
from ..models.esn_mimo import _deinterleave_reim, build_esn_input, \
    build_esn_io
from ..ops import symbols_to_bits_hard
from ..utils import rng
from .common import _K_DETECT, data_bits_for_blocks, detect_data_symbols, \
    link_budget, synth_block

_K_ZOO = 21
WINDOW = 8


class ZooCounts(NamedTuple):
    bit_errors: dict      # detector -> bit errors over total_bits
    total_bits: int
    train_nmse: dict      # model -> NMSE summed over blocks
    test_nmse: dict       # model -> NMSE summed over blocks
    n_blocks: int


def esn_nmse(res, scale, Wt_out, y_cp, x_cp, delay: int, cp_len: int,
             isi_duration: int, seed) -> torch.Tensor:
    """The ESN's NMSE a row (the reference's nmse_for_delay): y_cp (R,
    n_rx, T), x_cp (R, n_tx, T); per TX the squared error of the first T -
    isi + 1 predicted samples against x_cp[..., isi - 1:] over the latter's
    energy, summed over TX -> (R,)."""
    X_in = build_esn_input(y_cp, delay)
    pred = esn_predict(res, scale, Wt_out, X_in, delay + cp_len,
                       noise_generator(seed, X_in.device))
    x_true = x_cp[..., isi_duration - 1:]
    x_hat = _deinterleave_reim(pred)[..., :x_true.shape[-1]]
    err = (x_hat - x_true).abs().pow(2).sum(-1)
    ref = x_true.abs().pow(2).sum(-1) + 1e-12
    return (err / ref).sum(-1)


def _nmse_sum(pred: torch.Tensor, target: torch.Tensor) -> float:
    err = (pred - target).pow(2).flatten(1).sum(1)
    ref = target.pow(2).flatten(1).sum(1) + 1e-12
    return float((err / ref).sum())


def run_zoo_blocks(cfg: SimConfig, ebno_db: float, bkeys: torch.Tensor,
                   epochs: int = 50) -> ZooCounts:
    """B blocks of keys bkeys (B, 2) at one Eb/N0 -> host counters."""
    ofdm = cfg.ofdm
    N, cp, m = ofdm.n_subcarriers, ofdm.cp_len, ofdm.bits_per_symbol
    n_tx, n_rx = cfg.channel.n_tx, cfg.channel.n_rx
    D, B, T = cfg.data_symbols_per_block, bkeys.shape[0], N + cp
    delay = cfg.esn.shared_delay(ofdm.isi_duration)
    sqrt_pi = link_budget(cfg, ebno_db).sqrt_pi

    with torch.no_grad():
        state, (y_cp, x_cp) = synth_block(cfg, ebno_db, bkeys,
                                          return_pilot=True)
        code_bits, _ = data_bits_for_blocks(cfg, bkeys, D, None)
        data, (y_cp_d, x_cp_d) = detect_data_symbols(
            cfg, state, ebno_db, bkeys, code_bits,
            detectors=("esn", "zf_perfect", "zf_ls", "mmse"),
            return_td=True)
        X_in, X_out = build_esn_io(y_cp, x_cp, delay)
        mu = X_in.mean(1, keepdim=True)
        sd = X_in.std(1, keepdim=True, correction=0) + 1e-9
        X = ((X_in - mu) / sd)[:, None]                  # (B, 1, T + d, F)
        Y = X_out[:, None]
        Yin_flat, Xout_flat = build_esn_io(y_cp_d.reshape(B * D, n_rx, T),
                                           x_cp_d.reshape(B * D, n_tx, T),
                                           delay)
        Xd = (Yin_flat.reshape(B, D, -1, 2 * n_rx) - mu[:, None]) / sd[:, None]
        Yd = Xout_flat.reshape(B, D, -1, 2 * n_tx)

    kc, kr, kf, ke = rng.split(rng.fold_key(bkeys[0], _K_ZOO), 4).unbind(0)
    win = zoo.window_flatten
    cnn = zoo.train(zoo.cnn_apply, zoo.cnn_init(
        rng.split(kc, B), 2 * n_rx, 2 * n_tx), X, Y, epochs, 3e-3)
    gru = zoo.train(zoo.gru_apply, zoo.gru_init(
        rng.split(kr, B), 2 * n_rx, 32, 2 * n_tx), X, Y, epochs, 1e-2)
    fnn = zoo.train(zoo.mlp_apply, zoo.mlp_init(
        rng.split(kf, B), (WINDOW * 2 * n_rx, 64, 2 * n_tx)), win(X), Y,
        epochs, 3e-3)
    with torch.no_grad():
        W1, b1 = init_elm(ke, WINDOW * 2 * n_rx, 128)
        W2 = elm_fit(W1, b1, win(X[:, 0]), Y[:, 0])

        def preds(x):
            h = hidden(W1, b1, win(x))
            return {"cnn": zoo.cnn_apply(cnn, x), "rnn": zoo.gru_apply(gru, x),
                    "fnn": zoo.mlp_apply(fnn, win(x)),
                    "elm": (h.reshape(B, -1, h.shape[-1]) @ W2).reshape(
                        *h.shape[:-1], -1)}

        train_nmse = {k: _nmse_sum(p, Y) for k, p in preds(X).items()}
        test_preds = preds(Xd)
        test_nmse = {k: _nmse_sum(p, Yd) for k, p in test_preds.items()}
        X_hat = dict(data.X_hat)
        for k, p in test_preds.items():
            x_td = _deinterleave_reim(p.reshape(B * D, -1, 2 * n_tx)
                                      [:, delay + cp:delay + cp + N])
            X_hat[k] = (torch.fft.fft(x_td, dim=-1) / N / sqrt_pi).transpose(
                -1, -2).reshape(B, D, N, n_tx)

        res, scale, W = state.reservoir, state.scale_m, state.Wt_out_m
        train_nmse["esn"] = float(esn_nmse(
            res, scale, W, y_cp, x_cp, delay, cp, ofdm.isi_duration,
            key_seed_tensor(rng.fold_key(bkeys[0], _K_ZOO, 1))).sum())
        test_nmse["esn"] = float(esn_nmse(
            res, scale, W, y_cp_d.reshape(B * D, n_rx, T),
            x_cp_d.reshape(B * D, n_tx, T), delay, cp, ofdm.isi_duration,
            key_seed_tensor(rng.fold_key(bkeys[0], _K_DETECT, 2)))
            .reshape(B, D).mean(1).sum())
        bit_errors = {
            k: int((symbols_to_bits_hard(Xh.transpose(-1, -2), m)
                    != code_bits).sum())
            for k, Xh in X_hat.items()}
    return ZooCounts(bit_errors=dict(sorted(bit_errors.items())),
                     total_bits=code_bits.numel(),
                     train_nmse=dict(sorted(train_nmse.items())),
                     test_nmse=dict(sorted(test_nmse.items())), n_blocks=B)
