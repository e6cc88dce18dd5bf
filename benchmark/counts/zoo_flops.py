"""The frozen FLOP count of one call of the 2x2 model-zoo comparison
(the program's pipelines/zoo2x2.py, one round of B blocks, no code),
composed from flops.py's functions and conventions (a multiply-add 2
FLOPs, a transcendental 1) where the round runs what they count: the
pilots, the one matched ESN fit, the data symbols, the ESN's detection,
ZF twice and MMSE, and the ESN's two NMSE predictions (pilot and data).
The four models are counted here:

  * CNN, GRU, FNN: `epochs` training steps on the block's pilot, each a
    forward pass and a backward pass counted as twice the forward's
    multiply-adds (each product's two operands get a gradient), plus
    Adam's update, ADAM_FLOPS a parameter; then one forward pass on the
    pilot and one on each of the D data symbols;
  * ELM: the tanh layer on the pilot, the ridge Gram, the 40-iteration
    Newton-Schulz solve with one polished solve, and the predictions.

Elementwise work other than the transcendentals (ReLU, the gates' adds
and products, the losses) is not counted, as flops.py counts none."""
from __future__ import annotations

from .flops import (NS_ITERS, NS_REFINE, RAPP_FLOPS, dot, equalizer_flops,
                    esn_predict_flops, esn_states_flops, fft_flops,
                    fir_direct_flops, readout_lstsq_flops)

ADAM_FLOPS = 10.0        # moments, bias corrections, the update
WINDOW = 8               # the FNN's and the ELM's window of steps
CNN = (32, 32, 3)        # channels, kernel
GRU_HIDDEN = 32
FNN_HIDDEN = 64
ELM_HIDDEN = 128
DETECTORS = 8            # esn, zf_perfect, zf_ls, mmse, cnn, rnn, fnn, elm


def cnn_step(n_in: int, n_out: int) -> tuple:
    """(FLOPs of one time step's forward pass, parameters) of the CNN."""
    c1, c2, k = CNN
    fwd = dot(1, k * n_in, c1) + dot(1, k * c1, c2) + dot(1, c2, n_out)
    params = k * n_in * c1 + c1 + k * c1 * c2 + c2 + c2 * n_out + n_out
    return fwd, params


def gru_step(n_in: int, n_out: int) -> tuple:
    """(FLOPs of one step's forward pass, parameters) of the GRU: the
    input and recurrent gate products, three transcendentals a unit, the
    head."""
    nh = GRU_HIDDEN
    fwd = (dot(1, n_in, 3 * nh) + dot(1, nh, 3 * nh) + 3 * nh
           + dot(1, nh, n_out))
    params = n_in * 3 * nh + nh * 3 * nh + 3 * nh + nh * n_out + n_out
    return fwd, params


def fnn_step(n_in: int, n_out: int) -> tuple:
    """(FLOPs of one step's forward pass, parameters) of the FNN on the
    window of the last WINDOW steps: one tanh layer and a linear head."""
    f, nh = WINDOW * n_in, FNN_HIDDEN
    fwd = dot(1, f, nh) + nh + dot(1, nh, n_out)
    return fwd, f * nh + nh + nh * n_out + n_out


def zoo_round_flops(cfg, n_blocks: int, epochs: int) -> float:
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
    R = T_esn - (delay + cp)
    BD = B * D

    synth = fft_flops(B * n_rx * n_tx, N)                   # taps -> H_true
    synth += 2 * (fft_flops(B * n_tx, N) + RAPP_FLOPS * B * n_tx * T)
    synth += 2 * fir_direct_flops(B, n_tx, n_rx, T, isi)
    synth += fft_flops(B * n_rx, N) + 8.0 * B * n_rx * N    # demod, LS
    synth += 2 * fft_flops(B * n_rx * n_tx, N)              # MMSE refine
    synth += (esn_states_flops(B, T_esn, n_res, n_in, n_out)
              + readout_lstsq_flops(B, R, F, n_out))

    det = fft_flops(BD * n_tx, N) + RAPP_FLOPS * BD * n_tx * T
    det += fir_direct_flops(BD, n_tx, n_rx, T, isi)
    det += fft_flops(BD * n_rx, N)
    det += esn_predict_flops(BD, T_esn, n_res, n_in, n_out)
    det += 3 * equalizer_flops(B, N, n_tx, n_rx, D)
    # the TD -> frequency FFT of the ESN and of each of the four models
    det += 5 * fft_flops(BD * n_tx, N)
    det += 4.0 * BD * n_tx * N * m * DETECTORS

    nmse = (esn_predict_flops(B, T_esn, n_res, n_in, n_out)
            + esn_predict_flops(BD, T_esn, n_res, n_in, n_out))

    steps_pilot, steps_pred = B * T_esn, (B + BD) * T_esn
    models = 0.0
    for fwd, params in (cnn_step(n_in, n_out), gru_step(n_in, n_out),
                        fnn_step(n_in, n_out)):
        models += epochs * (3.0 * fwd * steps_pilot + ADAM_FLOPS * B * params)
        models += fwd * steps_pred

    nh, f = ELM_HIDDEN, WINDOW * n_in
    elm = (dot(steps_pilot, f, nh) + nh * steps_pilot       # tanh layer
           + 2.0 * B * T_esn * nh * nh                       # H^T H
           + NS_ITERS * 2.0 * 2.0 * B * nh ** 3              # Newton-Schulz
           + (1 + 2 * NS_REFINE) * 2.0 * B * nh * nh * n_out  # the solve
           + dot(B * nh, T_esn, n_out))                      # H^T Y
    elm += dot(steps_pred, f, nh) + nh * steps_pred + dot(steps_pred, nh,
                                                          n_out)
    return synth + det + nmse + models + elm
