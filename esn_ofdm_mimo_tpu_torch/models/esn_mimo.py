"""MIMO-OFDM ESN detection harness (port of esn_ofdm_mimo_tpu/models/
esn_mimo.py; reference libs/helper_mimo_esn_generic.py:5-86 and
OFDM_SISO_NBF_LDPC.py:430-448).

  * ESN input: 2*n_rx real channels (re, im per RX) of the received
    waveform y_cp, zero-padded by `delay` samples at the end;
  * ESN target: 2*n_tx channels of the transmitted waveform, delayed by
    `delay` samples;
  * n_forget = delay + cp_len;
  * detection: predict, keep rows [0, N), recombine re + im, FFT/N, divide
    by sqrt(Pi).

The fit's state harvest runs the CUDA states kernel (K3,
models/esn_states_cuda.py), as the JAX package's fit does under
ESN_TPU_IMPL=pallas; detection runs the CUDA predict kernel (K2, or K4
under the JAX package's own switch ESN_TPU_PREDICT_READOUT=grouped where its
condition holds; models/esn_cuda.py). CPU tensors run the plain versions.

EsnConfig(rng_mode="block") takes `train_mimo_esn_per_block` and
`esn_detect_symbols_per_block`: every block has its own reservoir (a
`stack_reservoirs` of them) and its own noise seed, and runs alone, K3
once (B = 1) for its fit and K2 once (its D rows, one readout) for each
detection. A launch of one block is the same program whatever else the
round holds, so a block's readout and detections do not depend on how the
blocks are cut into rounds and ranks (the JAX package's `lax.map` over
blocks, esn_mimo.py:146-211).
"""
from __future__ import annotations

import os
from typing import Sequence, Tuple

import torch
import torch.nn.functional as Fn

from ..utils import rng
from .esn import EsnReservoir, EsnScale, esn_fit, key_seed_tensor
from .esn_cuda import choose_readout, esn_predict_cuda


def _interleave_reim(z: torch.Tensor) -> torch.Tensor:
    """(B, A, T) complex -> (B, T, 2A) real, columns (re0, im0, re1, ...)."""
    parts = torch.stack([z.real, z.imag], dim=-2)           # (B, A, 2, T)
    B, A, _, T = parts.shape
    return parts.reshape(B, 2 * A, T).transpose(-1, -2).to(torch.float32)


def _deinterleave_reim(x: torch.Tensor) -> torch.Tensor:
    """(B, T, 2A) real -> (B, A, T) complex."""
    B, T, twoA = x.shape
    z = x.reshape(B, T, twoA // 2, 2)
    return torch.complex(z[..., 0], z[..., 1]).transpose(-1, -2)


def build_esn_io(y_cp: torch.Tensor, x_cp: torch.Tensor, delay: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y_cp (B, n_rx, T), x_cp (B, n_tx, T) complex -> X_in
    (B, T+delay, 2*n_rx), X_out (B, T+delay, 2*n_tx) real."""
    X_in = Fn.pad(_interleave_reim(y_cp), (0, 0, 0, delay))
    X_out = Fn.pad(_interleave_reim(x_cp), (0, 0, delay, 0))
    return X_in, X_out


def build_esn_input(y_cp: torch.Tensor, delay: int) -> torch.Tensor:
    """Inference input: y_cp (B, n_rx, T) -> (B, T+delay, 2*n_rx)."""
    return Fn.pad(_interleave_reim(y_cp), (0, 0, 0, delay))


def train_mimo_esn(res: EsnReservoir, scale: EsnScale, y_cp: torch.Tensor,
                   x_cp: torch.Tensor, delay: int, cp_len: int,
                   seed=0) -> torch.Tensor:
    """Fit readouts for B coherence blocks -> Wt_out (B, F, 2*n_tx): states
    (K3 on the card), then the scaled inputs appended, then the ridge solve
    on rows [n_forget:] (JAX esn_mimo.train_mimo_esn, its Pallas branch).
    `seed` seeds the state noise."""
    X_in, X_out = build_esn_io(y_cp, x_cp, delay)
    return esn_fit(res, scale, X_in, X_out, delay + cp_len, seed)


def esn_detect_symbols(res: EsnReservoir, scale: EsnScale,
                       Wt_out: torch.Tensor, y_cp: torch.Tensor, delay: int,
                       cp_len: int, n_subcarriers: int, power_scale: float,
                       seed=0) -> torch.Tensor:
    """One OFDM symbol per row: y_cp (B, n_rx, N+cp) -> X_hat (B, N, n_tx).
    Wt_out may be grouped, (G, F, n_out) with B % G == 0 (readout g serves
    the contiguous run of B//G rows). With ESN_TPU_PREDICT_READOUT=grouped
    the card runs K4 instead of K2 where a block of the launch's tiling
    touches at most 4 readouts (Dg > 1)."""
    N = n_subcarriers
    X_in = build_esn_input(y_cp, delay)
    G = Wt_out.shape[0]
    readout = "per_row"
    if os.environ.get("ESN_TPU_PREDICT_READOUT") == "grouped":
        readout = choose_readout(X_in.shape[0], G, res.Wt.shape[0],
                                 X_in.shape[2], Wt_out.shape[2], X_in.device)
    pred = esn_predict_cuda(res, scale, Wt_out, X_in, delay + cp_len, seed,
                            readout=readout)
    x_hat_td = _deinterleave_reim(pred[:, :N])             # (B, n_tx, N)
    X_hat = torch.fft.fft(x_hat_td, dim=-1) / N / power_scale
    return X_hat.transpose(-1, -2)


def stack_reservoirs(reservoirs: Sequence[EsnReservoir]) -> EsnReservoir:
    """B reservoirs of one shape and noise -> one EsnReservoir whose weights
    have a leading block axis (rng_mode="block")."""
    return EsnReservoir(*(torch.stack(w) for w in zip(
        *(r[:3] for r in reservoirs))), noise=reservoirs[0].noise)


def block_reservoir(res_b: EsnReservoir, b: int) -> EsnReservoir:
    """Block b's reservoir of a stacked one."""
    return res_b._replace(Wt=res_b.Wt[b], W_in_t=res_b.W_in_t[b],
                          W_fb_t=res_b.W_fb_t[b])


def train_mimo_esn_per_block(res_b: EsnReservoir, scale: EsnScale,
                             y_cp: torch.Tensor, x_cp: torch.Tensor,
                             delay: int, cp_len: int, seeds
                             ) -> torch.Tensor:
    """The fit of rng_mode="block" (JAX train_mimo_esn_per_block): block b
    fits on its own reservoir block_reservoir(res_b, b), state noise seeded
    with seeds[b], alone: y_cp (B, n_rx, T), x_cp (B, n_tx, T) -> Wt_out
    (B, F, 2*n_tx), one K3 launch and one readout solve a block. seeds:
    B ints, or a (B,) int64 tensor on y_cp's device (`key_seed_tensor`)."""
    return torch.cat([
        train_mimo_esn(block_reservoir(res_b, b), scale, y_cp[b:b + 1],
                       x_cp[b:b + 1], delay, cp_len, seeds[b])
        for b in range(y_cp.shape[0])])


def esn_detect_symbols_per_block(res_b: EsnReservoir, scale: EsnScale,
                                 Wt_out: torch.Tensor, y_cp: torch.Tensor,
                                 delay: int, cp_len: int,
                                 n_subcarriers: int, power_scale: float,
                                 seeds) -> torch.Tensor:
    """The detection of rng_mode="block" (JAX esn_detect_symbols_per_block):
    y_cp (B, D, n_rx, N+cp) -> X_hat (B, D, N, n_tx); block b's D symbols
    run on its reservoir and readout Wt_out[b], state noise seeded with
    seeds[b] (as in `train_mimo_esn_per_block`), one K2 launch a block."""
    N = n_subcarriers
    outs = []
    for b in range(y_cp.shape[0]):
        X_in = build_esn_input(y_cp[b], delay)
        pred = esn_predict_cuda(block_reservoir(res_b, b), scale,
                                Wt_out[b:b + 1], X_in, delay + cp_len,
                                seeds[b])
        X_hat = torch.fft.fft(_deinterleave_reim(pred[:, :N]), dim=-1)
        outs.append((X_hat / N / power_scale).transpose(-1, -2))
    return torch.stack(outs)


def esn_nmse(res: EsnReservoir, scale: EsnScale, Wt_out: torch.Tensor,
             y_cp: torch.Tensor, x_cp: torch.Tensor, delay: int, cp_len: int,
             isi_duration: int, seed=0) -> torch.Tensor:
    """NMSE of the predicted waveform, the reference's nmse_for_delay
    (helper_mimo_esn_generic.py:40-56): y_cp (B, n_rx, T), x_cp (B, n_tx,
    T); per TX, the squared error of the first T - isi + 1 predicted samples
    against x_cp[..., isi - 1:] over the energy of the latter, summed over
    TX -> (B,). Wt_out may be grouped as in `esn_detect_symbols`; the
    prediction runs K2 on the card."""
    X_in = build_esn_input(y_cp, delay)
    pred = esn_predict_cuda(res, scale, Wt_out, X_in, delay + cp_len, seed)
    x_true = x_cp[..., isi_duration - 1:]
    x_hat = _deinterleave_reim(pred)[..., :x_true.shape[-1]]
    err = (x_hat - x_true).abs().pow(2).sum(-1)
    ref = x_true.abs().pow(2).sum(-1) + 1e-12
    return (err / ref).sum(-1)


def select_delay_by_nmse(res: EsnReservoir, scale: EsnScale,
                         y_cp: torch.Tensor, x_cp: torch.Tensor,
                         min_delay: int, max_delay: int, cp_len: int,
                         isi_duration: int, key: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's DelayFlag != 0 path: fit and score every delay in
    [min_delay, max_delay], keep the one of least NMSE per block. Each
    candidate splits `key` into (fit, predict, next) as the JAX package
    does, and seeds its fit (K3) and prediction (K2) from the first two.
    Returns (best delay (B,) int32, NMSE table (B, n_delays))."""
    nmses = []
    for d in range(min_delay, max_delay + 1):
        kf, kp, key = rng.split(key, 3).unbind(0)
        Wt_out = train_mimo_esn(res, scale, y_cp, x_cp, d, cp_len,
                                key_seed_tensor(kf))
        nmses.append(esn_nmse(res, scale, Wt_out, y_cp, x_cp, d, cp_len,
                              isi_duration, key_seed_tensor(kp)))
    table = torch.stack(nmses, dim=-1)
    return (min_delay + torch.argmin(table, dim=-1)).to(torch.int32), table
