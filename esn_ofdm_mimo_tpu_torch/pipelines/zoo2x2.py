"""2x2 model-zoo comparison: the ESN against CNN / RNN / FNN / ELM and the
classical equalisers (port of esn_ofdm_mimo_tpu/pipelines/zoo2x2.py; the
reference's system_model_2_all_comparision.py and
Demo_MIMO_2x2_all_DL_model_comparion.py).

Every model shares the ESN's time-domain layout: input (T + d, 2 n_rx),
the received waveform; target (T + d, 2 n_tx), the delayed teacher
waveform. Each is trained per coherence block on that block's pilot and
detects by predicting the waveform, slicing the delay, FFT and 1/sqrt(Pi).
CNN, RNN and FNN train with 50 full-batch Adam epochs on the one pilot
sequence, one model a block, all blocks at once (models/zoo.py:
train_stacked, train_gru_blocks); the ELM is one shared random layer with a batched
closed-form readout. NMSE: per block ||pred - target||^2 /
||target||^2, train over the pilot, test over the D data symbols, the
ESN's by the reference's nmse_for_delay (models/esn_mimo.py:esn_nmse);
sums over blocks are returned.

`zoo_round` is the round with every counter left on the device; two
callers run it. `run_zoo_blocks` runs it eagerly and reads the counters.
`ZooRounds`, the body of parallel/montecarlo.py:make_zoo_step and so of
the compare2x2 CLI, captures it on the card as one CUDA graph,
`zoo.round`, which reads its Eb/N0 row and keys from buffers and writes
its counters into others. The GRU trains and predicts through K7
(ops/gru_cuda.py, csrc/gru_train.cu: one launch an epoch for every
block's gradients) on the card and through its plain batched version
elsewhere, and Adam takes its capturable form on the card, so both
callers compute the same round on every device: the step equals
`run_zoo_blocks` on the same keys.

On the card the ESN's fits run K3 and its detection and both NMSEs K2,
as on every other path; the CNN's and FNN's training and predictions are
PyTorch library calls (torch.func.vmap over the blocks), as the JAX
package runs them in XLA.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SimConfig
from ..models import zoo
from ..models.elm import elm_fit, init_elm
from ..models.esn import key_seed_tensor
from ..models.esn_mimo import _deinterleave_reim, build_esn_io, esn_nmse
from ..ops import gru_cuda, symbols_to_bits_hard
from ..utils import rng
from ..utils.device import resolve_device
from ..utils.metrics import PhaseClock
from .common import (_K_DETECT, EbnoRow, _as_row, data_bits_for_blocks,
                     detect_data_symbols, row_view, synth_block)
from .graphs import Body

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


def _nmse_sum(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Sum over blocks (the leading axis) of ||pred - target||^2 /
    ||target||^2, a 0-d float32 tensor."""
    err = (pred - target).pow(2).flatten(1).sum(1)
    ref = target.pow(2).flatten(1).sum(1) + 1e-12
    return (err / ref).sum()


def _no_mark(phase: str):
    """The phase mark of an untimed round."""


def zoo_round(cfg: SimConfig, ebno_db: float | EbnoRow, bkeys: torch.Tensor,
              epochs: int = 50, mark=_no_mark) -> ZooCounts:
    """B coherence blocks with the eight detectors of DETECTORS, every
    counter a tensor on the keys' device (bit errors int64, NMSE sums
    float32; total_bits and n_blocks ints): nothing reads the card on the
    host, so a CUDA graph can capture it (ZooRounds). ebno_db a float or
    its EbnoRow on the keys' device. `mark(phase)` is called as each phase
    ends: synth, esn_fit, detect, cnn, rnn, fnn, elm, preds, nmse, bits.
    The GRU trains and predicts through ops/gru_cuda.py (K7 on the card,
    its plain version elsewhere); on the card Adam takes its capturable
    form, as a CUDA graph captures the round there (ZooRounds)."""
    if cfg.esn.rng_mode != "batch":
        raise ValueError("the zoo round takes EsnConfig.rng_mode 'batch' "
                         f"only, not {cfg.esn.rng_mode!r}")
    ofdm = cfg.ofdm
    N, cp, m = ofdm.n_subcarriers, ofdm.cp_len, ofdm.bits_per_symbol
    n_tx, n_rx = cfg.channel.n_tx, cfg.channel.n_rx
    D = cfg.data_symbols_per_block
    B = bkeys.shape[0]
    T = N + cp
    delay = cfg.esn.shared_delay(ofdm.isi_duration)
    row = _as_row(cfg, ebno_db, bkeys.device, cfg.esn.input_scaler)
    capturable = bkeys.is_cuda

    state, (y_cp, x_cp) = synth_block(cfg, row, bkeys, return_pilot=True,
                                      mark=mark)
    code_bits, _ = data_bits_for_blocks(cfg, bkeys, D, None)
    data, (y_cp_d, x_cp_d) = detect_data_symbols(
        cfg, state, row, bkeys, code_bits,
        detectors=("esn", "zf_perfect", "zf_ls", "mmse"), return_td=True)
    mark("detect")

    # the pilot in the ESN's layout, standardised per block for the NN and
    # ELM models with the population std (jnp.std); the reference fits the
    # mean and std on the pilot and applies them at detection
    # (Demo_MIMO_2x2_all_DL_model_comparion.py:163-170)
    X_in, X_out = build_esn_io(y_cp, x_cp, delay)        # (B, T+d, 2n_*)
    feat_mu = X_in.mean(1, keepdim=True)
    feat_sd = X_in.std(1, keepdim=True, correction=0) + 1e-9
    X_in_std = (X_in - feat_mu) / feat_sd

    kc, kr, kf, ke = rng.split(rng.fold_key(bkeys[0], _K_ZOO), 4).unbind(0)

    def win(x):
        return zoo.window_flatten(x, WINDOW)

    X, Y = X_in_std[:, None], X_out[:, None]    # one pilot sequence a block
    # each trained model as a function of (B, ..., 2 n_rx) inputs; every
    # init draws all B blocks' models at once from their split keys
    nets = {}
    cnn = zoo.block_models(zoo.cnn_apply, zoo.cnn_init(
        rng.split(kc, B), 2 * n_rx, 2 * n_tx, channels=(32, 32)))
    zoo.train_stacked(cnn, X, Y, epochs, 3e-3, capturable)
    nets["cnn"] = lambda x: zoo.apply_per_block(cnn, x)
    mark("cnn")
    gru_init = zoo.gru_weights(zoo.rnn_init(rng.split(kr, B), 2 * n_rx, 32,
                                            2 * n_tx))
    w_rnn = zoo.train_gru_blocks(gru_init, X, Y, epochs, 1e-2,
                                 capturable).params
    nets["rnn"] = lambda x: gru_cuda.predict(
        x.reshape(B, -1, *x.shape[-2:]), w_rnn).reshape(*x.shape[:-1], -1)
    mark("rnn")
    fnn = zoo.block_models(zoo.mlp_apply, zoo.mlp_init(
        rng.split(kf, B), (WINDOW * 2 * n_rx, 64, 2 * n_tx)))
    zoo.train_stacked(fnn, win(X), Y, epochs, 3e-3, capturable)
    nets["fnn"] = lambda x: zoo.apply_per_block(fnn, win(x))
    mark("fnn")
    elm_p = elm_fit(init_elm(ke, WINDOW * 2 * n_rx, 128, 2 * n_tx),
                    win(X_in_std), X_out)               # batched closed form
    mark("elm")

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
                                     cp, N, row.sqrt_pi).reshape(B, D, N,
                                                                 n_tx)
    mark("preds")

    res, scale, W = state.reservoir, state.scale_m, state.Wt_out_m
    prec = cfg.esn.recurrence_precision
    train_nmse["esn"] = esn_nmse(
        res, scale, W, y_cp, x_cp, delay, cp, ofdm.isi_duration,
        key_seed_tensor(rng.fold_key(bkeys[0], _K_ZOO, 1)), prec).sum()
    test_nmse["esn"] = esn_nmse(
        res, scale, W, y_cp_d.reshape(B * D, n_rx, T),
        x_cp_d.reshape(B * D, n_tx, T), delay, cp, ofdm.isi_duration,
        key_seed_tensor(rng.fold_key(bkeys[0], _K_DETECT, 2)),
        prec).reshape(B, D).mean(1).sum()
    mark("nmse")

    bit_errors = {
        name: (symbols_to_bits_hard(Xh.transpose(-1, -2), m)
               != code_bits).sum()
        for name, Xh in X_hat.items()}
    mark("bits")
    # keys in sorted order, as the JAX package's jitted run returns them
    return ZooCounts(bit_errors=dict(sorted(bit_errors.items())),
                     total_bits=code_bits.numel(),
                     train_nmse=dict(sorted(train_nmse.items())),
                     test_nmse=dict(sorted(test_nmse.items())), n_blocks=B)


def host_zoo(c: ZooCounts) -> ZooCounts:
    """ZooCounts of host numbers (ints, floats) from one of tensors."""
    def py(v):
        if not isinstance(v, torch.Tensor):
            return v
        return float(v) if v.is_floating_point() else int(v)
    return ZooCounts(*({k: py(v) for k, v in x.items()}
                       if isinstance(x, dict) else py(x) for x in c))


def run_zoo_blocks(cfg: SimConfig, ebno_db: float, bkeys, epochs: int = 50,
                   device=None, timings: dict | None = None) -> ZooCounts:
    """B coherence blocks with the eight detectors of DETECTORS, eagerly,
    every counter read on the host. bkeys (B, 2) per-block keys (numpy or
    tensor, utils.rng.block_keys). `device` defaults to "cuda" and raises
    without CUDA unless "cpu" is asked for. `timings`, when given, receives
    each phase's wall ms: synth (channel, pilot, the ESN fits), detect,
    cnn, rnn, fnn, elm (training), preds (the zoo's predictions), nmse (the
    ESN's two) and bits. The ESN's NMSEs take one batch-shared reservoir:
    EsnConfig.rng_mode "block" is refused, as the JAX package's
    run_zoo_blocks cannot take it either."""
    dev = resolve_device(device)
    bkeys = rng.as_keys(bkeys, dev)
    clock = PhaseClock(dev, timings)

    def mark(phase):                    # synth runs to the ESN fits' end
        if phase != "synth":
            clock.mark("synth" if phase == "esn_fit" else phase)
    return host_zoo(zoo_round(cfg, ebno_db, bkeys, epochs, mark))


# the phase ends captured into the zoo round's graph: its clock starts at
# the end of synth and times the ESN fit, detect and each model's training
ZOO_MARKS = ("synth", "esn_fit", "detect", "cnn", "rnn", "fnn", "elm")
MODELS = ("cnn", "elm", "esn", "fnn", "rnn")


class ZooRounds:
    """The 2x2 model-zoo round's body for rounds of G blocks on one device
    (parallel/montecarlo.py:make_zoo_step). The body reads the Eb/N0 row
    from `row` (7,) and the round's keys from `keys` (G, 2), runs
    `zoo_round` and writes its counters into buffers made before any
    capture: bit_errors (8,) int64 (DETECTORS in sorted order) and nmse (2,
    5) float32 (train and test, MODELS). Every model's weights and Adam's
    moments are the round's own temporaries, drawn from the keys and
    initialised inside the body each time it runs.

    On the card it is captured once as a CUDA graph named `zoo.round`
    (pipelines/graphs.py: its spans and record; ZOO_MARKS as event nodes)
    after one eager call on a side stream, and replayed. On the CPU it runs
    eagerly. On every device it computes what `run_zoo_blocks` computes on
    the same keys."""

    def __init__(self, cfg: SimConfig, G: int, dev: torch.device,
                 epochs: int = 50):
        self.cfg, self.G, self.dev, self.epochs = cfg, G, dev, epochs
        self.row = torch.zeros(7, dtype=torch.float32, device=dev)
        self.keys = torch.zeros(G, 2, dtype=torch.int64, device=dev)
        self.bit_errors = torch.zeros(len(DETECTORS), dtype=torch.int64,
                                      device=dev)
        self.nmse = torch.zeros(2, len(MODELS), dtype=torch.float32,
                                device=dev)
        self.body = None

    def _round(self, mark=None):
        c = zoo_round(self.cfg, row_view(self.row), self.keys, self.epochs,
                      mark or _no_mark)
        for i, d in enumerate(sorted(DETECTORS)):
            self.bit_errors[i].copy_(c.bit_errors[d])
        for j, table in enumerate((c.train_nmse, c.test_nmse)):
            for i, k in enumerate(MODELS):
                self.nmse[j, i].copy_(table[k])

    def run(self, timings: dict | None = None):
        """One round on the keys and row in the buffers: the body captured
        on first use, then replayed. `timings`, when given, receives each
        phase's ms: on the card the device ms of ZOO_MARKS' phases of this
        replay (the host waits for it), on the CPU the wall ms of every
        phase of an eager run."""
        if self.body is None:
            self.body = Body(self._round, "zoo.round", self.dev,
                             marks=ZOO_MARKS)
        if timings is not None and self.dev.type != "cuda":
            self._round(PhaseClock(self.dev, timings).mark)
            return
        self.body.run()
        if timings is not None:
            for phase, ms in self.body.last_phases():
                timings[phase] = timings.get(phase, 0.0) + ms

    def counts(self) -> ZooCounts:
        """ZooCounts of clones of the buffers (tensors on the device)."""
        bits, nmse = self.bit_errors.clone(), self.nmse.clone()
        return ZooCounts(
            bit_errors=dict(zip(sorted(DETECTORS), bits)),
            total_bits=(self.G * self.cfg.data_symbols_per_block
                        * self.cfg.channel.n_tx
                        * self.cfg.ofdm.n_subcarriers
                        * self.cfg.ofdm.bits_per_symbol),
            train_nmse=dict(zip(MODELS, nmse[0])),
            test_nmse=dict(zip(MODELS, nmse[1])), n_blocks=self.G)

    def capture_stats(self):
        """(the capture's host ms, bytes the pool grew by)."""
        if self.body is None:
            return 0.0, 0
        return self.body.capture_ms, self.body.pool_bytes

    def release(self):
        if self.body is not None:
            self.body.release()
            self.body = None
