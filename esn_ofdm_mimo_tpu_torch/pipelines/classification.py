"""System-model-1 classification pipeline: train a zoo of symbol classifiers
on LMMSE-equalized symbols over the 4x8 CDL channel (port of
esn_ofdm_mimo_tpu/pipelines/classification.py).

The reference's Sionna chain (esn_ofdm_mimo_via_cdl.py /
esn_via_cdl_all_model.py): bits -> 5G LDPC -> Gray 16-QAM -> resource grid
-> CDL -> LS estimate -> LMMSE -> flatten (re, im) -> 80/20 split -> seven
classifiers -> SER/BER (reference :240-299). Two dataset frontends:
  * "sm1" (`make_equalized_dataset_sm1`): the reference's operating point
    (sm1/: 5G grid, spatial CDL-B, LS-nn, unbiased LMMSE; NR LDPC
    codewords; Gray labels);
  * "sm2" (`make_equalized_dataset`): the framework's own comb-pilot CDL
    link (pipelines/common.py), MMSE symbol estimates, natural labels. Its
    ESN fit runs the state-harvest kernel on the card.

Every draw folds from the root key with the JAX package's tags (55 for the
sm1 dataset, 77 for the split, 88 for the zoo), so labels, pilots and the
split equal the JAX package's bit for bit. The zoo trains in fp32 with
TF32 off, full-batch Adam (models/zoo.py).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..config import SimConfig
from ..ldpc import nr
from ..models import classifiers as clf
from ..models import elm
from ..models.zoo import train_classifier
from ..ops.qam import (bits_to_index_msb, hard_demap_index,
                       hard_demap_index_gray, qam_bit_labels,
                       qam_bit_labels_msb, qam_constellation_gray)
from ..sm1 import cdl as sm1_cdl
from ..sm1 import grid as sm1_grid
from ..sm1 import rx as sm1_rx
from ..utils import rng
from ..utils.device import resolve_device
from ..utils.metrics import PhaseClock
from .common import data_bits_for_blocks, detect_data_symbols, synth_block


class SymbolDataset(NamedTuple):
    """Equalized symbols with true class labels, flattened to (re, im)."""
    x: torch.Tensor        # (S, 2) float32 features
    labels: torch.Tensor   # (S,) int64 true constellation indices


def make_equalized_dataset(cfg: SimConfig, ebno_db: float,
                           bkeys: torch.Tensor) -> SymbolDataset:
    """Blocks (keys (B, 2)) through the framework's link, MMSE-equalized,
    flattened (reference :252-281)."""
    m = cfg.ofdm.bits_per_symbol
    state = synth_block(cfg, ebno_db, bkeys)
    code_bits, _ = data_bits_for_blocks(cfg, bkeys,
                                        cfg.data_symbols_per_block, None)
    data = detect_data_symbols(cfg, state, ebno_db, bkeys, code_bits,
                               detectors=("mmse",))
    z = data.X_hat["mmse"].reshape(-1)
    labels = hard_demap_index(data.X_true.reshape(-1), m)
    return SymbolDataset(x=torch.stack([z.real, z.imag], -1).float(),
                         labels=labels)


def make_equalized_dataset_sm1(ebno_db: float, key: torch.Tensor,
                               batch: int = 64, bits_per_symbol: int = 4,
                               coderate: float = 0.5,
                               rg: sm1_grid.ResourceGrid | None = None,
                               cdl_cfg: sm1_cdl.CdlConfig | None = None,
                               timings: dict | None = None
                               ) -> SymbolDataset:
    """The reference's system-model-1 dataset (esn_ofdm_mimo_via_cdl.py
    :235-262) on the key's device: uniform info bits -> NR LDPC (k = D m R,
    E = D m: BG2, Z = 160) -> Gray 16-QAM -> resource grid with kronecker
    pilots -> spatial CDL-B -> per-RE channel + AWGN -> LS(nn) -> unbiased
    LMMSE -> flatten (re, im) with MSB-first index labels. The reference
    never calls its LDPC decoder (encoder-only path).

    `timings`, when given, receives the wall ms of each step: code (the
    host's NR code construction, cached after the first call), draw_bits,
    encode, pilots, channel (CDL draw and frequency response), noise (its
    draw and the per-RE apply), estimate, lmmse, flatten."""
    rg = rg or sm1_grid.ResourceGrid(num_streams=4)
    cdl_cfg = cdl_cfg or sm1_cdl.CdlConfig()
    m = bits_per_symbol
    clock = PhaseClock(key.device, timings)
    k_bits, k_pil, k_ch, k_noise = rng.split(key, 4)

    no = sm1_grid.ebnodb2no(ebno_db, m, coderate, rg)
    S, D = rg.num_streams, rg.num_data_symbols
    code = nr.make_nr_ldpc(int(D * m * coderate), D * m)
    clock.mark("code")
    u = rng.randint(k_bits, (batch, S, code.k), 0, 2)
    clock.mark("draw_bits")
    labels = bits_to_index_msb(nr.nr_encode(code, u), m)   # (B, S, D)
    clock.mark("encode")
    x_data = qam_constellation_gray(m, key.device)[labels]
    pilots = rg.pilot_grid(k_pil)
    x_rg = rg.map_data(x_data, pilots)                     # (B, S, T, F)
    clock.mark("pilots")

    # spatial CDL-B at the grid's symbol rate, evaluated on the effective bins
    a, tau = sm1_cdl.cdl_cir(cdl_cfg, k_ch, batch, rg.num_ofdm_symbols,
                             1.0 / rg.ofdm_symbol_duration)
    freqs = sm1_grid.subcarrier_frequencies(rg)[rg.effective_subcarriers]
    h = sm1_cdl.cir_to_ofdm_channel(freqs, a, tau)         # (B, T, F, U, S)
    clock.mark("channel")

    # per-RE apply + AWGN: y[b,t,f,u] = sum_s h x + n  (ApplyOFDMChannel)
    xg = torch.movedim(x_rg, 1, -1)                        # (B, T, F, S)
    y = torch.sum(h * xg[..., None, :], dim=-1)
    n = rng.normal(k_noise, (2, *y.shape))
    y = y + float(np.sqrt(np.float32(no) / np.float32(2.0))) \
        * torch.complex(n[0], n[1])
    clock.mark("noise")

    h_hat, err_var = sm1_rx.ls_nn_estimate(rg, y, pilots, no)
    clock.mark("estimate")
    x_hat, _ = sm1_rx.lmmse_equalize_grid(h_hat, y, err_var, no)
    clock.mark("lmmse")
    # data REs only, stream-major flatten (B, S, T_data, F) like the
    # reference's x_hat tensor [batch, tx, stream, num_data_symbols]
    z = rg.extract_data(torch.movedim(x_hat, -1, 1)).reshape(-1)
    ds = SymbolDataset(x=torch.stack([z.real, z.imag], -1).float(),
                       labels=labels.reshape(-1))
    clock.mark("flatten")
    return ds


def split_dataset(ds: SymbolDataset, key: torch.Tensor,
                  train_frac: float = 0.8
                  ) -> Tuple[SymbolDataset, SymbolDataset]:
    """Random 80/20 split (reference :268-281) by the port's bit-exact
    jax.random.permutation."""
    S = ds.x.shape[0]
    perm = rng.permutation(key, S)
    n_tr = int(S * train_frac)
    tr, te = perm[:n_tr], perm[n_tr:]
    return (SymbolDataset(ds.x[tr], ds.labels[tr]),
            SymbolDataset(ds.x[te], ds.labels[te]))


def count_params(tree) -> int:
    """Trainable parameter count (the reference prints this table,
    esn_via_cdl_all_model.py:229-236): a module's parameters (not its
    buffers), a tensor's elements, or the sum over a dict, list or tuple
    of them."""
    if isinstance(tree, torch.nn.Module):
        return sum(p.numel() for p in tree.parameters())
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    if isinstance(tree, dict):
        tree = list(tree.values())
    return sum(count_params(t) for t in tree)


def _ser_ber(pred_idx: torch.Tensor, true_idx: torch.Tensor, m: int,
             msb: bool = False) -> Tuple[float, float]:
    labels = (qam_bit_labels_msb if msb else qam_bit_labels)(
        m, pred_idx.device)
    ser = (pred_idx != true_idx).float().mean()
    ber = (labels[pred_idx] != labels[true_idx]).float().mean()
    return float(ser), float(ber)


# the reference ships two sm1 experiment variants with different baseline
# widths: esn_via_cdl_all_model.py ("wide", ~600 units, :125-182) and
# esn_ofdm_mimo_via_cdl.py ("narrow", :123-178)
ZOO_VARIANTS = {
    "wide": dict(deep_hidden=600, fnn_width=600, cnn_channels=128,
                 cnn_hidden=600, rnn_hidden=600),
    "narrow": dict(deep_hidden=128, fnn_width=32, cnn_channels=16,
                   cnn_hidden=64, rnn_hidden=64),
}


def train_and_evaluate_zoo(cfg: SimConfig, train: SymbolDataset,
                           test: SymbolDataset, key: torch.Tensor,
                           epochs: int = 200, gray: bool = False,
                           variant: str = "wide",
                           collect_preds: bool = False,
                           timings: dict | None = None):
    """Train all seven detectors, return {model: {ser, ber[, params]}} on
    the test set (reference SER/BER tables, esn_via_cdl_all_model.py:
    453-472); with collect_preds also {model: predicted test indices}
    (numpy int32).

    gray=True evaluates against the system-model-1 convention (Gray
    constellation, MSB-first labels); variant selects ZOO_VARIANTS. The
    ESN readout takes 10x the epochs at lr 1e-2, the DeepESN head 5x at
    lr 3e-3, both with l2 5e-5 on their readout (the reference's Adam + l2,
    :205-213); FNN, CNN and RNN `epochs` at lr 1e-3. `timings`, when
    given, receives each model's wall ms (training and test)."""
    widths = ZOO_VARIANTS[variant]
    m = cfg.ofdm.bits_per_symbol
    n_classes = 2 ** m
    clock = PhaseClock(train.x.device, timings)
    results = {}
    preds: Dict[str, np.ndarray] = {}

    def _keep(name, idx):
        if collect_preds:
            preds[name] = idx.cpu().numpy().astype(np.int32)

    def evaluate(name, idx):
        ser, ber = _ser_ber(idx, test.labels, m, msb=gray)
        results[name] = {"ser": ser, "ber": ber}
        _keep(name, idx)

    # traditional nearest-point demapper
    z = torch.complex(test.x[:, 0], test.x[:, 1])
    evaluate("traditional", hard_demap_index_gray(z, m) if gray
             else clf.traditional_demap(z, m))
    clock.mark("traditional")

    def eval_logits(name, apply_fn, params):
        with torch.no_grad():
            evaluate(name, torch.argmax(apply_fn(params, test.x), dim=-1))

    k1, k2, k3, k4, k5, k6, key = rng.split(key, 7)
    # ESN single-step (random features + trained softmax readout): 10x
    # full-batch steps at lr 1e-2 on the convex readout; tf.nn.l2_loss =
    # sum(w^2)/2, hence l2 = lambda/2
    p_esn = clf.esn_classifier_init(k1, n_res=600, n_classes=n_classes)
    tr = train_classifier(clf.esn_classifier_apply,
                          clf.esn_classifier_params(p_esn), train.x,
                          train.labels, epochs=10 * epochs, lr=1e-2,
                          l2=5e-5, l2_keys=("W_out",))
    eval_logits("esn", clf.esn_classifier_apply, tr.params)
    results["esn"]["params"] = count_params(
        clf.esn_classifier_trainable(p_esn))
    clock.mark("esn")

    # DeepESN (random features -> trainable ReLU head)
    p_desn = clf.deep_esn_init(k2, n_res=600, n_hidden=widths["deep_hidden"],
                               n_classes=n_classes)
    tr = train_classifier(clf.deep_esn_apply, clf.deep_esn_params(p_desn),
                          train.x, train.labels, epochs=5 * epochs, lr=3e-3,
                          l2=5e-5, l2_keys=("hidden",))
    eval_logits("deep_esn", clf.deep_esn_apply, tr.params)
    results["deep_esn"]["params"] = count_params(p_desn.hidden)
    clock.mark("deep_esn")

    # FNN / CNN / RNN at the variant's widths
    for name, params, apply_fn in (
            ("fnn", clf.fnn_classifier_init(
                k3, widths=(widths["fnn_width"],), n_classes=n_classes),
             clf.fnn_classifier_apply),
            ("cnn", clf.cnn_classifier_init(
                k4, n_classes=n_classes, channels=widths["cnn_channels"],
                n_hidden=widths["cnn_hidden"]), clf.cnn_classifier_apply),
            ("rnn", clf.rnn_classifier_init(
                k5, n_hidden=widths["rnn_hidden"], n_classes=n_classes),
             clf.rnn_classifier_apply)):
        tr = train_classifier(apply_fn, params, train.x, train.labels,
                              epochs=epochs)
        eval_logits(name, apply_fn, tr.params)
        results[name]["params"] = count_params(params)
        clock.mark(name)

    # ELM closed form
    p_elm0 = elm.init_elm(k6, 2, 600, n_classes)
    p_elm = elm.elm_fit_classifier(p_elm0, train.x, train.labels, n_classes)
    evaluate("elm", elm.elm_classify(p_elm, test.x))
    results["elm"]["params"] = count_params(p_elm0.W2)
    clock.mark("elm")

    if collect_preds:
        return results, preds
    return results


def run_classification_experiment(cfg: SimConfig, blocks: int = 8,
                                  epochs: int = 200, seed: int = 0,
                                  frontend: str = "sm1", batch: int = 64,
                                  variant: str = "wide",
                                  collect_scatter: bool = False,
                                  device=None, timings: dict | None = None):
    """Full SER/BER-vs-SNR sweep of the classifier zoo, on `device`
    ("cuda" unless "cpu" is asked for; raises without CUDA).

    frontend="sm1" (default) is the reference's Sionna operating point at
    `batch` slots per SNR (the reference's batch_size_sim = 64);
    frontend="sm2" the framework's comb-pilot CDL link, `blocks` coherence
    blocks per SNR. collect_scatter=True also returns the top-SNR test set
    and each model's predicted indices on it: (results, {"ebno_db", "x",
    "labels", "preds"}). `timings`, when given, receives {ebno_db: {phase:
    ms}}: the dataset's steps (sm1: "dataset/<step>", sm2: "dataset"),
    "split", and each model."""
    dev = resolve_device(device)
    root = rng.prng_key(seed, dev)
    gray = frontend == "sm1"
    out = {}
    scatter = None
    for jj, ebno in enumerate(cfg.ebno_db):
        ph: dict | None = None if timings is None else {}
        clock = PhaseClock(dev, ph)
        if frontend == "sm1":
            steps = None if ph is None else {}
            ds = make_equalized_dataset_sm1(
                float(ebno), rng.fold_key(root, 55, jj), batch=batch,
                bits_per_symbol=cfg.ofdm.bits_per_symbol, timings=steps)
            if ph is not None:
                ph.update({f"dataset/{k}": v for k, v in steps.items()})
        else:
            bkeys = rng.block_keys(root, jj, range(blocks))
            ds = make_equalized_dataset(cfg, float(ebno), bkeys)
        clock.mark("dataset")
        train, test = split_dataset(ds, rng.fold_key(root, 77, jj))
        clock.mark("split")
        last = collect_scatter and jj == len(cfg.ebno_db) - 1
        res = train_and_evaluate_zoo(cfg, train, test,
                                     rng.fold_key(root, 88, jj),
                                     epochs=epochs, gray=gray,
                                     variant=variant, collect_preds=last,
                                     timings=ph)
        if last:
            res, preds = res
            scatter = {"ebno_db": float(ebno),
                       "x": test.x.cpu().numpy(),
                       "labels": test.labels.cpu().numpy().astype(np.int32),
                       "preds": preds}
        out[float(ebno)] = res
        if ph is not None:
            timings[float(ebno)] = ph
    if collect_scatter:
        return out, scatter
    return out
