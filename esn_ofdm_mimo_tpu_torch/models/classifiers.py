"""Symbol classifiers of system model 1 (port of
esn_ofdm_mimo_tpu/models/classifiers.py).

The reference trains seven models to classify LMMSE-equalized complex
symbols into 16-QAM indices (esn_via_cdl_all_model.py:98-195):
  * traditional: nearest-constellation demapper (SymbolDemapper);
  * ESN single-step: a stateless random-reservoir feature map
    tanh(x W_in) with a trainable softmax readout (:98-121);
  * DeepESN: the same features -> trainable ReLU layer -> softmax
    (:123-152);
  * FNN / CNN / RNN models (:154-178);
  * ELM: closed-form one-hot readout (:180-195), in models/elm.py.

Each other model is an (init, apply) pair over inputs (..., 2) = (re, im) on the zoo's
parameter trees (models/zoo.py); the fixed reservoir W_in is a buffer of
the tree, so training leaves it as drawn.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..ops.qam import hard_demap_index
from ..utils import rng
from . import zoo


def traditional_demap(symbols: torch.Tensor, bits_per_symbol: int
                      ) -> torch.Tensor:
    """(...,) complex -> class index, the reference's SymbolDemapper."""
    return hard_demap_index(symbols, bits_per_symbol)


class EsnClassifierParams(NamedTuple):
    W_in: torch.Tensor    # (2, n_res) fixed random input weights, U(-0.1, 0.1)
    W_out: torch.Tensor   # (n_res, n_classes) trainable readout, zero init
    b_out: torch.Tensor   # (n_classes,)


def esn_classifier_init(key: torch.Tensor, n_res: int = 600,
                        n_classes: int = 16) -> EsnClassifierParams:
    """Reference ESNSingleStep init (:99-114): W_in ~ U(-0.1, 0.1) fixed,
    W_out zeros; the state is reset every call, so the reservoir matrix
    never acts and is not drawn. Trainable count 600*16 + 16 = 9,616."""
    ki, _ = rng.split(key)
    dev = key.device
    return EsnClassifierParams(
        W_in=rng.uniform(ki, (2, n_res), -0.1, 0.1),
        W_out=torch.zeros(n_res, n_classes, device=dev),
        b_out=torch.zeros(n_classes, device=dev))


def esn_classifier_apply(p, x: torch.Tensor) -> torch.Tensor:
    """x (..., 2) -> logits: tanh(x W_in) features, linear readout; on
    EsnClassifierParams or its training tree."""
    return torch.tanh(x @ p.W_in) @ p.W_out + p.b_out



def esn_classifier_trainable(p: EsnClassifierParams) -> dict:
    """The trainable entries (W_in stays fixed)."""
    return {"W_out": p.W_out, "b_out": p.b_out}


def esn_classifier_params(p: EsnClassifierParams) -> zoo.Params:
    """The training tree: W_out, b_out trainable, W_in a buffer."""
    return zoo.Params(esn_classifier_trainable(p), {"W_in": p.W_in})


class DeepEsnParams(NamedTuple):
    W_in: torch.Tensor       # (2, n_res) fixed
    hidden: nn.ModuleList    # trainable ReLU layer + softmax head


def deep_esn_init(key: torch.Tensor, n_res: int = 600, n_hidden: int = 600,
                  n_classes: int = 16) -> DeepEsnParams:
    """Reference ESNSingleStepMulti, widened (:125-156): fixed reservoir
    features -> Dense(n_hidden, relu) -> Dense(16). Trainable count at 600:
    600*600+600 + 600*16+16 = 370,216."""
    ki, kh = rng.split(key)
    return DeepEsnParams(W_in=rng.uniform(ki, (2, n_res), -0.1, 0.1),
                         hidden=zoo.mlp_init(kh, (n_res, n_hidden, n_classes)))


def deep_esn_params(p: DeepEsnParams) -> zoo.Params:
    """The training tree: the head trainable, W_in a buffer."""
    return zoo.Params({"hidden": p.hidden}, {"W_in": p.W_in})


def deep_esn_apply(p, x: torch.Tensor) -> torch.Tensor:
    """On DeepEsnParams or its training tree."""
    return zoo.mlp_apply(p.hidden, torch.tanh(x @ p.W_in),
                         hidden_act=torch.relu)



def fnn_classifier_init(key: torch.Tensor, widths=(600,),
                        n_classes: int = 16) -> nn.ModuleList:
    """Reference build_simple_fc_16, widened (:158-163): Dense(600, relu)
    -> Dense(16); 11,416 trainables (the reference prints a hardcoded
    12,160, :231)."""
    return zoo.mlp_init(key, (2, *widths, n_classes))


def fnn_classifier_apply(params: nn.ModuleList, x: torch.Tensor
                         ) -> torch.Tensor:
    return zoo.mlp_apply(params, x, hidden_act=torch.relu)


def cnn_classifier_init(key: torch.Tensor, n_classes: int = 16,
                        channels: int = 128, n_hidden: int = 600
                        ) -> zoo.Params:
    """Reference build_cnn_16 (:165-174): Reshape((2,1)) -> Conv1D(128,
    k=1, relu) x2 -> Flatten -> Dense(600, relu) -> Dense(16). Kernel-1
    convs over the (re, im) axis are pointwise denses applied per
    position; 180,584 trainables (the reference prints 102,864, :232)."""
    k1, k2, k3 = rng.split(key, 3)
    dev = key.device
    return zoo.Params({
        "c1": zoo.Dense(zoo.normal_init(k1, (1, channels), 2.0),
                        torch.zeros(channels, device=dev)),
        "c2": zoo.Dense(zoo.normal_init(k2, (channels, channels),
                                        2.0 / channels),
                        torch.zeros(channels, device=dev)),
        "mlp": zoo.mlp_init(k3, (2 * channels, n_hidden, n_classes)),
    })


def cnn_classifier_apply(params: zoo.Params, x: torch.Tensor
                         ) -> torch.Tensor:
    """x (..., 2) -> logits: per-position pointwise convs, then flatten."""
    h = torch.relu(params.c1(x[..., None]))            # (..., 2, C)
    h = torch.relu(params.c2(h))
    h = h.reshape(*x.shape[:-1], -1)                    # (..., 2C)
    return zoo.mlp_apply(params.mlp, h, hidden_act=torch.relu)


def rnn_classifier_init(key: torch.Tensor, n_hidden: int = 600,
                        n_classes: int = 16) -> zoo.Params:
    """Reference build_rnn_16 (:176-182): SimpleRNN(600) over a length-1
    sequence -> Dense(600, relu) -> Dense(16). With one step from a zero
    state the recurrence is tanh(x W_x + b); the recurrent kernel W_h stays
    a parameter (zero gradient, as in Keras) so the count matches the
    architecture: 732,016."""
    k1, k2, k3 = rng.split(key, 3)
    return zoo.Params({
        "wx": zoo.normal_init(k1, (2, n_hidden), 1.0 / 2),
        "wh": zoo.normal_init(k2, (n_hidden, n_hidden), 1.0 / n_hidden),
        "b": torch.zeros(n_hidden, device=key.device),
        "mlp": zoo.mlp_init(k3, (n_hidden, n_hidden, n_classes)),
    })


def rnn_classifier_apply(params: zoo.Params, x: torch.Tensor
                         ) -> torch.Tensor:
    h = torch.tanh(x @ params.wx + params.b)
    return zoo.mlp_apply(params.mlp, h, hidden_act=torch.relu)

