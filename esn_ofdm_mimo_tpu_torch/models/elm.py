"""Extreme Learning Machine: random hidden layer + closed-form readout (port
of esn_ofdm_mimo_tpu/models/elm.py).

Two variants of the reference: the regression ELM on window-flattened
time-domain samples (system_model_2_all_comparision.py:51-69) and the
classification ELM on equalized symbols (esn_via_cdl_all_model.py:180-195:
one-hot targets, argmax prediction).

The readout solves the ridge-jittered Gram H^T H by the JAX package's
Newton-Schulz iteration (ops/linalg.py:ns_solver, 40 iterations), not by a
factorisation: the Gram of 600 tanh features of a 2-D input is numerically
singular, so the iteration's implicit regularisation is the result, and
a factorisation would give another readout.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.linalg import ns_solver
from ..utils import rng


class ElmParams(NamedTuple):
    W1: torch.Tensor    # (n_hidden, n_in)
    b1: torch.Tensor    # (n_hidden,)
    W2: torch.Tensor    # (n_hidden, n_out) readout (trained)


def init_elm(key: torch.Tensor, n_in: int, n_hidden: int, n_out: int
             ) -> ElmParams:
    """Draws on the key's device: W1 ~ N(0, 1/n_in), b1 ~ N(0, 1), W2 = 0."""
    kw, kb = rng.split(key)
    W1 = rng.normal(kw, (n_hidden, n_in)) / float(np.float32(np.sqrt(n_in)))
    b1 = rng.normal(kb, (n_hidden,))
    return ElmParams(W1=W1, b1=b1,
                     W2=torch.zeros(n_hidden, n_out, device=key.device))


def _hidden(p: ElmParams, X: torch.Tensor) -> torch.Tensor:
    return torch.tanh(X @ p.W1.T + p.b1)


def elm_fit(p: ElmParams, X: torch.Tensor, Y: torch.Tensor,
            ridge: float = 1e-6) -> ElmParams:
    """X (..., S, n_in), Y (..., S, n_out) -> trained params (batched)."""
    H = _hidden(p, X)
    A = H.transpose(-1, -2) @ H
    nh = A.shape[-1]
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)[..., None, None] / nh
    A = A + ridge * tr * torch.eye(nh, dtype=A.dtype, device=A.device)
    W2 = ns_solver(A, iters=40)(H.transpose(-1, -2) @ Y)
    return p._replace(W2=W2)


def elm_predict(p: ElmParams, X: torch.Tensor) -> torch.Tensor:
    return _hidden(p, X) @ p.W2


def elm_fit_classifier(p: ElmParams, X: torch.Tensor, labels: torch.Tensor,
                       n_classes: int, ridge: float = 1e-6) -> ElmParams:
    Y = torch.nn.functional.one_hot(labels.long(), n_classes).to(X.dtype)
    return elm_fit(p, X, Y, ridge)


def elm_classify(p: ElmParams, X: torch.Tensor) -> torch.Tensor:
    return torch.argmax(elm_predict(p, X), dim=-1)
