"""The regression ELM of the 2x2 comparison in plain PyTorch, written for
the benchmark's reference (system_model_2_all_comparision.py:51-69): one
random tanh layer shared by every block, its readout fitted per block in
closed form by the Newton-Schulz solve of ops/linalg.py on the
ridge-jittered Gram H^T H (the JAX package's ELM, models/elm.py)."""
from __future__ import annotations

import numpy as np
import torch

from ..ops.linalg import ns_solver
from ..utils import rng


def init_elm(key: torch.Tensor, n_in: int, n_hidden: int):
    """(W1 (n_hidden, n_in) ~ N(0, 1 / n_in), b1 (n_hidden,) ~ N(0, 1))."""
    kw, kb = rng.split(key)
    W1 = rng.normal(kw, (n_hidden, n_in)) / float(np.float32(np.sqrt(n_in)))
    return W1, rng.normal(kb, (n_hidden,))


def hidden(W1: torch.Tensor, b1: torch.Tensor, X: torch.Tensor):
    return torch.tanh(X @ W1.T + b1)


def elm_fit(W1, b1, X: torch.Tensor, Y: torch.Tensor,
            ridge: float = 1e-6) -> torch.Tensor:
    """The readout W2 (B, n_hidden, n_out) of X (B, S, n_in), Y (B, S,
    n_out): (H^T H + ridge tr(H^T H) / n_hidden I) W2 = H^T Y."""
    H = hidden(W1, b1, X)
    A = H.transpose(-1, -2) @ H
    nh = A.shape[-1]
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)[..., None, None] / nh
    A = A + ridge * tr * torch.eye(nh, dtype=A.dtype, device=A.device)
    return ns_solver(A, iters=40)(H.transpose(-1, -2) @ Y)
