"""The 2x2 comparison's per-block trained models in plain PyTorch, written
for the benchmark's reference and independent of the program: a CNN, a
GRU and an FNN (system_model_2_all_comparision.py:14-49; the JAX package's
zoo, models/zoo.py), each model b trained on block b's data alone with
full-batch Adam.

B models of one structure are held as tensors stacked along a leading
block axis, and applied with batched matrix products: no torch.func, no
convolution or recurrent library call. The CNN's SAME-padded
cross-correlation is an explicit window sum, the GRU the explicit time
loop of the program's plain `rnn_apply` (gate order r, z, n; an input
bias only; r applied to h W_h inside n), the gradients autograd's. Adam is
written out as the paper states it (Kingma and Ba, Algorithm 1: lr, betas
(0.9, 0.999), eps 1e-8, bias-corrected moments).

The inits draw through the threefry stream of utils/rng.py from the
blocks' split keys, with the JAX package's initialisers: a dense weight
(n_in, n_out) ~ N(0, 2 / n_in) (the GRU's and the CNN head's N(0, 1 /
n_in)), a conv weight (k, c_in, c_out) ~ N(0, 2 / (k c_in)), zero biases.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..utils import rng


def _scale(var: float) -> float:
    """sqrt(var) in float32 of var rounded to float32."""
    return float(np.sqrt(np.float32(var)))


def _normal(keys: torch.Tensor, shape, var: float) -> torch.Tensor:
    return rng.normal(keys, shape) * _scale(var)


def _zeros(keys: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(*keys.shape[:-1], n, device=keys.device)


def _split(keys: torch.Tensor, n: int = 2):
    return rng.split(keys, n).unbind(-2)


def cnn_init(keys: torch.Tensor, n_in: int, n_out: int, channels=(32, 32),
             kernel: int = 3) -> dict:
    """keys (B, 2) -> {"convs": [(w (B, k, c_in, c), b (B, c))], "head":
    (w (B, c, n_out), b (B, n_out))}."""
    convs, c_prev = [], n_in
    for c in channels:
        kw, keys = _split(keys)
        convs.append((_normal(kw, (kernel, c_prev, c), 2.0 / (kernel * c_prev)),
                      _zeros(keys, c)))
        c_prev = c
    kw, keys = _split(keys)
    return {"convs": convs, "head": (_normal(kw, (c_prev, n_out), 1.0 / c_prev),
                                     _zeros(keys, n_out))}


def cnn_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, T, n_in) -> (B, S, T, n_out): per block, each conv layer
    out[t] = relu(b + sum_j x[t + j - (k - 1) // 2] w[j]) with zeros
    outside [0, T), then the dense head at every step."""
    T = x.shape[-2]
    h = x
    for w, b in p["convs"]:
        k = w.shape[1]
        lo = (k - 1) // 2
        hp = torch.nn.functional.pad(h, (0, 0, lo, k - 1 - lo))
        acc = b[:, None, None]
        for j in range(k):
            acc = acc + hp[:, :, j:j + T] @ w[:, None, j]
        h = torch.relu(acc)
    w, b = p["head"]
    return h @ w[:, None] + b[:, None, None]


def mlp_init(keys: torch.Tensor, sizes) -> list:
    """keys (B, 2) -> [(w (B, a, b), b (B, b))] for sizes (a, ..., b)."""
    layers = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        kw, keys = _split(keys)
        layers.append((_normal(kw, (a, b), 2.0 / a), _zeros(keys, b)))
    return layers


def mlp_apply(p: list, x: torch.Tensor) -> torch.Tensor:
    """tanh hidden layers and a linear output, block b's weights on x[b]:
    x (B, S, T, n_in)."""
    for i, (w, b) in enumerate(p):
        x = x @ w[:, None] + b[:, None, None]
        if i < len(p) - 1:
            x = torch.tanh(x)
    return x


def gru_init(keys: torch.Tensor, n_in: int, n_hidden: int,
             n_out: int) -> dict:
    """keys (B, 2) -> wi (B, n_in, 3 nh), wh (B, nh, 3 nh), bi (B, 3 nh)
    and the head (w (B, nh, n_out), b (B, n_out))."""
    k1, k2, k3 = _split(keys, 3)
    return {"wi": _normal(k1, (n_in, 3 * n_hidden), 1.0 / n_in),
            "wh": _normal(k2, (n_hidden, 3 * n_hidden), 1.0 / n_hidden),
            "bi": _zeros(keys, 3 * n_hidden),
            "head": (_normal(k3, (n_hidden, n_out), 1.0 / n_hidden),
                     _zeros(keys, n_out))}


def gru_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, T, n_in) -> (B, S, T, n_out): the GRU from h = 0 over the
    T steps, then the head."""
    wi, wh, bi = p["wi"], p["wh"], p["bi"]
    nh = wh.shape[-2]
    B, S, T = x.shape[:3]
    gi = x @ wi[:, None] + bi[:, None, None]
    h = torch.zeros(B, S, nh, device=x.device)
    hs = []
    for t in range(T):
        g, gh = gi[:, :, t], h @ wh
        r = torch.sigmoid(g[..., :nh] + gh[..., :nh])
        z = torch.sigmoid(g[..., nh:2 * nh] + gh[..., nh:2 * nh])
        n = torch.tanh(g[..., 2 * nh:] + r * gh[..., 2 * nh:])
        h = (1 - z) * n + z * h
        hs.append(h)
    w, b = p["head"]
    return torch.stack(hs, dim=-2) @ w[:, None] + b[:, None, None]


def leaves(p) -> list:
    """The tensors of a parameter tree, in a fixed order."""
    if isinstance(p, torch.Tensor):
        return [p]
    if isinstance(p, dict):
        return [t for k in sorted(p) for t in leaves(p[k])]
    return [t for q in p for t in leaves(q)]


def rebuild(p, ts: list):
    """The tree `p` with its leaves replaced by `ts`, in `leaves`' order."""
    it = iter(ts)

    def walk(q):
        if isinstance(q, torch.Tensor):
            return next(it)
        if isinstance(q, dict):
            return {k: walk(q[k]) for k in sorted(q)}
        return type(q)(walk(v) for v in q)
    return walk(p)


def train(apply_fn: Callable, p, X: torch.Tensor, Y: torch.Tensor,
          epochs: int, lr: float):
    """`epochs` full-batch Adam steps of every block's model on its own
    mean squared error: X (B, S, T, n_in), Y (B, S, T, n_out). Returns the
    trained tree."""
    ws = [t.detach().clone().requires_grad_() for t in leaves(p)]
    m = [torch.zeros_like(t) for t in ws]
    v = [torch.zeros_like(t) for t in ws]
    b1, b2, eps = 0.9, 0.999, 1e-8
    B = X.shape[0]
    for step in range(1, epochs + 1):
        with torch.enable_grad():
            loss = ((apply_fn(rebuild(p, ws), X) - Y) ** 2).reshape(
                B, -1).mean(1).sum()
            grads = torch.autograd.grad(loss, ws)
        with torch.no_grad():
            for t, g, mt, vt in zip(ws, grads, m, v):
                mt.mul_(b1).add_((1 - b1) * g)
                vt.mul_(b2).add_((1 - b2) * g * g)
                m_hat = mt / (1 - b1 ** step)
                v_hat = vt / (1 - b2 ** step)
                t.sub_(lr * m_hat / (v_hat.sqrt() + eps))
    return rebuild(p, [t.detach() for t in ws])


def window_flatten(x: torch.Tensor, window: int = 8) -> torch.Tensor:
    """(..., T, F) -> (..., T, window F): the causal window of the last
    `window` steps (zeros before the first), oldest first."""
    T = x.shape[-2]
    xp = torch.nn.functional.pad(x, (0, 0, window - 1, 0))
    return torch.cat([xp[..., t:t + T, :] for t in range(window)], dim=-1)
