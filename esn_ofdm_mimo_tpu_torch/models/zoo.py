"""Small deep-model zoo in PyTorch: MLP, Conv1D-CNN, GRU-style RNN, and the
full-batch Adam loops that train them (port of
esn_ofdm_mimo_tpu/models/zoo.py).

The reference's per-block trained baselines
(Demo_MIMO_2x2_all_DL_model_comparion.py:55-107,
system_model_2_all_comparision.py:14-49) and the Sionna-pipeline
classifiers (esn_via_cdl_all_model.py:154-178).

Design, as in the JAX package: (init, apply) pairs. An init draws through
the port's RNG (utils/rng.py), so at the same key the weights equal the
JAX package's (uniform draws bit for bit, normal ones within a few ulp),
in the JAX layouts (a dense weight is (n_in, n_out), a conv weight (k,
c_in, c_out)). The parameters live in an `nn.Module` tree (`Params`,
`Dense`, `nn.ModuleList`): trainable entries are `nn.Parameter`s, frozen
ones (the JAX package's stop_gradient) buffers. An apply is a function
apply(params, x). `train_regressor` / `train_classifier` run `epochs`
full-batch steps of `torch.optim.Adam` (optax.adam's lr, betas (0.9,
0.999), eps 1e-8) on a copy of the tree and return TrainResult(params,
losses), losses being each step's loss before its update.

`train_regressor_per_block` trains B models of one structure at once, one
on each coherence block's own data (the JAX package's
`jax.vmap(train_regressor)`, pipelines/zoo2x2.py:102-123): their
parameters are stacked along a leading block axis (`BlockModels`), the
apply runs under `torch.func.vmap`, and one Adam steps on the sum over
blocks of each block's mean loss. Adam acts element by element and each
block's gradient is its own loss's, so this is B separate Adams.
`train_rnn_per_block` does the same for the GRU through `torch.nn.GRU`
(cuDNN on the card), one call a block, and returns the trained modules
(`GruBlocks`), which predict the same way; `rnn_apply` stays the plain
version they are held against. The plain loop of T steps under
vmap launches some ten kernels a step forward and as many backward, and
took ~15x cuDNN's time on an H100 at the 2x2 comparison's pilot
(chip_smoke.py's `[compare2x2 gru]` times both).
"""
from __future__ import annotations

import copy
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from ..utils import rng


def sqrt32(x: float) -> float:
    """sqrt in float32 of x rounded to float32: jnp.sqrt of a Python
    float, the scale of the JAX package's initialisers."""
    return float(np.sqrt(np.float32(x)))


class Dense(nn.Module):
    """One affine layer x @ w + b with w (n_in, n_out), the JAX layout."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class Params(nn.Module):
    """A parameter tree: `trainable` entries become parameters (or
    sub-modules), `frozen` ones buffers (no gradient, no Adam state)."""

    def __init__(self, trainable: dict | None = None,
                 frozen: dict | None = None):
        super().__init__()
        for k, v in (trainable or {}).items():
            if isinstance(v, nn.Module):
                self.add_module(k, v)
            else:
                self.register_parameter(k, nn.Parameter(v))
        for k, v in (frozen or {}).items():
            self.register_buffer(k, v)


def normal_init(key: torch.Tensor, shape, var: float) -> torch.Tensor:
    """jax.random.normal(key, shape) * jnp.sqrt(var)."""
    return rng.normal(key, shape) * sqrt32(var)


# ---------------- MLP ----------------

def mlp_init(key: torch.Tensor, sizes: Sequence[int]) -> nn.ModuleList:
    """sizes = (n_in, h1, ..., n_out); weights N(0, 2 / n_in), zero bias."""
    layers = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        kw, key = rng.split(key)
        layers.append(Dense(normal_init(kw, (a, b), 2.0 / a),
                            torch.zeros(b, device=key.device)))
    return nn.ModuleList(layers)


def mlp_apply(params: nn.ModuleList, x: torch.Tensor,
              hidden_act: Callable = torch.tanh, out_act=None):
    """Hidden layers with `hidden_act`, a linear (or `out_act`) output."""
    for i, lyr in enumerate(params):
        x = lyr(x)
        if i < len(params) - 1:
            x = hidden_act(x)
        elif out_act is not None:
            x = out_act(x)
    return x


# ---------------- Conv1D CNN ----------------

def cnn_init(key: torch.Tensor, n_in: int, n_out: int,
             channels: Sequence[int] = (32, 32), kernel: int = 3) -> Params:
    """1-D conv stack over the time axis + linear head per time step; conv
    weights (kernel, c_in, c_out) as JAX's WIO."""
    convs = []
    c_prev = n_in
    for c in channels:
        kw, key = rng.split(key)
        convs.append(Dense(
            normal_init(kw, (kernel, c_prev, c), 2.0 / (kernel * c_prev)),
            torch.zeros(c, device=key.device)))
        c_prev = c
    kw, key = rng.split(key)
    head = Dense(normal_init(kw, (c_prev, n_out), 1.0 / c_prev),
                 torch.zeros(n_out, device=key.device))
    return Params({"convs": nn.ModuleList(convs), "head": head})


def cnn_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x (..., T, n_in) -> (..., T, n_out): SAME-padded cross-correlation
    (conv_general_dilated on NWC / WIO), ReLU, then the head."""
    lead = x.shape[:-2]
    h = x.reshape(-1, *x.shape[-2:]).transpose(1, 2)          # (N, C, T)
    for lyr in params.convs:
        k = lyr.w.shape[0]
        # SAME: (k - 1) // 2 before, the rest after (XLA's split)
        h = nn.functional.pad(h, ((k - 1) // 2, k // 2))
        h = nn.functional.conv1d(h, lyr.w.permute(2, 1, 0))
        h = torch.relu(h + lyr.b[:, None])
    h = h.transpose(1, 2).reshape(*lead, x.shape[-2], -1)
    return params.head(h)


# ---------------- GRU RNN ----------------

def rnn_init(key: torch.Tensor, n_in: int, n_hidden: int, n_out: int
             ) -> Params:
    k1, k2, k3 = rng.split(key, 3)
    return Params({
        "wi": normal_init(k1, (n_in, 3 * n_hidden), 1.0 / n_in),
        "wh": normal_init(k2, (n_hidden, 3 * n_hidden), 1.0 / n_hidden),
        "bi": torch.zeros(3 * n_hidden, device=key.device),
        "head": Dense(normal_init(k3, (n_hidden, n_out), 1.0 / n_hidden),
                      torch.zeros(n_out, device=key.device))})


def rnn_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """GRU over (..., T, n_in) -> (..., T, n_out): the JAX package's gate
    order (r, z, n), an input bias only, and r * (h W_h) inside n."""
    nh = params.wh.shape[0]
    gi = x @ params.wi + params.bi                      # (..., T, 3nh)
    h = torch.zeros(*x.shape[:-2], nh, dtype=x.dtype, device=x.device)
    hs = []
    for t in range(x.shape[-2]):
        g, gh = gi[..., t, :], h @ params.wh
        r = torch.sigmoid(g[..., :nh] + gh[..., :nh])
        z = torch.sigmoid(g[..., nh:2 * nh] + gh[..., nh:2 * nh])
        n = torch.tanh(g[..., 2 * nh:] + r * gh[..., 2 * nh:])
        h = (1 - z) * n + z * h
        hs.append(h)
    return params.head(torch.stack(hs, dim=-2))


# ---------------- full-batch Adam training ----------------

class TrainResult(NamedTuple):
    params: nn.Module
    losses: torch.Tensor      # (epochs,) loss before each step's update


def _adam_loop(params: nn.Module, loss_fn: Callable, epochs: int,
               lr: float) -> TrainResult:
    params = copy.deepcopy(params)
    opt = torch.optim.Adam(params.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    losses = torch.empty(epochs, device=next(params.parameters()).device)
    for i in range(epochs):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params)
        loss.backward()
        opt.step()
        losses[i] = loss.detach()
    return TrainResult(params=params, losses=losses)


def train_regressor(apply_fn: Callable, params: nn.Module, X: torch.Tensor,
                    Y: torch.Tensor, epochs: int = 50, lr: float = 1e-3
                    ) -> TrainResult:
    """Full-batch Adam on MSE (the reference's per-block model fitting, 50
    Adam epochs on one pilot sequence, system_model_2_all_comparision.py:
    102-113)."""
    return _adam_loop(
        params, lambda p: torch.mean((apply_fn(p, X) - Y) ** 2), epochs, lr)


def train_classifier(apply_fn: Callable, params: nn.Module, X: torch.Tensor,
                     labels: torch.Tensor, epochs: int = 200,
                     lr: float = 1e-3, l2: float = 0.0, l2_keys=None
                     ) -> TrainResult:
    """Full-batch Adam on softmax cross-entropy (the Sionna-pipeline loop,
    esn_via_cdl_all_model.py:200-213).

    The L2 term is part of the loss, l2 * sum(w^2) over the parameters of
    the top-level entries `l2_keys` (all parameters when None), as in the
    JAX package: not Adam's weight_decay, which adds l2 * w to the gradient
    (half the gradient of this term) and covers every parameter. Frozen
    entries are buffers, so no penalty reaches them."""
    labels = labels.long()

    def loss_fn(p):
        ce = nn.functional.cross_entropy(apply_fn(p, X), labels)
        if not l2:
            return ce
        leaves = (p.parameters() if l2_keys is None else
                  [w for k in l2_keys for w in _entry_params(p, k)])
        return ce + l2 * sum(torch.sum(w ** 2) for w in leaves)

    return _adam_loop(params, loss_fn, epochs, lr)


def _entry_params(p: nn.Module, key: str):
    entry = getattr(p, key)
    return entry.parameters() if isinstance(entry, nn.Module) else [entry]


class BlockModels(NamedTuple):
    """B models of one structure: `base`, one block's tree (on the meta
    device) wrapped with its apply, and the B trees' parameters and
    buffers stacked along a leading block axis, keyed as in `base`."""
    base: nn.Module
    params: dict
    buffers: dict


class _Applied(nn.Module):
    """apply_fn bound to a parameter tree, so that `functional_call` can
    swap the tree's tensors for one block's slice of the stack."""

    def __init__(self, apply_fn: Callable, params: nn.Module):
        super().__init__()
        self.apply_fn, self.p = apply_fn, params

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply_fn(self.p, x)


def stack_blocks(apply_fn: Callable, models: Sequence[nn.Module]
                 ) -> BlockModels:
    """B trees of one structure -> BlockModels; the stacked parameters are
    new leaves that require grad."""
    params, buffers = torch.func.stack_module_state(
        [_Applied(apply_fn, m) for m in models])
    return BlockModels(copy.deepcopy(_Applied(apply_fn, models[0])).to(
        "meta"), params, buffers)


def apply_per_block(bm: BlockModels, x: torch.Tensor) -> torch.Tensor:
    """x (B, ...) -> the stack of model b applied to x[b]."""
    def one(p, b, xb):
        return torch.func.functional_call(bm.base, (p, b), (xb,))
    return torch.func.vmap(one)(bm.params, bm.buffers, x)


def train_regressor_per_block(apply_fn: Callable,
                              models: Sequence[nn.Module], X: torch.Tensor,
                              Y: torch.Tensor, epochs: int = 50,
                              lr: float = 1e-3) -> TrainResult:
    """`train_regressor` of models[b] on (X[b], Y[b]) for every block b at
    once: X (B, ...), Y (B, ...). Returns TrainResult(BlockModels, losses
    (B, epochs)), each block's loss before each step's update."""
    bm = stack_blocks(apply_fn, models)
    B = len(models)
    opt = torch.optim.Adam(bm.params.values(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    losses = torch.empty(B, epochs, device=X.device)
    for i in range(epochs):
        opt.zero_grad(set_to_none=True)
        loss = ((apply_per_block(bm, X) - Y) ** 2).reshape(B, -1).mean(1)
        loss.sum().backward()
        opt.step()
        losses[:, i] = loss.detach()
    return TrainResult(params=bm, losses=losses)


class _CudnnGru(nn.Module):
    """One block's `rnn_apply` GRU as a `torch.nn.GRU` and its head. The
    gate order (r, z, n) and n = tanh(W_in x + b_in + r * (W_hn h + b_hn))
    are PyTorch's as they are the JAX package's GRU's, with weight_ih = wi^T,
    weight_hh = wh^T, bias_ih = bi and bias_hh held at zero (no gradient):
    `rnn_apply` has no hidden bias."""

    def __init__(self, p: Params):
        super().__init__()
        n_in, nh = p.wi.shape[0], p.wh.shape[0]
        self.gru = nn.GRU(n_in, nh, batch_first=True).to(p.wi)
        with torch.no_grad():
            self.gru.weight_ih_l0.copy_(p.wi.T)
            self.gru.weight_hh_l0.copy_(p.wh.T)
            self.gru.bias_ih_l0.copy_(p.bi)
            self.gru.bias_hh_l0.zero_()
        self.gru.bias_hh_l0.requires_grad_(False)
        self.head = copy.deepcopy(p.head)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.gru(x)[0])


class GruBlocks(nn.ModuleList):
    """B trained `_CudnnGru`s, one a block: called on x (B, S, T, n_in), it
    returns the stack of block b's GRU on x[b] (S sequences), one
    `torch.nn.GRU` call a block."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.stack([g(xb) for g, xb in zip(self, x)])


def train_rnn_per_block(models: Sequence[Params], X: torch.Tensor,
                        Y: torch.Tensor, epochs: int = 50, lr: float = 1e-3
                        ) -> TrainResult:
    """`train_regressor_per_block(rnn_apply, models, X, Y, ...)` with each
    block's GRU run by `torch.nn.GRU`: X (B, S, T, n_in), Y (B, S, T,
    n_out). One Adam over every block's weights, on the sum over blocks of
    each block's mean loss. Returns TrainResult(GruBlocks, losses (B,
    epochs)); the pipeline predicts through the trained GruBlocks too."""
    grus = GruBlocks([_CudnnGru(m) for m in models])
    opt = torch.optim.Adam([p for p in grus.parameters() if p.requires_grad],
                           lr=lr, betas=(0.9, 0.999), eps=1e-8)
    losses = torch.empty(len(models), epochs, device=X.device)
    for i in range(epochs):
        opt.zero_grad(set_to_none=True)
        loss = torch.stack([torch.mean((g(x) - y) ** 2)
                            for g, x, y in zip(grus, X, Y)])
        loss.sum().backward()
        opt.step()
        losses[:, i] = loss.detach()
    return TrainResult(params=grus, losses=losses)


def window_flatten(x: torch.Tensor, window: int = 8) -> torch.Tensor:
    """(..., T, F) -> (..., T, window*F): causal sliding window, zero-padded
    (the reference's FNN/ELM feature layout, window 8,
    system_model_2_all_comparision.py:115-149)."""
    T = x.shape[-2]
    xp = nn.functional.pad(x, (0, 0, window - 1, 0))
    return torch.cat([xp[..., t:t + T, :] for t in range(window)], dim=-1)
