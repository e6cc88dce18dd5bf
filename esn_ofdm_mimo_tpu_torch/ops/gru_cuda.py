"""K7: the 2x2 model zoo's per-block GRUs on the card.

`train(x, y, w)` gives, for B blocks each with its own GRU (the
`models/zoo.py:rnn_apply` form: hidden 32, the JAX package's gate order
(r, z, n), an input bias only, and a dense head), each block's outputs on
its sequence, its loss mean((y_hat - y)^2) and the gradients of the sum of
the losses with respect to every weight; `predict(x, w)` gives each
block's outputs on S sequences. For tensors on the card each is one launch
of csrc/gru_train.cu (counted in `launches`); for tensors on any other
device it is the plain version, `train_plain` / `rnn_apply_blocks`:
`rnn_apply` batched over the blocks, with autograd for the gradients. On
the card a shape or dtype the kernel does not take raises ValueError; it
never falls back to the plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, NoReturn

import torch

from ..utils import build

# Launches of K7 from Python since the count was last reset (by the
# caller): one a training step, one a prediction; a replayed graph adds
# none.
launches = 0

HIDDEN, N_IN, N_OUT = 32, 4, 4     # the only sizes the kernel is built for


class GruWeights(NamedTuple):
    """B GRUs of `rnn_apply`'s form stacked along a leading block axis."""
    wi: torch.Tensor    # (B, n_in, 3 nh)
    wh: torch.Tensor    # (B, nh, 3 nh)
    bi: torch.Tensor    # (B, 3 nh)
    wo: torch.Tensor    # (B, nh, n_out), the head's weight
    bo: torch.Tensor    # (B, n_out), the head's bias


def rnn_apply_blocks(w: GruWeights, x: torch.Tensor) -> torch.Tensor:
    """`rnn_apply` of block b's GRU on x[b]: x (B, S, T, n_in) -> (B, S, T,
    n_out), in plain PyTorch (batched matrix products over the blocks)."""
    nh = w.wh.shape[-2]
    B, S, T = x.shape[:3]
    gi = x @ w.wi[:, None] + w.bi[:, None, None]        # (B, S, T, 3 nh)
    h = x.new_zeros(B, S, nh)
    hs = []
    for t in range(T):
        g, gh = gi[:, :, t], h @ w.wh
        r = torch.sigmoid(g[..., :nh] + gh[..., :nh])
        z = torch.sigmoid(g[..., nh:2 * nh] + gh[..., nh:2 * nh])
        n = torch.tanh(g[..., 2 * nh:] + r * gh[..., 2 * nh:])
        h = (1 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs, dim=-2) @ w.wo[:, None] + w.bo[:, None, None]


def train_plain(x: torch.Tensor, y: torch.Tensor, w: GruWeights):
    """`train` in plain PyTorch: x (B, T, n_in), y (B, T, n_out) -> (the
    outputs (B, T, n_out), the losses (B,), the gradients as GruWeights)."""
    with torch.enable_grad():
        p = GruWeights(*(t.detach().requires_grad_() for t in w))
        pred = rnn_apply_blocks(p, x[:, None])[:, 0]
        loss = ((pred - y) ** 2).flatten(1).mean(1)
        grads = torch.autograd.grad(loss.sum(), p)
    return pred.detach(), loss.detach(), GruWeights(*grads)


def _refuse(why: str, **shapes) -> NoReturn:
    got = ", ".join(f"{k} {v.dtype} {tuple(v.shape)} on {v.device}"
                    for k, v in shapes.items())
    raise ValueError(f"the GRU kernel does not take {got}: {why}")


def _check(x: torch.Tensor, w: GruWeights, lead: tuple):
    """Raise unless x (*lead, T, N_IN) and the weights of B = lead[0]
    blocks are float32 on one card at the kernel's sizes."""
    B = lead[0]
    want = GruWeights((B, N_IN, 3 * HIDDEN), (B, HIDDEN, 3 * HIDDEN),
                      (B, 3 * HIDDEN), (B, HIDDEN, N_OUT), (B, N_OUT))
    tensors = dict(x=x, **w._asdict())
    if any(t.dtype != torch.float32 or t.device != x.device
           for t in tensors.values()):
        _refuse("it takes float32 tensors on one device", **tensors)
    if x.dim() != len(lead) + 2 or x.shape[-1] != N_IN or x.shape[-2] < 1:
        _refuse(f"it takes x of shape (..., T, {N_IN})", **tensors)
    if any(tuple(t.shape) != s for t, s in zip(w, want)):
        _refuse(f"it takes hidden {HIDDEN}, {N_IN} inputs and {N_OUT} "
                f"outputs a block", **tensors)


def _c(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor whose data starts on a 16-byte boundary (the
    kernel reads and writes 16 bytes at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("gru_train")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gru_train_launch.argtypes = [p] * 15 + [i, i, p]
    lib.gru_train_launch.restype = i
    lib.gru_predict_launch.argtypes = [p] * 7 + [i, i, i, p]
    lib.gru_predict_launch.restype = i
    lib.gru_workspace_floats.argtypes = [i]
    lib.gru_workspace_floats.restype = ctypes.c_longlong
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def train(x: torch.Tensor, y: torch.Tensor, w: GruWeights,
          ws: torch.Tensor | None = None):
    """One training step's forward and backward pass of B blocks' GRUs,
    each on its own sequence: x (B, T, n_in), y (B, T, n_out) -> (outputs
    (B, T, n_out), losses (B,), gradients GruWeights). On the card `ws`, if
    given, is the kernel's scratch (`workspace(B, T, device)`); a caller
    that trains for many steps makes it once."""
    global launches
    if x.device.type != "cuda":
        return train_plain(x, y, w)
    B, T = x.shape[0], x.shape[-2]
    _check(x, w, (B,))
    if tuple(y.shape) != (B, T, N_OUT) or y.dtype != torch.float32 \
            or y.device != x.device:
        _refuse(f"it takes y of shape (B, T, {N_OUT})", x=x, y=y)
    x, y = _c(x), _c(y)
    w = GruWeights(*(_c(t) for t in w))
    if ws is None:
        ws = workspace(B, T, x.device)
    pred = torch.empty(B, T, N_OUT, device=x.device)
    loss = torch.empty(B, device=x.device)
    grads = GruWeights(*(torch.empty_like(t) for t in w))
    rc = _lib().gru_train_launch(
        x.data_ptr(), y.data_ptr(), *(t.data_ptr() for t in w),
        pred.data_ptr(), loss.data_ptr(), *(g.data_ptr() for g in grads),
        ws.data_ptr(), B, T, _stream(x))
    if rc != 0:
        raise RuntimeError(f"gru_train_launch failed at B {B}, T {T}: CUDA "
                           f"error {rc}")
    launches += 1
    return pred, loss, grads


def workspace(B: int, T: int, device) -> torch.Tensor:
    """The training kernel's scratch for B blocks of T steps: each step's
    gates and hidden state, and the outputs' gradients."""
    return torch.empty(B, int(_lib().gru_workspace_floats(T)),
                       device=device)


def predict(x: torch.Tensor, w: GruWeights) -> torch.Tensor:
    """Block b's GRU on each of its S sequences: x (B, S, T, n_in) -> (B,
    S, T, n_out)."""
    global launches
    if x.device.type != "cuda":
        with torch.no_grad():
            return rnn_apply_blocks(w, x)
    if x.dim() != 4:
        _refuse(f"it takes x of shape (B, S, T, {N_IN})", x=x)
    B, S, T = x.shape[:3]
    _check(x, w, (B, S))
    x = _c(x)
    w = GruWeights(*(_c(t) for t in w))
    pred = torch.empty(B, S, T, N_OUT, device=x.device)
    rc = _lib().gru_predict_launch(
        x.data_ptr(), *(t.data_ptr() for t in w), pred.data_ptr(), B, S, T,
        _stream(x))
    if rc != 0:
        raise RuntimeError(f"gru_predict_launch failed at B {B}, S {S}, T "
                           f"{T}: CUDA error {rc}")
    launches += 1
    return pred
