"""jax.random's threefry2x32 stream in plain int64 torch operations: a
frozen copy of the program's plain RNG (`*_plain`), with no kernel behind
it. The same keys give the same taps, bits, AWGN and reservoir draws as
the program, bit for bit.

  key          (..., 2) int64 tensor holding two uint32 words
  fold_in      threefry(key, (0, data))
  split(k, n)  threefry(key, (0, i)) for i < n
  bits         threefry(key, (hi(i), lo(i))) word0 ^ word1, i the flat index
  uniform      (bits >> 9) | 0x3F800000 as f32, minus 1, then u * span + lo
               rounded once
  normal       sqrt(2) * erfinv(uniform(nextafter(-1, 0), 1))
  bernoulli    uniform < p
"""
from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32_plain(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) on broadcastable int64 tensors
    holding uint32 values; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _MASK
    x1 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def as_keys(keys, device=None) -> torch.Tensor:
    """Raw uint32 key data (numpy/torch, last axis 2) -> int64 tensor."""
    if isinstance(keys, torch.Tensor):
        return keys.to(device=device, dtype=torch.int64) & _MASK
    arr = np.asarray(keys).astype(np.uint32).astype(np.int64)
    return torch.as_tensor(arr, device=device)


def prng_key(seed: int, device=None) -> torch.Tensor:
    """jax.random.PRNGKey(seed) as JAX makes it with 64-bit types off (its
    default): the seed wraps to 32 bits, key = (0, seed mod 2^32)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


# ---- keys -------------------------------------------------------------------

def fold_in_plain(key: torch.Tensor, data) -> torch.Tensor:
    """`fold_in` in int64 torch operations."""
    if isinstance(data, (int, np.integer)):
        data = torch.full((), int(data) & _MASK, dtype=torch.int64,
                          device=key.device)
    else:
        data = torch.as_tensor(data, dtype=torch.int64,
                               device=key.device) & _MASK
    y0, y1 = threefry2x32_plain(key[..., 0], key[..., 1],
                                torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in over a (..., 2) key batch; `data` an int or an
    int tensor broadcastable against the leading key axes."""
    return fold_in_plain(key, data)


def fold_key(key: torch.Tensor, *ids) -> torch.Tensor:
    for i in ids:
        key = fold_in(key, i)
    return key


def block_keys(root: torch.Tensor, snr_idx: int, block_ids) -> torch.Tensor:
    """Per-block keys: fold the SNR index, then each global block id.
    block_ids (B,) ints -> (B, 2) keys (utils/rng.block_keys of the JAX
    package)."""
    ids = torch.as_tensor(block_ids, dtype=torch.int64, device=root.device)
    return fold_in(fold_in(root, snr_idx)[None, :], ids)


def split_plain(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`split` in int64 torch operations."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32_plain(key[..., None, 0], key[..., None, 1],
                                torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split: (..., 2) -> (..., num, 2)."""
    return split_plain(key, num)


# ---- draws ------------------------------------------------------------------

def random_bits_plain(key: torch.Tensor, shape) -> torch.Tensor:
    """`random_bits` in int64 torch operations."""
    shape = tuple(int(s) for s in shape)
    size = int(np.prod(shape, dtype=np.int64))
    idx = torch.arange(size, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(*lead, 1)
    k2 = key[..., 1].reshape(*lead, 1)
    y0, y1 = threefry2x32_plain(k1, k2, idx >> 32, idx & _MASK)
    return (y0 ^ y1).reshape(*lead, *shape)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element: (..., 2) keys -> (..., *shape) int64."""
    return random_bits_plain(key, shape)


def uniform_plain(key: torch.Tensor, shape, minval: float = 0.0,
                  maxval: float = 1.0) -> torch.Tensor:
    """`uniform` in torch operations."""
    bits = random_bits_plain(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    # XLA fuses floats * span + lo into one fused multiply-add: the exact
    # product (48 bits) plus lo in float64, rounded once to float32
    out = (floats.double() * float(span) + float(lo)).float()
    return torch.clamp_min(out, float(lo))


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """jax.random.uniform in float32: U[minval, maxval)."""
    return uniform_plain(key, shape, minval, maxval)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))
# Giles' single-precision erfinv polynomial, the one XLA evaluates for
# f32 erf_inv: w = -log1p(-x^2); degree-8 Horner in (w - 2.5) below w = 5,
# in (sqrt(w) - 3) above. torch.erfinv (a different approximation) lands up
# to ~90 ulp away from JAX's normals; this form stays within a few ulp
# (log1p and fused multiply-adds differ between the libraries).
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for a, b in zip(_ERFINV_LT5, _ERFINV_GE5):
        c = torch.where(lt, float(np.float32(a)), float(np.float32(b)))
        p = c if p is None else c + p * w
    return torch.where(x.abs() == 1.0, x * float(np.finfo(np.float32).max),
                       p * x)


def normal_plain(key: torch.Tensor, shape) -> torch.Tensor:
    """`normal` in torch operations."""
    u = uniform_plain(key, shape, _NORMAL_LO, 1.0)
    return _SQRT2 * _erfinv_f32(u)


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """jax.random.normal in float32, within a few ulp (see _erfinv_f32)."""
    return normal_plain(key, shape)


def bernoulli_plain(key: torch.Tensor, p: float, shape) -> torch.Tensor:
    """`bernoulli` in torch operations."""
    return uniform_plain(key, shape) < float(np.float32(p))


def bernoulli(key: torch.Tensor, p: float, shape) -> torch.Tensor:
    """jax.random.bernoulli (mode 'low'): uniform < p, as bool."""
    return bernoulli_plain(key, p, shape)
