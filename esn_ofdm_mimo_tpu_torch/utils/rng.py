"""Key-compatible counter-based RNG: jax.random's threefry2x32 stream.

The JAX package folds every per-block random draw from (root seed, SNR
index, global block id, purpose tag) through `jax.random` with the default
threefry2x32 implementation in its partitionable mode
(`jax_threefry_partitionable=True`, the JAX 0.9 default). This module
reproduces that stream bit for bit, so the port draws the same taps, pilot
and data bits, AWGN and reservoir as the JAX package at the same keys:

  key          (..., 2) int64 tensor holding two uint32 words
  fold_in      threefry(key, (0, data))                       — both words
  split(k, n)  threefry(key, (0, i)) for i < n                — both words
  bits         threefry(key, (hi(i), lo(i))) word0 ^ word1, i the flat index
  uniform      JAX's mantissa trick: (bits >> 9) | 0x3F800000 as f32, minus 1,
               then fma(u, span, lo) as XLA fuses it
  normal       sqrt(2) * erfinv(uniform(nextafter(-1, 0), 1))
  bernoulli    uniform < p
  randint      two bit draws from split(key): (hi % span * (2^16 % span)^2
               + lo % span) % span, in wrapping uint32 arithmetic
  permutation  ceil(3 ln n / ln(2^32 - 1)) rounds of a stable sort of
               arange(n) by 32 fresh bits, each round on split(key)[1]

Integers, bits, uniforms, bernoulli draws, randint and permutations are
bit-exact against `jax.random`. Normals use XLA's erfinv polynomial and
differ from JAX's in a few percent of draws, by at most a few ulp.

On the card `fold_in`, `split` and each draw are one launch of a
hand-written CUDA kernel (`csrc/threefry.cu`: the hash in uint32
registers, then the bits, uniform, normal or Bernoulli epilogue), counted
in `launches`; randint and permutation add torch operations on its bits.
The `*_plain` functions are the plain version: uint32 words in int64
tensors (torch has no full-width uint32 arithmetic), masked back to 32
bits after every add and shift, one torch operation a step. A CPU key
takes them; on the card they are the kernel's yardstick, which it equals
bit for bit.

Everything broadcasts over leading key axes: a (B, 2) batch of block keys
draws (B, *shape) in one call — the batch dimension that `jax.vmap` was.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import build

# Launches of the threefry kernel since the count was last reset (by the
# caller).
launches = 0

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
# the kernel's epilogues (csrc/threefry.cu)
_BITS, _UNIFORM, _NORMAL, _BERNOULLI = 1, 2, 3, 4


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


# ---- the kernel's wrapper ---------------------------------------------------

def check_keys(key: torch.Tensor, n: int = 0) -> None:
    """Raise unless `key` is an int64 (..., 2) key batch and the `n`
    elements of the output can be indexed in int64 with a grid stride."""
    if key.dtype != torch.int64 or key.dim() < 1 or key.shape[-1] != 2:
        raise ValueError(f"keys are int64 (..., 2), not {key.dtype} "
                         f"{tuple(key.shape)}")
    if not 0 <= n < 2 ** 62:
        raise ValueError(f"{n} draws in one launch: at most 2^62")


def _on_card(key: torch.Tensor) -> bool:
    """True for a CUDA key (the kernel), False for a CPU key (the plain
    version); another device raises."""
    if key.device.type == "cpu":
        return False
    if key.device.type != "cuda":
        raise ValueError(f"unsupported device {key.device}")
    return True


def _rows(key: torch.Tensor):
    """The key batch as (L, 2) rows with a unit last stride -> (rows, the
    rows' stride in int64 elements): a strided view such as
    `split(k)[..., 0, :]` is read in place, not copied."""
    rows = key.reshape(-1, 2)
    if rows.stride(-1) != 1:
        rows = rows.contiguous()
    return rows, rows.stride(0)


class HashArgs(NamedTuple):
    """One launch of threefry_hash_launch (csrc/threefry.cu): element e of
    the (*out_shape, 2) output hashes key row e // kdiv of `keys` (rows
    `kstride` apart) with the counter words (0, c): c = data[e], or
    const + e % kdiv without data."""
    keys: torch.Tensor
    kstride: int
    kdiv: int
    data: Optional[torch.Tensor]
    const: int
    out_shape: tuple


def fold_in_args(key: torch.Tensor, data) -> HashArgs:
    """The launch of fold_in(key, data): an int is the constant counter of
    every key; a tensor is broadcast against the leading key axes, and
    both are expanded to the broadcast shape (a key broadcast along one
    axis, such as block_keys' single root, stays a stride-0 view)."""
    lead = tuple(key.shape[:-1])
    if isinstance(data, (int, np.integer)):
        return HashArgs(*_rows(key), 1, None, int(data) & _MASK, lead)
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    out = tuple(torch.broadcast_shapes(lead, data.shape))
    return HashArgs(*_rows(key.expand(out + (2,))), 1,
                    data.expand(out).contiguous(), 0, out)


def split_args(key: torch.Tensor, num: int) -> HashArgs:
    """The launch of split(key, num): row e // num, counter e % num."""
    return HashArgs(*_rows(key), int(num), None, 0,
                    tuple(key.shape[:-1]) + (int(num),))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("threefry")
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.threefry_hash_launch.argtypes = [p, ll, ll, p, ll, ll, p, p]
    lib.threefry_hash_launch.restype = ctypes.c_int
    lib.threefry_draw_launch.argtypes = [ctypes.c_int, p, ll, ll, ll,
                                         ctypes.c_double, ctypes.c_double,
                                         ctypes.c_float, p, p]
    lib.threefry_draw_launch.restype = ctypes.c_int
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _hash(a: HashArgs) -> torch.Tensor:
    """Launch the hash kernel on `a` -> (*a.out_shape, 2) int64 keys."""
    global launches
    out = torch.empty(a.out_shape + (2,), dtype=torch.int64,
                      device=a.keys.device)
    n = out.numel() // 2
    check_keys(a.keys, n)
    if n == 0:
        return out
    rc = _lib().threefry_hash_launch(
        a.keys.data_ptr(), a.kstride, a.kdiv,
        None if a.data is None else a.data.data_ptr(), a.const, n,
        out.data_ptr(), _stream(out))
    if rc != 0:
        raise RuntimeError(f"threefry_hash_launch failed for {n} keys: CUDA "
                           f"error {rc}")
    launches += 1
    return out


def _uniform_span(minval: float, maxval: float):
    """(lo, span) of uniform_plain: float32 values, as float64."""
    lo = np.float32(minval)
    return float(lo), float(np.float32(maxval) - lo)


def _draw(mode: int, key: torch.Tensor, shape, dtype, minval: float = 0.0,
          maxval: float = 1.0, p: float = 0.0) -> torch.Tensor:
    """Launch the draw kernel: (..., 2) keys -> (..., *shape) of `dtype`,
    element i of a key's draw from the counter words (hi32(i), lo32(i))."""
    global launches
    shape = tuple(int(s) for s in shape)
    out = torch.empty(tuple(key.shape[:-1]) + shape, dtype=dtype,
                      device=key.device)
    check_keys(key, out.numel())
    if out.numel() == 0:
        return out
    rows, kstride = _rows(key)
    lo, span = _uniform_span(minval, maxval)
    rc = _lib().threefry_draw_launch(
        mode, rows.data_ptr(), kstride, rows.shape[0],
        out.numel() // rows.shape[0], span, lo, float(np.float32(p)),
        out.data_ptr(), _stream(out))
    if rc != 0:
        raise RuntimeError(f"threefry_draw_launch failed (mode {mode}, "
                           f"{tuple(out.shape)}): CUDA error {rc}")
    launches += 1
    return out


# ---- keys -------------------------------------------------------------------

def fold_in_plain(key: torch.Tensor, data) -> torch.Tensor:
    """`fold_in` in int64 torch operations."""
    if isinstance(data, (int, np.integer)):
        # a fill on the key's device, not a copy from the host (a copy
        # syncs the stream, and no CUDA graph can capture it)
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
    int tensor broadcastable against the leading key axes. On the card an
    int goes to the kernel as an argument: no fill, no copy from the
    host."""
    if not _on_card(key):
        return fold_in_plain(key, data)
    check_keys(key)
    return _hash(fold_in_args(key, data))


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
    if not _on_card(key):
        return split_plain(key, num)
    check_keys(key)
    return _hash(split_args(key, num))


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
    if not _on_card(key):
        return random_bits_plain(key, shape)
    return _draw(_BITS, key, shape, torch.int64)


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
    if not _on_card(key):
        return uniform_plain(key, shape, minval, maxval)
    return _draw(_UNIFORM, key, shape, torch.float32, minval, maxval)


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
    if not _on_card(key):
        return normal_plain(key, shape)
    return _draw(_NORMAL, key, shape, torch.float32, _NORMAL_LO, 1.0)


def bernoulli_plain(key: torch.Tensor, p: float, shape) -> torch.Tensor:
    """`bernoulli` in torch operations."""
    return uniform_plain(key, shape) < float(np.float32(p))


def bernoulli(key: torch.Tensor, p: float, shape) -> torch.Tensor:
    """jax.random.bernoulli (mode 'low'): uniform < p, as bool."""
    if not _on_card(key):
        return bernoulli_plain(key, p, shape)
    return _draw(_BERNOULLI, key, shape, torch.bool, p=p)


def randint(key: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """jax.random.randint for 32-bit integers (jax/_src/random.py:_randint):
    U{minval, ..., maxval - 1} as int64, spans up to 2^31."""
    span = int(maxval) - int(minval)
    if not 0 < span < 2 ** 31:
        raise ValueError(f"randint span {span} outside (0, 2^31)")
    k = split(key)
    hi = random_bits(k[..., 0, :], shape)
    lo = random_bits(k[..., 1, :], shape)
    mult = ((1 << 16) % span) ** 2 % span
    off = ((((hi % span) * mult) & _MASK) + lo % span) & _MASK
    return off % span + int(minval)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """jax.random.permutation(key, n) for one (2,) key (_shuffle): rounds
    of a stable sort of arange(n) by fresh 32-bit keys; int64 (n,)."""
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, device=key.device)
    for _ in range(rounds):
        key, sub = split(key)
        x = x[torch.argsort(random_bits(sub, (n,)), stable=True)]
    return x
