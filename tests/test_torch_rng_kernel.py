"""The threefry kernel's arithmetic (esn_ofdm_mimo_tpu_torch/csrc/threefry.cu)
on the CPU: a numpy uint32 model of what one thread computes for an element,
written in the CUDA source's operation order (funnel-shift rotations,
wrapping uint32 adds, the uniform's float64 scale and shift, the erfinv's
separate multiplies and adds), fed with the launch arguments the wrapper in
utils/rng.py computes (key rows and their stride, the row divisor and
counters of the hash, the grid-stride walk of (row, i)). It equals the
plain version (rng.*_plain) and jax.random at small shapes: exactly, but
for normals, which are within the NORMAL_MAX_ULP of tests/test_torch_rng.py
(numpy's float32 log1p is not CUDA's log1pf). The kernel itself runs only
on the card: chip_smoke.py's [rng] holds it against the plain version there.
Also: a CPU key takes the plain version and launches nothing, and the
wrapper's argument check."""
import jax
import numpy as np
import pytest
import torch

from esn_ofdm_mimo_tpu_torch.utils import rng

torch.set_num_threads(1)

NORMAL_MAX_ULP = 4            # tests/test_torch_rng.py, against JAX
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_ERFINV_LT5 = np.float32(rng._ERFINV_LT5)
_ERFINV_GE5 = np.float32(rng._ERFINV_GE5)


# ---- the model --------------------------------------------------------------

def _u32(x):
    return np.asarray(x).astype(np.uint32)


def _rotl(x, r):
    """__funnelshift_l(x, x, r)."""
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _threefry(k0, k1, c0, c1):
    """threefry2x32 of the source on uint32 arrays (numpy wraps)."""
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0, x1 = c0 + ks[0], c1 + ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + (ks[(i + 2) % 3] + np.uint32(i + 1))
    return x0, x1


def _key_words(rows, kstride, row):
    """(uint32)keys[row * kstride + 0 / 1], read from the rows' memory as
    the kernel reads it."""
    flat = torch.as_strided(rows, ((rows.shape[0] - 1) * kstride + 2,),
                            (1,)).numpy()
    return _u32(flat[row * kstride]), _u32(flat[row * kstride + 1])


def model_hash(a: rng.HashArgs) -> np.ndarray:
    """threefry_hash_kernel on the launch arguments `a`."""
    n = int(np.prod(a.out_shape, dtype=np.int64))
    e = np.arange(n, dtype=np.int64)
    k0, k1 = _key_words(a.keys, a.kstride, e // a.kdiv)
    if a.data is not None:
        assert a.data.is_contiguous() and a.data.numel() == n
        c = _u32(a.data.reshape(-1).numpy())
    else:
        c = _u32(a.const + e % a.kdiv)
    y0, y1 = _threefry(k0, k1, np.zeros(n, np.uint32), c)
    return np.stack([y0, y1], -1).astype(np.int64).reshape(
        a.out_shape + (2,))


def grid_walk(n: int, size: int, start: int, step: int):
    """The (row, i) the draw kernel's thread starting at `start` visits:
    one division, then the stride's (rows, rest) added a step."""
    if start >= n:
        return []
    row, i = divmod(start, size)
    srow, si = divmod(step, size)
    out = []
    for _ in range(start, n, step):
        out.append((row, i))
        row, i = row + srow, i + si
        if i >= size:
            row, i = row + 1, i - size
    return out


def _draw_bits(key: torch.Tensor, shape):
    """(uint32 bits of every element, leading shape) of the draw kernel."""
    rows, kstride = rng._rows(key)
    size = int(np.prod(shape, dtype=np.int64))
    e = np.arange(rows.shape[0] * size, dtype=np.int64)
    row, i = e // size, e % size
    k0, k1 = _key_words(rows, kstride, row)
    y0, y1 = _threefry(k0, k1, _u32(i >> 32), _u32(i & 0xFFFFFFFF))
    return y0 ^ y1, tuple(key.shape[:-1]) + tuple(shape)


def _uniform_of(bits, minval, maxval):
    lo, span = rng._uniform_span(minval, maxval)
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) \
        - np.float32(1.0)
    v = (f.astype(np.float64) * span + lo).astype(np.float32)
    return np.maximum(v, np.float32(lo))


def _erfinv(x):
    w = -np.log1p((-x) * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5),
                 np.sqrt(np.maximum(w, 0)) - np.float32(3.0))
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = np.where(lt, a, b) + p * w
    return np.where(np.abs(x) == 1, x * np.finfo(np.float32).max, p * x)


def model_draw(mode: str, key, shape, minval=0.0, maxval=1.0, p=0.0):
    """threefry_draw_kernel<MODE> on (..., 2) keys."""
    bits, out = _draw_bits(key, shape)
    if mode == "bits":
        r = bits.astype(np.int64)
    elif mode == "uniform":
        r = _uniform_of(bits, minval, maxval)
    elif mode == "normal":
        r = np.float32(rng._SQRT2) * _erfinv(
            _uniform_of(bits, rng._NORMAL_LO, 1.0))
    else:
        r = _uniform_of(bits, 0.0, 1.0) < np.float32(p)
    return r.reshape(out)


# ---- helpers ----------------------------------------------------------------

def _keys(seed, n=8):
    return np.asarray(jax.random.split(jax.random.PRNGKey(seed), n))


def _ulp(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


# ---- (a) the model against the plain version and jax.random -----------------

@pytest.mark.parametrize("data", [0, 11, 2**32 - 1, -5])
def test_fold_in_int(data):
    k = _keys(1)
    key = rng.as_keys(k)
    got = model_hash(rng.fold_in_args(key, data))
    np.testing.assert_array_equal(got, rng.fold_in_plain(key, data).numpy())
    want = jax.vmap(lambda q: jax.random.fold_in(q, data & 0xFFFFFFFF))(k)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("key_shape,data_shape", [
    ((1, 2), (5,)),            # block_keys: one root, the block ids
    ((5, 2), (5,)),            # a key a block, a tag a block
    ((3, 1, 2), (4,)),         # keys down, data across: both expanded
])
def test_fold_in_tensor(key_shape, data_shape):
    r = np.random.default_rng(sum(key_shape) + 7 * sum(data_shape))
    key = rng.as_keys(r.integers(0, 2**32, key_shape, dtype=np.uint64))
    data = torch.as_tensor(r.integers(-2**33, 2**33, data_shape))
    a = rng.fold_in_args(key, data)
    if key_shape[0] == 1:       # the root is read in place, rows 0 apart
        assert a.kstride == 0 and a.keys.data_ptr() == key.data_ptr()
    np.testing.assert_array_equal(model_hash(a),
                                  rng.fold_in_plain(key, data).numpy())


def test_block_keys_model_equals_jax():
    from esn_ofdm_mimo_tpu.utils.rng import block_keys as jax_block_keys

    root = rng.prng_key(0)
    k = model_hash(rng.fold_in_args(root, 3))
    ids = torch.arange(300, 337)
    got = model_hash(rng.fold_in_args(torch.as_tensor(k)[None], ids))
    want = jax_block_keys(jax.random.PRNGKey(0), 3,
                          np.arange(300, 337, dtype=np.uint32))
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("num", [2, 5])
def test_split(num):
    k = _keys(2, 4)
    key = rng.as_keys(k)
    got = model_hash(rng.split_args(key, num))
    np.testing.assert_array_equal(got, rng.split_plain(key, num).numpy())
    want = jax.vmap(lambda q: jax.random.split(q, num))(k)
    np.testing.assert_array_equal(got, np.asarray(want))
    # a strided view of keys (ops/channel.py: split(keys)[..., 0, :]) is read
    # in place, its rows 4 int64 apart
    view = rng.split_plain(key)[..., 1, :]
    a = rng.split_args(view, num)
    assert a.kstride == 4 and a.keys.data_ptr() == view.data_ptr()
    np.testing.assert_array_equal(model_hash(a),
                                  rng.split_plain(view, num).numpy())


@pytest.mark.parametrize("shape", [(1,), (9, 11), (2, 3, 5)])
def test_bits(shape):
    k = _keys(3)
    got = model_draw("bits", rng.as_keys(k), shape)
    np.testing.assert_array_equal(
        got, rng.random_bits_plain(rng.as_keys(k), shape).numpy())
    want = jax.vmap(lambda q: jax.random.bits(q, shape))(k)
    np.testing.assert_array_equal(got, np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.5, 0.5), (0.0, 2 * np.pi)])
def test_uniform(lo, hi):
    k = _keys(4)
    key = rng.split_plain(rng.as_keys(k))[..., 0, :]       # strided rows
    got = model_draw("uniform", key, (13, 6), lo, hi)
    np.testing.assert_array_equal(
        got, rng.uniform_plain(key, (13, 6), lo, hi).numpy())
    want = jax.vmap(lambda q: jax.random.uniform(
        q, (13, 6), minval=lo, maxval=hi))(np.asarray(key.numpy(), np.uint32))
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("p", [0.5, 0.1])
def test_bernoulli(p):
    k = _keys(5)
    got = model_draw("bernoulli", rng.as_keys(k), (7, 64), p=p)
    np.testing.assert_array_equal(
        got, rng.bernoulli_plain(rng.as_keys(k), p, (7, 64)).numpy())
    want = jax.vmap(lambda q: jax.random.bernoulli(q, p, (7, 64)))(k)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_randint_from_model_bits():
    """randint's arithmetic (rng.randint) on the model's split and bits."""
    k = _keys(6, 4)
    key = rng.as_keys(k)
    sk = torch.as_tensor(model_hash(rng.split_args(key, 2)))
    hi = model_draw("bits", sk[..., 0, :], (5, 77))
    lo = model_draw("bits", sk[..., 1, :], (5, 77))
    for a, b in ((0, 2), (-3, 1000)):
        span = b - a
        mult = ((1 << 16) % span) ** 2 % span
        got = ((((hi % span) * mult) & 0xFFFFFFFF) + lo % span) \
            % 2**32 % span + a
        np.testing.assert_array_equal(
            got, rng.randint(key, (5, 77), a, b).numpy())
        want = jax.vmap(lambda q: jax.random.randint(q, (5, 77), a, b))(k)
        np.testing.assert_array_equal(got, np.asarray(want))


def test_normal_within_ulps():
    k = _keys(9, 16)
    got = model_draw("normal", rng.as_keys(k), (4, 300))
    plain = rng.normal_plain(rng.as_keys(k), (4, 300)).numpy()
    want = np.asarray(jax.vmap(lambda q: jax.random.normal(q, (4, 300)))(k))
    assert np.isfinite(got).all()
    assert _ulp(got, plain).max() <= NORMAL_MAX_ULP
    assert _ulp(got, want).max() <= NORMAL_MAX_ULP


@pytest.mark.parametrize("n,size,step", [(12, 12, 5), (40, 4, 7),
                                         (1000, 37, 256), (6, 1, 3),
                                         (2**33 + 5, 2**32 + 1, 2**31 - 1)])
def test_grid_walk_is_the_flat_index(n, size, step):
    """The draw kernel's (row, i) walk equals (e // size, e % size) for
    every element a thread visits (the largest case only in its first
    steps: a draw of over 2^32 elements a key)."""
    for start in sorted({0, 1, step - 1, min(n - 1, step + 1)}):
        walk = grid_walk(min(n, start + 4 * step), size, start, step)
        want = [divmod(e, size) for e in range(start, min(n, start + 4 * step),
                                                step)]
        assert walk == want


# ---- (b) a CPU key takes the plain version ----------------------------------

def test_cpu_keys_take_the_plain_version():
    rng.launches = 0
    key = rng.as_keys(_keys(7, 4))
    pairs = [
        (rng.fold_in(key, 3), rng.fold_in_plain(key, 3)),
        (rng.fold_key(key, 3, 4), rng.fold_in_plain(
            rng.fold_in_plain(key, 3), 4)),
        (rng.block_keys(key[0], 2, range(6)), rng.fold_in_plain(
            rng.fold_in_plain(key[0], 2)[None], torch.arange(6))),
        (rng.split(key, 3), rng.split_plain(key, 3)),
        (rng.random_bits(key, (5,)), rng.random_bits_plain(key, (5,))),
        (rng.uniform(key, (5,), -1.0, 1.0),
         rng.uniform_plain(key, (5,), -1.0, 1.0)),
        (rng.normal(key, (5,)), rng.normal_plain(key, (5,))),
        (rng.bernoulli(key, 0.3, (5,)), rng.bernoulli_plain(key, 0.3, (5,))),
    ]
    for got, want in pairs:
        assert torch.equal(got, want)
    rng.randint(key, (5,), 0, 7)
    rng.permutation(key[0], 50)
    assert rng.launches == 0


def test_other_devices_raise():
    with pytest.raises(ValueError, match="unsupported device"):
        rng.normal(torch.zeros((2, 2), dtype=torch.int64, device="meta"),
                   (3,))


# ---- (c) the wrapper's argument check ---------------------------------------

@pytest.mark.parametrize("key,n", [
    (torch.zeros((4, 2), dtype=torch.int32), 0),
    (torch.zeros((4, 3), dtype=torch.int64), 0),
    (torch.zeros((), dtype=torch.int64), 0),
    (torch.zeros((4, 2), dtype=torch.int64), 2**62),
])
def test_check_keys_raises(key, n):
    with pytest.raises(ValueError):
        rng.check_keys(key, n)


def test_check_keys_passes():
    rng.check_keys(torch.zeros((4, 2), dtype=torch.int64), 10**9)
    rng.check_keys(torch.zeros((2,), dtype=torch.int64))
