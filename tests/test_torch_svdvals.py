"""The port's small SVD (ops/analytics.py:svdvals_small; on the card the
CUDA kernel csrc/svdvals_small.cu, held against the plain version in
chip_smoke.py `[svd]`) and the fixed-length condition histogram.

  * the plain svdvals_small (cyclic Jacobi on the Hermitian n_t x n_t Gram
    H^H H) against the JAX package's svdvals_small
    (esn_ofdm_mimo_tpu/ops/linalg_mxu.py, the same sweeps on the
    real-embedded 2 n_t x 2 n_t Gram) at the shapes of the four NBF presets, (8, 4),
    (2, 2), (2, 1), (1, 1), on Gaussian, ill-conditioned (one column scaled
    by 1e-3) and rank-deficient H (one column a multiple of another): each
    value within rtol 1e-5 plus an atol relative to the matrix's largest
    singular value s1: 2e-6 s1 where H has full rank (the two libraries
    round the Gram and the rotations differently, ~1e-6 s1 measured), 1e-3
    s1 for rank-deficient H, whose null singular values are the square
    roots of the Gram's rounding noise (sqrt(8 eps) s1 ~ 7e-4 s1; the
    port's lie as far from float64's as JAX's do);
  * the analytics at a round's scale: 4,096 channel matrices of the 8x4
    and 2x2 NBF presets (the port's tap draw and frequency response), the
    port's channel_svd_metrics against the JAX package's: ranks and the
    condition histogram equal, capacity within rtol 1e-5;
  * the Hermitian form's structure, exactly: at n_t = 1 no rotation (S is
    the square root of sum |h|^2 folded in row order), at n_t = 2 the
    first rotation zeroes the off-diagonal, so a second sweep changes no
    bit, and an all-zero H gives 0;
  * the shapes it refuses;
  * channel_svd_metrics with Pi as a float and as a 0-d tensor (an
    EbnoRow's): identical;
  * cond_histogram (index_add_ into len(COND_BINS) + 1 bins) against the
    torch.bincount form it replaced, exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import esn_ofdm_mimo_tpu  # noqa: F401  (sets the JAX package's precision)
from esn_ofdm_mimo_tpu.ops.analytics import channel_svd_metrics as j_svd
from esn_ofdm_mimo_tpu.ops.linalg_mxu import svdvals_small as j_svdvals
from esn_ofdm_mimo_tpu_torch.experiments.presets import (mimo_2x2_nbf,
                                                         mimo_4x8_nbf)
from esn_ofdm_mimo_tpu_torch.ops import analytics, taps_to_freq_response
from esn_ofdm_mimo_tpu_torch.pipelines import blockfading as tbf
from esn_ofdm_mimo_tpu_torch.pipelines.common import (_K_CHAN, _draw_taps,
                                                      ebno_row)
from esn_ofdm_mimo_tpu_torch.utils import rng

torch.set_num_threads(1)

ATOL = {"gaussian": 2e-6, "ill-conditioned": 2e-6, "rank-deficient": 1e-3}


def _H(n_r, n_t, kind, seed):
    r = np.random.default_rng(seed)
    H = (r.standard_normal((4, 32, n_r, n_t))
         + 1j * r.standard_normal((4, 32, n_r, n_t)))
    if kind == "ill-conditioned":
        H[..., -1] *= 1e-3
    elif kind == "rank-deficient" and n_t > 1:
        H[..., -1] = (0.3 - 0.2j) * H[..., 0]
    elif kind == "rank-deficient":
        H[:8] = 0.0                       # a zero column: S = 0
    return H.astype(np.complex64)


@pytest.mark.parametrize("kind", list(ATOL))
@pytest.mark.parametrize("n_r,n_t", [(8, 4), (2, 2), (2, 1), (1, 1)])
def test_plain_svdvals_small_matches_jax(n_r, n_t, kind):
    H = _H(n_r, n_t, kind, 10 * n_r + n_t)
    want = np.asarray(j_svdvals(jnp.asarray(H)))
    got = analytics.svdvals_small(torch.as_tensor(H)).numpy()
    assert got.shape == want.shape == H.shape[:-2] + (n_t,)
    assert got.dtype == np.float32
    assert np.all(np.diff(got, axis=-1) <= 0)       # descending
    s1 = want[..., :1]
    np.testing.assert_array_less(np.abs(got - want),
                                 1e-5 * np.abs(want) + ATOL[kind] * s1
                                 + 1e-30)


@pytest.mark.parametrize("preset", [mimo_4x8_nbf, mimo_2x2_nbf],
                         ids=["8x4", "2x2"])
def test_svd_analytics_match_jax_at_round_scale(preset):
    c = preset()
    n = c.ofdm.n_subcarriers
    keys = rng.block_keys(rng.prng_key(0), c.ebno_db.index(12.0),
                          torch.arange(4096 // n))
    H = taps_to_freq_response(_draw_taps(c, rng.fold_in(keys, _K_CHAN)), n)
    assert H.shape == (4096 // n, n, c.channel.n_rx, c.channel.n_tx)
    pi, No = ebno_row(c, 12.0, "cpu").pi, c.ofdm.noise_psd
    got = analytics.channel_svd_metrics(H, pi, No)
    want = j_svd(jnp.asarray(H.numpy()), jnp.float32(pi.item()), No)
    np.testing.assert_array_equal(got.rank.numpy(), np.asarray(want.rank))
    assert torch.equal(tbf.cond_histogram(got.cond), tbf.cond_histogram(
        torch.as_tensor(np.asarray(want.cond))))
    np.testing.assert_allclose(got.capacity_per_sc.numpy(),
                               np.asarray(want.capacity_per_sc), rtol=1e-5)


def test_hermitian_jacobi_structure(monkeypatch):
    # n_t = 1: no rotation, S = sqrt(sum_i hr_i^2 + hi_i^2) in row order
    H = _H(8, 1, "gaussian", 5)
    acc = H.real[..., 0, 0] * H.real[..., 0, 0] + H.imag[..., 0, 0] \
        * H.imag[..., 0, 0]
    for i in range(1, 8):
        acc = acc + (H.real[..., i, 0] * H.real[..., i, 0]
                     + H.imag[..., i, 0] * H.imag[..., i, 0])
    assert acc.dtype == np.float32
    got = analytics.svdvals_small(torch.as_tensor(H))
    # torch's square root (on the CPU it may be 1 ulp off numpy's)
    assert torch.equal(got[..., 0], torch.sqrt(torch.as_tensor(acc)))
    # n_t = 2: one rotation a sweep zeroes a_01, so later sweeps are no-ops
    H = torch.as_tensor(_H(2, 2, "gaussian", 6))
    full = analytics.svdvals_small(H)
    monkeypatch.setattr(analytics, "SWEEPS", 1)
    assert torch.equal(analytics.svdvals_small(H), full)
    monkeypatch.undo()
    # an all-zero H: every singular value 0
    for n_r, n_t in ((8, 4), (2, 2), (2, 1), (1, 1)):
        S = analytics.svdvals_small(torch.zeros((3, n_r, n_t),
                                                dtype=torch.complex64))
        assert S.shape == (3, n_t) and not S.any()


def test_svdvals_small_refuses_other_shapes():
    for shape in ((4, 3), (9, 4), (4, 8)):
        H = torch.zeros((2,) + shape, dtype=torch.complex64)
        with pytest.raises(ValueError, match="n_t in"):
            analytics.svdvals_small(H)
    with pytest.raises(ValueError, match="complex64"):
        analytics.svdvals_small(torch.zeros(2, 8, 4))


def test_channel_svd_metrics_takes_pi_as_a_tensor():
    H = torch.as_tensor(_H(8, 4, "gaussian", 3))
    pi = np.float32(3.2e-4)
    a = analytics.channel_svd_metrics(H, float(pi), 1e-5)
    b = analytics.channel_svd_metrics(H, torch.tensor(pi), 1e-5)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _bincount_form(cond: torch.Tensor) -> torch.Tensor:
    """The histogram as the port computed it before: torch.bincount."""
    edges = torch.as_tensor(np.concatenate(
        [[0.0], tbf.COND_BINS, [np.inf]]).astype(np.float32))
    x = cond.reshape(-1).to(torch.float32)
    idx = torch.bucketize(x, edges, right=True)
    idx = torch.where(x == edges[-1], edges.numel() - 1, idx)
    return torch.bincount(idx, minlength=edges.numel() + 1)[1:edges.numel()]


def test_cond_histogram_equals_the_bincount_form():
    r = np.random.default_rng(1)
    bins = tbf.COND_BINS
    x = np.concatenate([10.0 ** r.uniform(-1, 7, 4000), bins, bins[[0, -1]],
                        np.nextafter(bins, 0), [0.0, -1.0, 1e9, np.inf,
                                                np.nan, 0.5]])
    x = torch.as_tensor(x.astype(np.float32)).reshape(-1, 2)
    got = tbf.cond_histogram(x)
    want = _bincount_form(x)
    assert got.dtype == want.dtype == torch.int64
    assert got.shape == (len(bins) + 1,)
    assert torch.equal(got, want)
