"""Modem primitives, channel, estimation and equalisers of the port against
the JAX functions on the same numpy inputs.

Complex results compare at rtol 1e-4 and atol 1e-5 of the signal scale
(torch.fft vs the JAX package's DFT-as-matmul `fft_mxu`, and a complex64
solve vs its real-embedded Cholesky, round differently); exact where both
sides compute the same integer or table lookups."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import esn_ofdm_mimo_tpu  # noqa: F401  (sets the JAX package's precision)
from esn_ofdm_mimo_tpu import ops as jops
from esn_ofdm_mimo_tpu.ops import channel as jch
from esn_ofdm_mimo_tpu.ops import chanest as jce
from esn_ofdm_mimo_tpu.ops import equalize as jeq
from esn_ofdm_mimo_tpu.ops import qam as jqam
from esn_ofdm_mimo_tpu.ops.fft_mxu import fft_mxu, ifft_mxu
from esn_ofdm_mimo_tpu.ops.pa import clip_amplitude as j_clip
from esn_ofdm_mimo_tpu_torch import ops as tops
from esn_ofdm_mimo_tpu_torch.ops import channel as tch
from esn_ofdm_mimo_tpu_torch.ops import qam as tqam
from esn_ofdm_mimo_tpu_torch.utils import rng

RTOL, ATOL_REL = 1e-4, 1e-5


def _close(got, want):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_REL * scale)


def _cn(rng_np, shape, s=1.0):
    return (s * (rng_np.standard_normal(shape)
                 + 1j * rng_np.standard_normal(shape))).astype(np.complex64)


@pytest.mark.parametrize("m", [2, 4, 6])
def test_qam_tables_and_mapping(m):
    np.testing.assert_array_equal(tqam.qam_constellation(m).numpy(),
                                  np.asarray(jqam.qam_constellation(m)))
    np.testing.assert_array_equal(tqam.qam_bit_labels(m).numpy(),
                                  np.asarray(jqam.qam_bit_labels(m)))
    np.testing.assert_array_equal(tqam.pam_axis_points(m).numpy(),
                                  np.asarray(jqam.pam_axis_points(m)))
    r = np.random.default_rng(m)
    bits = r.integers(0, 2, (3, 5, 8 * m)).astype(np.int8)
    np.testing.assert_array_equal(
        tops.bits_to_symbols(torch.as_tensor(bits), m).numpy(),
        np.asarray(jops.bits_to_symbols(jnp.asarray(bits), m)))
    z = _cn(r, (3, 40), 0.8)
    np.testing.assert_array_equal(
        tops.symbols_to_bits_hard(torch.as_tensor(z), m).numpy(),
        np.asarray(jops.symbols_to_bits_hard(jnp.asarray(z), m)))


@pytest.mark.parametrize("N,cp", [(32, 7), (128, 7)])
def test_ofdm_and_fft(N, cp):
    r = np.random.default_rng(N)
    X = _cn(r, (2, 3, N))
    _close(tops.ofdm_modulate(torch.as_tensor(X), cp).numpy(),
           jops.ofdm_modulate(jnp.asarray(X), cp))
    y = _cn(r, (2, 3, N + cp))
    _close(tops.ofdm_demodulate(torch.as_tensor(y), cp).numpy(),
           jops.ofdm_demodulate(jnp.asarray(y), cp))
    # the JAX package's DFT-as-matmul is what torch.fft replaces
    _close(torch.fft.fft(torch.as_tensor(X), dim=-1).numpy(),
           fft_mxu(jnp.asarray(X), axis=-1))
    _close(torch.fft.ifft(torch.as_tensor(X), dim=-2).numpy(),
           ifft_mxu(jnp.asarray(X), axis=-2))


@pytest.mark.parametrize("p,clip_db", [(1.0, 3.0), (2.0, 0.0)])
def test_rapp_pa(p, clip_db):
    r = np.random.default_rng(1)
    x = _cn(r, (4, 64), 3.0)
    var_x = 12.5
    a = tops.clip_amplitude(var_x, clip_db)
    np.testing.assert_allclose(a, float(j_clip(jnp.float32(var_x), clip_db)),
                               rtol=1e-6)
    _close(tops.rapp_pa(torch.as_tensor(x), a, p).numpy(),
           jops.rapp_pa(jnp.asarray(x), jnp.float32(a), p))


@pytest.mark.parametrize("m", [2, 4])
def test_llrs_and_sigma2(m):
    r = np.random.default_rng(m + 10)
    z = _cn(r, (3, 2, 50), 0.7)
    s2_t = tops.est_sigma2_from_decision(torch.as_tensor(z), m)
    s2_j = jops.est_sigma2_from_decision(jnp.asarray(z), m)
    np.testing.assert_allclose(s2_t.numpy(), np.asarray(s2_j), rtol=1e-5)
    got = tops.qam_llrs_maxlog(torch.as_tensor(z), s2_t, m)
    want = jops.qam_llrs_maxlog(jnp.asarray(z), s2_j, m)
    _close(got.numpy(), want)


@pytest.mark.parametrize("profile", ["a", "b", "c"])
def test_tdl_taps_at_identical_keys(profile):
    np.testing.assert_array_equal(
        tch._tdl_split_matrix(profile, 8, 2.048e6, 300.0),
        jch._tdl_split_matrix(profile, 8, 2.048e6, 300.0))
    keys = jax.random.split(jax.random.PRNGKey(5), 6)
    want = jax.vmap(lambda k: jch.draw_tdl_taps(
        k, 8, 4, 8, 2.048e6, 300.0, profile=profile))(keys)
    got = tops.draw_tdl_taps(rng.as_keys(np.asarray(keys)), 8, 4, 8,
                             2.048e6, 300.0, profile=profile)
    # the gains are normals (a few ulp apart, test_torch_rng.py)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("isi,T", [(8, 39), (3, 20)])
def test_fir_channel_lfilter_semantics(isi, T):
    from scipy.signal import lfilter

    r = np.random.default_rng(isi)
    taps = _cn(r, (2, 3, 4, isi), 0.5)        # (B, n_rx, n_tx, isi)
    x = _cn(r, (2, 4, T))                     # (B, n_tx, T)
    got = tops.apply_fir_channel(torch.as_tensor(taps), torch.as_tensor(x))
    _close(got.numpy(), jops.apply_fir_channel(jnp.asarray(taps),
                                               jnp.asarray(x)))
    # causal, truncated to T: scipy's lfilter per link, summed over TX
    want = np.zeros((2, 3, T), np.complex128)
    for b in range(2):
        for rx in range(3):
            for tx in range(4):
                want[b, rx] += lfilter(taps[b, rx, tx], [1.0], x[b, tx])
    _close(got.numpy(), want)
    # broadcasting over a data-symbol axis, as detect_data_symbols uses it
    xd = _cn(r, (2, 5, 4, T))
    got_d = tops.apply_fir_channel(torch.as_tensor(taps)[:, None],
                                   torch.as_tensor(xd))
    _close(got_d.numpy(), jops.apply_fir_channel(jnp.asarray(taps)[:, None],
                                                 jnp.asarray(xd)))


def test_taps_to_freq_response():
    r = np.random.default_rng(3)
    taps = _cn(r, (2, 8, 4, 8), 0.4)
    _close(tops.taps_to_freq_response(torch.as_tensor(taps), 128).numpy(),
           jops.taps_to_freq_response(jnp.asarray(taps), 128))


@pytest.mark.parametrize("N,n_tx,n_rx", [(32, 2, 4), (128, 4, 8)])
def test_estimate_channel(N, n_tx, n_rx):
    r = np.random.default_rng(N)
    X = tqam.qam_constellation(4).numpy()[r.integers(0, 16, (3, n_tx, N))]
    comb = (np.arange(N)[None, :] % n_tx) == np.arange(n_tx)[:, None]
    X_ls = (X * comb).astype(np.complex64)
    Y_ls = _cn(r, (3, n_rx, N), 0.05)
    sqrt_pi, No, pi = 0.03, 1e-5, np.float32(9e-4)
    H_ls_j, H_mmse_j = jce.estimate_channel(
        jnp.asarray(Y_ls), jnp.asarray(X_ls), jnp.float32(sqrt_pi), n_tx, 8,
        No, jnp.float32(pi))
    scaler = float(np.float32(No) / pi / np.float32(N / 2.0))
    H_ls_t, H_mmse_t = tops.estimate_channel(
        torch.as_tensor(Y_ls), torch.as_tensor(X_ls), sqrt_pi, n_tx, 8,
        scaler)
    _close(H_ls_t.numpy(), H_ls_j)
    _close(H_mmse_t.numpy(), H_mmse_j)


@pytest.mark.parametrize("reg", [1e-12, 1e-2])
def test_equalizer(reg):
    r = np.random.default_rng(7)
    H = _cn(r, (3, 16, 8, 4), 0.7)             # (B, N, n_rx, n_tx)
    Y = _cn(r, (3, 5, 8, 16))                  # (B, D, n_rx, N)
    W_j = jeq.equalizer_weights(jnp.asarray(H), jnp.float32(reg))
    want = jeq.apply_equalizer(W_j, jnp.asarray(Y), jnp.float32(0.5))
    W_t = tops.equalizer_weights(torch.as_tensor(H), reg)
    got = tops.apply_equalizer(W_t, torch.as_tensor(Y), 0.5)
    _close(got.numpy(), want)
