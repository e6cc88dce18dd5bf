"""The port's per-symbol equalisers (ops/equalize.py: equalize_zf,
equalize_mmse, equalize_persc) against the JAX package's, on the CPU, as
tests/test_channel_chanest.py holds the JAX ones:

  * on noiseless received symbols both recover the transmitted ones (rtol
    1e-2, atol 1e-3) and agree with the JAX solve within 1e-5 relative (the
    JAX package embeds the complex system in a real one and factors it by
    an unrolled Cholesky; the port the same real system by a batched one);
  * equalize_persc (ZF and MMSE) within 1e-5 relative of JAX's, and the
    factored detect path (equalizer_weights + apply_equalizer) equal to it
    within the JAX test's rtol 2e-4 / atol 2e-5.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import esn_ofdm_mimo_tpu  # noqa: F401  (sets the JAX package's precision)
from esn_ofdm_mimo_tpu.ops import equalize as jeq
from esn_ofdm_mimo_tpu_torch.ops import equalize as teq

torch.set_num_threads(1)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _cplx(r, shape):
    return (r.standard_normal(shape)
            + 1j * r.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("kind", ["zf", "mmse"])
def test_per_symbol_equalizer_recovers_and_matches_jax(kind):
    r = np.random.default_rng(3)
    N, n_rx, n_tx, sqrt_pi = 64, 4, 2, 2.0
    H, x = _cplx(r, (N, n_rx, n_tx)), _cplx(r, (N, n_tx))
    y = np.einsum("krt,kt->kr", H, x) * sqrt_pi
    if kind == "zf":
        want = np.asarray(jeq.equalize_zf(jnp.asarray(y), jnp.asarray(H),
                                          sqrt_pi))
        got = teq.equalize_zf(torch.as_tensor(y), torch.as_tensor(H),
                              sqrt_pi).numpy()
    else:
        want = np.asarray(jeq.equalize_mmse(jnp.asarray(y), jnp.asarray(H),
                                            sqrt_pi, 1e-9))
        got = teq.equalize_mmse(torch.as_tensor(y), torch.as_tensor(H),
                                sqrt_pi, 1e-9).numpy()
    assert got.dtype == np.complex64 and got.shape == (N, n_tx)
    np.testing.assert_allclose(got, x, rtol=1e-2, atol=1e-3)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("reg", [None, 0.23], ids=["zf", "mmse"])
def test_equalize_persc_matches_jax_and_factored_path(reg):
    r = np.random.default_rng(10)
    B, D, n_rx, n_tx, N = 3, 5, 8, 4, 16
    H, Y = _cplx(r, (B, N, n_rx, n_tx)), _cplx(r, (B, D, n_rx, N))
    sqrt_pi = 1.7
    want = np.asarray(jeq.equalize_persc(jnp.asarray(Y),
                                         jnp.asarray(H)[:, None], sqrt_pi,
                                         noise_over_power=reg))
    got = teq.equalize_persc(torch.as_tensor(Y), torch.as_tensor(H)[:, None],
                             sqrt_pi, noise_over_power=reg).numpy()
    assert got.shape == (B, D, N, n_tx)
    assert _rel(got, want) <= 1e-5
    W = teq.equalizer_weights(torch.as_tensor(H),
                              teq._ZF_LOAD if reg is None else reg)
    fast = teq.apply_equalizer(W, torch.as_tensor(Y), sqrt_pi).numpy()
    np.testing.assert_allclose(fast, got, rtol=2e-4, atol=2e-5)
