"""The three small helpers of the port against the JAX package:
`ldpc_extract_message` (exact, tests/test_ldpc.py:36), the channel
frequency correlation of a PDP (within 1e-5 of JAX's, Hermitian Toeplitz
with a unit diagonal, tests/test_channel_chanest.py:136-140) and
`draw_cdlb_taps` (against JAX on the same keys at the tolerance of
test_torch_ops.py's TDL taps, rtol 1e-5 / atol 1e-6: the gains are the
key-compatible normals, a few ulp from JAX's (test_torch_rng.py), not
bit-exact; and equal to `draw_tdl_taps(..., profile="b")` bit for bit;
tests/test_channel_chanest.py:58, :195-211)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import esn_ofdm_mimo_tpu  # noqa: F401
from esn_ofdm_mimo_tpu.ldpc.code import make_regular_ldpc as j_regular
from esn_ofdm_mimo_tpu.ldpc.encode import (ldpc_encode as j_encode,
                                           ldpc_extract_message as j_extract)
from esn_ofdm_mimo_tpu.ops import channel as jch
from esn_ofdm_mimo_tpu.ops.chanest import channel_freq_correlation as j_corr
from esn_ofdm_mimo_tpu_torch import ldpc as tldpc
from esn_ofdm_mimo_tpu_torch import ops as tops
from esn_ofdm_mimo_tpu_torch.ldpc.code import make_regular_ldpc
from esn_ofdm_mimo_tpu_torch.utils import rng

torch.set_num_threads(1)


def test_ldpc_extract_message_is_the_message():
    code = make_regular_ldpc(512, 4, 8, seed=0)
    u = np.random.default_rng(0).integers(0, 2, size=(8, code.k))
    cw = tldpc.ldpc_encode(code, torch.as_tensor(u))
    got = tldpc.ldpc_extract_message(code, cw)
    assert got.shape == (8, code.k) and got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), u)
    jcode = j_regular(512, 4, 8, seed=0)
    want = j_extract(jcode, j_encode(jcode, jnp.asarray(u)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # any leading axes
    cw3 = cw.reshape(2, 4, code.n)
    assert torch.equal(tldpc.ldpc_extract_message(code, cw3),
                       got.reshape(2, 4, code.k))


@pytest.mark.parametrize("isi,N", [(8, 32), (3, 128)])
def test_channel_freq_correlation_matches_jax(isi, N):
    pdp = tops.exp_pdp(isi)
    R = tops.channel_freq_correlation(pdp, N)
    assert R.shape == (N, N) and R.dtype == torch.complex64
    want = np.asarray(j_corr(jnp.asarray(pdp.numpy()), N))
    np.testing.assert_allclose(R.numpy(), want, atol=1e-5)
    Rn = R.numpy()
    np.testing.assert_allclose(Rn, Rn.conj().T, atol=1e-5)     # Hermitian
    np.testing.assert_allclose(np.diag(Rn), 1.0, atol=1e-5)    # sum pdp = 1
    for d in (1, 5):                                            # Toeplitz
        np.testing.assert_allclose(np.diagonal(Rn, d), Rn[0, d], atol=1e-5)


def test_draw_cdlb_taps_matches_jax():
    keys = jax.random.split(jax.random.PRNGKey(3), 16)
    want = jax.vmap(lambda k: jch.draw_cdlb_taps(k, 8, 4, 8, 2 * 1.024e6,
                                                 300.0))(keys)
    tk = rng.as_keys(np.asarray(keys))
    got = tops.draw_cdlb_taps(tk, 8, 4, 8, 2 * 1.024e6, 300.0)
    assert got.shape == (16, 8, 4, 8) and got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose((got.abs() ** 2).sum(-1).numpy(), 1.0,
                               rtol=1e-4)
    assert torch.equal(got, tops.draw_tdl_taps(tk, 8, 4, 8, 2 * 1.024e6,
                                               300.0, profile="b"))
