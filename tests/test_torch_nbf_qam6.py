"""The block-fading (NBF) path at 64-QAM (`--qam-bits 6`) against the JAX
package: run_nbf_blocks (device="cpu", so every kernel's plain version runs)
against the jitted JAX run_nbf_blocks at identical block keys, on the tiny
NBF configuration of tests/test_torch_nbf.py with 6 bits a symbol (n = 192,
Z = 24), at 12 and 28 dB. The same fields and bands as
test_torch_nbf.py:test_run_nbf_blocks_matches_jax: uncoded errors of the
classical detectors identical, frame errors, BP iterations and unconverged
codewords identical, info-bit errors within 1% + 3, the ESN detectors'
uncoded errors within 1% + 10. And the relation the full-width preset shows
at 64-QAM in both packages: MMSE's coded BER is the same side of its
uncoded BER in the port as in the JAX package.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import esn_ofdm_mimo_tpu  # noqa: F401  (sets the JAX package's precision)
from esn_ofdm_mimo_tpu import config as jc
from esn_ofdm_mimo_tpu.pipelines import blockfading as jbf
from esn_ofdm_mimo_tpu.utils.rng import block_keys as j_block_keys
from esn_ofdm_mimo_tpu_torch import config as tc
from esn_ofdm_mimo_tpu_torch.parallel import nbf_snr_point

# One intra-op thread per worker process (see tests/test_torch_curve.py).
torch.set_num_threads(1)

G = 4
_JAX_STEP = {}


def _tiny64(mod):
    """tests/test_torch_nbf.py's tiny NBF config at 6 bits a symbol."""
    return mod.SimConfig(
        name="tiny64",
        ofdm=mod.OfdmConfig(n_subcarriers=32, bits_per_symbol=6,
                            doppler_hz=3000.0),
        channel=mod.ChannelConfig(kind="exp_pdp", n_tx=2, n_rx=2),
        esn=mod.EsnConfig(n_reservoir=40, noise=0.0),
        ldpc=mod.LdpcConfig(max_iter=20, decode_every=2, family="qc",
                            algo="offset-minsum"),
        ebno_db=(12.0, 28.0))


def _jax_counts(ebno, snr_idx):
    if "step" not in _JAX_STEP:
        cfg = _tiny64(jc)
        _JAX_STEP["step"] = jax.jit(
            lambda e, k: jbf.run_nbf_blocks(cfg, e, k))
    keys = j_block_keys(jax.random.PRNGKey(0), snr_idx,
                        jnp.arange(G, dtype=jnp.uint32))
    return np.asarray(keys), jax.device_get(
        _JAX_STEP["step"](jnp.float32(ebno), keys))


@pytest.mark.parametrize("ebno,snr_idx", [(12.0, 0), (28.0, 1)],
                         ids=["12dB", "28dB"])
def test_run_nbf_blocks_matches_jax_at_64qam(ebno, snr_idx):
    keys, want = _jax_counts(ebno, snr_idx)
    got = nbf_snr_point(_tiny64(tc), ebno, keys[None], device="cpu")
    assert sorted(got.bit_errors) == sorted(jbf._DETECTORS)
    for field in ("frame_errors", "ldpc_iter_sum", "ldpc_unconverged"):
        g, w = getattr(got, field), getattr(want, field)
        assert g == {d: int(v) for d, v in w.items()}, field
    for d in jbf._DETECTORS:
        w = int(want.bit_errors[d])
        band = 0.01 * w + 10 if d.startswith("esn") else 0
        assert abs(got.bit_errors[d] - w) <= band, (d, got.bit_errors[d], w)
        w = int(want.info_errors[d])
        assert abs(got.info_errors[d] - w) <= 0.01 * w + 3, (
            d, got.info_errors[d], w)
    for field in ("total_bits", "total_info_bits", "n_blocks",
                  "ldpc_codewords"):
        assert getattr(got, field) == int(getattr(want, field)), field
    # MMSE coded against uncoded BER: the same side in both packages
    ber = lambda c: (int(c.bit_errors["mmse"]) / int(c.total_bits),  # noqa
                     int(c.info_errors["mmse"]) / int(c.total_info_bits))
    (gu, gc), (wu, wc) = ber(got), ber(want)
    assert (gc <= gu) == (wc <= wu), (gu, gc, wu, wc)
    assert 0 < gu < 0.5
