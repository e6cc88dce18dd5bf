"""The block-fading (NBF) slice of the port against the JAX package.

  * draw_exp_pdp_taps and awgn: bit for bit equal to the JAX draws when fed
    the JAX package's normals, and within the normals' few-ulp band at the
    same keys (the port's erfinv rounds differently, test_torch_rng.py);
  * channel_svd_metrics (torch.linalg.svdvals) against the JAX Jacobi
    singular values: capacity and condition numbers within rtol 1e-5, ranks
    equal;
  * the condition histogram reproduces jnp.histogram, closed last bin and
    infinite edge included;
  * run_nbf_blocks (device="cpu", so every kernel's plain version runs)
    against the jitted JAX run_nbf_blocks on one device at identical block
    keys, on the tiny NBF configuration of tests/test_montecarlo.py in a 2x2
    variant with the QC code, offset min-sum and ESN noise 0, above and
    below the 6 dB doubled-iteration threshold. Measured at these keys:
    uncoded errors of the classical detectors and of the matched ESN
    identical; frame errors, BP iterations and unconverged codewords of all
    five detectors identical; rank, condition histogram identical, capacity
    within rtol 1e-5. Two bands remain, as in test_torch_slice.py: info-bit
    errors within 1% + 3 (every codeword of this tiny code fails, and the
    bits an unconverged BP ends on follow LLRs that differ by ulps: the
    normals differ by a few ulp and the equalisers' solves round
    differently), and the ESN detectors' uncoded errors within 1% + 10 (the
    ill-conditioned dual readout solve rounds differently; esn_fixed is 25
    of 7,168 bits apart at 3 dB);
  * the entry points' device policy.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import esn_ofdm_mimo_tpu  # noqa: F401  (sets the JAX package's precision)
from esn_ofdm_mimo_tpu import config as jc
from esn_ofdm_mimo_tpu.ops import channel as jch
from esn_ofdm_mimo_tpu.ops.analytics import channel_svd_metrics as j_svd
from esn_ofdm_mimo_tpu.pipelines import blockfading as jbf
from esn_ofdm_mimo_tpu.utils.rng import block_keys as j_block_keys
from esn_ofdm_mimo_tpu_torch import config as tc
from esn_ofdm_mimo_tpu_torch import ops as tops
from esn_ofdm_mimo_tpu_torch.parallel import nbf_snr_point, run_nbf_curve
from esn_ofdm_mimo_tpu_torch.pipelines import blockfading as tbf
from esn_ofdm_mimo_tpu_torch.utils import rng

G = 4
_JAX_STEP = {}


def _tiny(mod):
    """tests/test_montecarlo.py's tiny NBF config, 2x2, QC, offset min-sum,
    ESN noise 0, in the config classes of `mod` (either package)."""
    return mod.SimConfig(
        name="tiny",
        ofdm=mod.OfdmConfig(n_subcarriers=32, bits_per_symbol=4,
                            doppler_hz=3000.0),
        channel=mod.ChannelConfig(kind="exp_pdp", n_tx=2, n_rx=2),
        esn=mod.EsnConfig(n_reservoir=40, noise=0.0),
        ldpc=mod.LdpcConfig(max_iter=20, decode_every=2, family="qc",
                            algo="offset-minsum"),
        ebno_db=(3.0, 12.0))


def _jax_normals(keys, shape):
    """jax.random.normal at each (2,) key of a port key tensor."""
    k = keys.numpy().astype(np.uint32)
    out = jax.vmap(lambda q: jax.random.normal(q, shape))(
        jnp.asarray(k.reshape(-1, 2)))
    return torch.as_tensor(np.asarray(out).reshape(k.shape[:-1] + shape))


def _keys(seed, n=6):
    return jax.random.split(jax.random.PRNGKey(seed), n)


@pytest.mark.parametrize("isi", [8, 3])
def test_exp_pdp_taps_bitwise_with_the_same_normals(isi, monkeypatch):
    np.testing.assert_array_equal(tops.exp_pdp(isi).numpy(),
                                  np.asarray(jch.exp_pdp(isi)))
    keys = _keys(isi)
    want = np.asarray(jax.vmap(
        lambda k: jch.draw_exp_pdp_taps(k, 8, 4, isi))(keys))
    tkeys = rng.as_keys(np.asarray(keys))
    near = tops.draw_exp_pdp_taps(tkeys, 8, 4, isi).numpy()
    np.testing.assert_allclose(near, want, rtol=1e-6, atol=1e-7)
    monkeypatch.setattr(rng, "normal", _jax_normals)
    got = tops.draw_exp_pdp_taps(tkeys, 8, 4, isi).numpy()
    np.testing.assert_array_equal(got, want)


def test_awgn_bitwise_with_the_same_normals(monkeypatch):
    keys = _keys(3)
    want = np.asarray(jax.vmap(
        lambda k: jch.awgn(k, (3, 39), 1e-5, 39))(keys))
    tkeys = rng.as_keys(np.asarray(keys))
    near = tops.awgn(tkeys, (3, 39), 1e-5, 39).numpy()
    np.testing.assert_allclose(near, want, rtol=1e-6, atol=1e-9)
    monkeypatch.setattr(rng, "normal", _jax_normals)
    np.testing.assert_array_equal(
        tops.awgn(tkeys, (3, 39), 1e-5, 39).numpy(), want)


@pytest.mark.parametrize("n_rx,n_tx", [(8, 4), (2, 2), (2, 1), (1, 1)])
def test_channel_svd_metrics(n_rx, n_tx):
    r = np.random.default_rng(n_rx * 10 + n_tx)
    H = (r.standard_normal((3, 16, n_rx, n_tx))
         + 1j * r.standard_normal((3, 16, n_rx, n_tx))).astype(np.complex64)
    pi, No = np.float32(3.2e-4), 1e-5
    want = j_svd(jnp.asarray(H), jnp.float32(pi), No)
    got = tops.channel_svd_metrics(torch.as_tensor(H), float(pi), No)
    np.testing.assert_allclose(got.capacity_per_sc.numpy(),
                               np.asarray(want.capacity_per_sc), rtol=1e-5)
    np.testing.assert_allclose(got.cond.numpy(), np.asarray(want.cond),
                               rtol=1e-5)
    np.testing.assert_array_equal(got.rank.numpy(), np.asarray(want.rank))


def test_cond_histogram_matches_jnp_histogram():
    bins = np.asarray(jbf.COND_BINS)
    np.testing.assert_array_equal(tbf.COND_BINS, bins)
    r = np.random.default_rng(0)
    x = np.concatenate([10.0 ** r.uniform(0, 7, 500), bins, bins[[0, -1]],
                        [1e9, np.inf, 0.5]]).astype(np.float32)
    edges = jnp.concatenate([jnp.asarray([0.0]), jnp.asarray(bins),
                             jnp.asarray([jnp.inf])])
    want = np.asarray(jnp.histogram(jnp.asarray(x), bins=edges)[0])
    got = tbf.cond_histogram(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert got.sum() == x.size


def _jax_counts(ebno, snr_idx):
    if "step" not in _JAX_STEP:
        cfg = _tiny(jc)
        _JAX_STEP["step"] = jax.jit(
            lambda e, k: jbf.run_nbf_blocks(cfg, e, k))
    keys = j_block_keys(jax.random.PRNGKey(0), snr_idx,
                        jnp.arange(G, dtype=jnp.uint32))
    return np.asarray(keys), jax.device_get(
        _JAX_STEP["step"](jnp.float32(ebno), keys))


@pytest.mark.parametrize("ebno,snr_idx", [(12.0, 1), (3.0, 0)],
                         ids=["12dB", "3dB-doubled-cap"])
def test_run_nbf_blocks_matches_jax(ebno, snr_idx):
    keys, want = _jax_counts(ebno, snr_idx)
    got = nbf_snr_point(_tiny(tc), ebno, keys[None], device="cpu")
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
    for field in ("total_bits", "total_info_bits", "rank_full_sum",
                  "rank_count", "n_blocks", "ldpc_codewords"):
        assert getattr(got, field) == int(getattr(want, field)), field
    np.testing.assert_array_equal(got.cond_hist, np.asarray(want.cond_hist))
    np.testing.assert_allclose(got.capacity_sum, float(want.capacity_sum),
                               rtol=1e-5)
    # the doubled cap below 6 dB: unconverged codewords ran 2 * max_iter
    cap = 20 if ebno >= 6.0 else 40
    for d, n in got.ldpc_unconverged.items():
        assert got.ldpc_iter_sum[d] >= n * cap
    assert 0 < got.bit_errors["zf_perfect"] < got.total_bits // 2


def test_entry_points_need_a_device_argument_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    cfg = _tiny(tc)
    keys = np.zeros((1, 1, 2), np.uint32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nbf_snr_point(cfg, 12.0, keys)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_nbf_curve(cfg, 2, 2)


def test_curve_on_cpu_sums_its_snr_points():
    cfg = _tiny(tc)
    res = run_nbf_curve(cfg, blocks_per_snr=3, blocks_per_round=2,
                        device="cpu")
    assert res.n_blocks.tolist() == [4, 4]             # two whole rounds
    keys = rng.block_keys(rng.prng_key(cfg.seed), 1, torch.arange(4))
    pt = nbf_snr_point(cfg, 12.0, keys.reshape(2, 2, 2), device="cpu")
    assert res.total_bits[1] == pt.total_bits
    for d, v in pt.bit_errors.items():
        assert res.ber[d][1] == v / pt.total_bits
        assert res.ber_coded[d][1] == pt.info_errors[d] / pt.total_info_bits
    np.testing.assert_array_equal(res.cond_hist[1], pt.cond_hist)
    assert res.cond_hist.sum(1).tolist() == [4 * 32] * 2
    assert np.all(res.capacity_per_sc > 0)
