"""The SISO-AWGN preset's path and uncoded runs of the port against the JAX
package, on the CPU.

  * draw_flat_awgn_tap: bit for bit the JAX taps on 64 keys (the phases are
    the key-compatible uniforms, exp(j phase) rounds alike);
  * the tiny SISO-AWGN config of tests/test_siso_awgn_delayscan.py (N = 64,
    17 symbols, n_res 64, Gallager code n = 128, sum-product) through both
    packages' run_nbf_blocks on the same keys at 9 and 21 dB, ESN state
    noise 0: the uncoded counters of zf_perfect, zf_ls and mmse identical;
    their frame errors, BP iterations and unconverged codewords identical;
    info-bit errors and the ESN's uncoded errors within 1% + 3 and 1% + 10,
    the bands of tests/test_torch_nbf.py (LLRs that differ by ulps meet
    atanh rounding; the ESN's ill-conditioned readout solve); the scalar
    LS estimate H_ls within 1e-6, H_true equal;
  * the tiny 2x2 NBF config of tests/test_torch_nbf.py with
    ldpc.enabled=False: the JAX package's counters (classical detectors
    identical, ESN within its band, the coded counters all 0) and no decode
    called;
  * an uncoded curve: the adaptive top-up stops on uncoded bit errors, and
    save_nbf_results writes the JAX package's files (the CSV byte for byte,
    equal pickles, the same figures with the SISO capacity figure).
"""
import dataclasses
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import esn_ofdm_mimo_tpu  # noqa: F401  (sets the JAX package's precision)
from esn_ofdm_mimo_tpu import config as jc
from esn_ofdm_mimo_tpu.ops import channel as jch
from esn_ofdm_mimo_tpu.pipelines import blockfading as jbf
from esn_ofdm_mimo_tpu.pipelines import common as jcom
from esn_ofdm_mimo_tpu.utils.rng import block_keys as j_block_keys
from esn_ofdm_mimo_tpu_torch import config as tc
from esn_ofdm_mimo_tpu_torch import ops as tops
from esn_ofdm_mimo_tpu_torch.ldpc import decode as tdecode
from esn_ofdm_mimo_tpu_torch.ldpc import decode_cuda
from esn_ofdm_mimo_tpu_torch.parallel import nbf_snr_point
from esn_ofdm_mimo_tpu_torch.pipelines import blockfading as tbf
from esn_ofdm_mimo_tpu_torch.pipelines import common as tcom
from esn_ofdm_mimo_tpu_torch.utils import rng

torch.set_num_threads(1)

SISO_DETECTORS = ("esn", "zf_perfect", "zf_ls", "mmse")
CLASSICAL = ("zf_perfect", "zf_ls", "mmse")


def _awgn_tiny(mod):
    """tests/test_siso_awgn_delayscan.py's config, ESN state noise 0."""
    return mod.SimConfig(
        name="awgn_tiny",
        ofdm=mod.OfdmConfig(n_subcarriers=64, bits_per_symbol=2,
                            bits_per_pilot_symbol=2, isi_duration=1,
                            coherence_override=17),
        channel=mod.ChannelConfig(kind="awgn_flat", n_tx=1, n_rx=1,
                                  flat_scalar_ls=True),
        esn=mod.EsnConfig(n_reservoir=64, min_delay=0, max_delay=0,
                          train_ebno_fixed_db=None, noise=0.0),
        ldpc=mod.LdpcConfig(max_iter=20, yobs_half=False,
                            sigma2_mode="true_no"),
        ebno_db=(9.0, 21.0))


def _nbf_uncoded(mod):
    """tests/test_torch_nbf.py's tiny 2x2 config, uncoded."""
    return mod.SimConfig(
        name="tiny",
        ofdm=mod.OfdmConfig(n_subcarriers=32, bits_per_symbol=4,
                            doppler_hz=3000.0),
        channel=mod.ChannelConfig(kind="exp_pdp", n_tx=2, n_rx=2),
        esn=mod.EsnConfig(n_reservoir=40, noise=0.0),
        ldpc=mod.LdpcConfig(enabled=False), ebno_db=(3.0, 12.0))


@pytest.mark.parametrize("n_rx,n_tx", [(1, 1), (2, 2), (8, 4)])
def test_flat_awgn_taps_bit_exact(n_rx, n_tx):
    keys = jax.random.split(jax.random.PRNGKey(n_rx + 10 * n_tx), 64)
    want = np.asarray(jax.vmap(
        lambda k: jch.draw_flat_awgn_tap(k, n_rx, n_tx))(keys))
    got = tops.draw_flat_awgn_tap(rng.as_keys(np.asarray(keys)), n_rx,
                                  n_tx).numpy()
    assert got.dtype == np.complex64 and got.shape == (64, n_rx, n_tx, 1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(np.abs(got), 1.0, rtol=1e-6)


def _keys(snr_idx, n=4):
    return j_block_keys(jax.random.PRNGKey(0), snr_idx,
                        jnp.arange(n, dtype=jnp.uint32))


@pytest.mark.parametrize("ebno,snr_idx", [(9.0, 0), (21.0, 1)])
def test_siso_awgn_blocks_match_jax(ebno, snr_idx):
    keys = _keys(snr_idx)
    want = jax.device_get(jax.jit(lambda e, k: jbf.run_nbf_blocks(
        _awgn_tiny(jc), e, k, detectors=SISO_DETECTORS))(
        jnp.float32(ebno), keys))
    before = tdecode.graph_decodes
    got = tbf.run_nbf_blocks(_awgn_tiny(tc), ebno,
                             rng.as_keys(np.asarray(keys)),
                             detectors=SISO_DETECTORS)
    assert tdecode.graph_decodes == before + 1       # the Gallager code
    assert sorted(got.bit_errors) == sorted(SISO_DETECTORS)
    for d in SISO_DETECTORS:
        w = int(want.bit_errors[d])
        band = 0.01 * w + 10 if d == "esn" else 0
        assert abs(int(got.bit_errors[d]) - w) <= band, (d, got.bit_errors[d],
                                                         w)
        w = int(want.info_errors[d])
        assert abs(int(got.info_errors[d]) - w) <= 0.01 * w + 3, (
            d, got.info_errors[d], w)
    for field in ("frame_errors", "ldpc_iter_sum", "ldpc_unconverged"):
        g, w = getattr(got, field), getattr(want, field)
        for d in CLASSICAL:
            assert int(g[d]) == int(w[d]), (field, d)
    for field in ("total_bits", "total_info_bits", "ldpc_codewords",
                  "n_blocks", "rank_full_sum", "rank_count"):
        assert int(getattr(got, field)) == int(getattr(want, field)), field
    np.testing.assert_allclose(float(got.capacity_sum),
                               float(want.capacity_sum), rtol=1e-5)
    if ebno == 21.0:
        assert all(int(got.bit_errors[d]) == 0 for d in CLASSICAL)
    else:
        assert all(int(got.bit_errors[d]) > 0 for d in CLASSICAL)


@pytest.mark.parametrize("ebno", [9.0, 21.0])
def test_flat_scalar_ls_estimate_matches_jax(ebno):
    keys = _keys(0)
    want = jcom.synth_block(_awgn_tiny(jc), jnp.float32(ebno), keys)
    got = tcom.synth_block(_awgn_tiny(tc), ebno,
                           rng.as_keys(np.asarray(keys)))
    np.testing.assert_array_equal(got.taps.numpy(), np.asarray(want.taps))
    np.testing.assert_array_equal(got.H_true.numpy(), np.asarray(want.H_true))
    np.testing.assert_array_equal(got.H_mmse.numpy(), got.H_true.numpy())
    H_ls = got.H_ls.numpy()
    np.testing.assert_allclose(H_ls, np.asarray(want.H_ls), rtol=0, atol=1e-6)
    # one scalar per block, the same on every subcarrier
    assert np.all(H_ls == H_ls[:, :1])


@pytest.mark.parametrize("ebno,snr_idx", [(12.0, 1), (3.0, 0)])
def test_uncoded_nbf_matches_jax_without_a_decode(ebno, snr_idx,
                                                  monkeypatch):
    keys = _keys(snr_idx)
    want = jax.device_get(jax.jit(lambda e, k: jbf.run_nbf_blocks(
        _nbf_uncoded(jc), e, k))(jnp.float32(ebno), keys))

    def no_decode(*a, **k):
        raise AssertionError("an uncoded run decoded")
    monkeypatch.setattr(tbf, "ldpc_decode_bp_counts", no_decode)
    monkeypatch.setattr(tbf, "make_code", no_decode)
    before = (decode_cuda.launches, decode_cuda.launches_layered,
              tdecode.graph_decodes)
    phases = []
    got = nbf_snr_point(_nbf_uncoded(tc), ebno, np.asarray(keys)[None],
                        device="cpu", timings={})
    tbf.run_nbf_blocks(_nbf_uncoded(tc), ebno, rng.as_keys(np.asarray(keys)),
                       mark=phases.append)
    assert phases == ["synth", "esn_fit", "detect", "analytics"]
    assert (decode_cuda.launches, decode_cuda.launches_layered,
            tdecode.graph_decodes) == before
    for d in jbf._DETECTORS:
        w = int(want.bit_errors[d])
        band = 0.01 * w + 10 if d.startswith("esn") else 0
        assert abs(got.bit_errors[d] - w) <= band, (d, got.bit_errors[d], w)
        for field in ("info_errors", "frame_errors", "ldpc_iter_sum",
                      "ldpc_unconverged"):
            assert getattr(got, field)[d] == 0 == int(getattr(want, field)[d])
    assert got.total_info_bits == 0 == int(want.total_info_bits)
    assert got.ldpc_codewords == 0 == int(want.ldpc_codewords)
    assert got.total_bits == int(want.total_bits)
    np.testing.assert_array_equal(got.cond_hist, np.asarray(want.cond_hist))
    assert 0 < got.bit_errors["mmse"] < got.total_bits // 2


def test_uncoded_data_bits_fill_the_symbols():
    cfg = _nbf_uncoded(tc)
    keys = rng.as_keys(np.asarray(_keys(0)))
    bits, info = tcom.data_bits_for_blocks(cfg, keys, 5)
    assert info is None and bits.dtype == torch.int8
    assert tuple(bits.shape) == (4, 5, 2, 32 * 4)
    want, _ = jcom.data_bits_for_blocks(_nbf_uncoded(jc), _keys(0), 5)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(want))
    coded = dataclasses.replace(cfg, ldpc=tc.LdpcConfig(family="qc"))
    from esn_ofdm_mimo_tpu_torch.ldpc import make_code
    code = make_code(coded.ldpc, 128)
    cw, u = tcom.data_bits_for_blocks(coded, keys, 5, code)
    assert tuple(u.shape) == (4, 5, 2, code.k)
    assert tuple(cw.shape) == (4, 5, 2, code.n)


def _uncoded_siso(mod):
    c = _awgn_tiny(mod)
    return dataclasses.replace(c, ldpc=dataclasses.replace(c.ldpc,
                                                           enabled=False))


def test_uncoded_curve_tops_up_on_bit_errors():
    """With no code the adaptive top-up counts uncoded bit errors (JAX
    run_nbf_curve's coded_unit), without adaptive_on_uncoded."""
    from esn_ofdm_mimo_tpu_torch.parallel import run_nbf_curve
    cfg = dataclasses.replace(_uncoded_siso(tc), ebno_db=(9.0,))
    msgs = []
    res = run_nbf_curve(cfg, 1, blocks_per_round=1, device="cpu",
                        progress=msgs.append, adaptive_min_errors=10 ** 9,
                        adaptive_max_blocks=3)
    line, = [m for m in msgs if "adaptive" in m]
    assert "+2 blocks (3 total), bit errors {" in line
    assert res.n_blocks.tolist() == [3]
    assert res.total_info_bits.tolist() == [0]
    assert all(res.ber_coded[d][0] == 0 for d in res.ber_coded)


@pytest.mark.parametrize("figures", [False, True], ids=["files", "figures"])
def test_uncoded_siso_results_equal_the_jax_files(figures, tmp_path,
                                                  monkeypatch):
    """save_nbf_results of an uncoded SISO-AWGN curve: the CSV byte for
    byte, the pickles equal to the JAX package's writer fed the same
    results; with matplotlib the same figure files (pre-LDPC and the SISO
    capacity figure; no post-LDPC figure with every coded BER 0)."""
    from esn_ofdm_mimo_tpu.parallel import montecarlo as jmc
    from esn_ofdm_mimo_tpu.utils import reporting as jrep
    from esn_ofdm_mimo_tpu_torch.parallel import run_nbf_curve
    from esn_ofdm_mimo_tpu_torch.utils import reporting as trep
    if figures and trep._plt() is None:
        pytest.skip("matplotlib is not installed")
    if not figures:
        monkeypatch.setattr(jrep, "_plt", lambda: None)
        monkeypatch.setattr(trep, "_plt", lambda: None)
    cfg = _uncoded_siso(tc)
    res = run_nbf_curve(cfg, 1, blocks_per_round=1, device="cpu",
                        progress=None)
    jrep.save_nbf_results(str(tmp_path / "jax"), _uncoded_siso(jc),
                          jmc.CurveResult(**dataclasses.asdict(res)))
    trep.save_nbf_results(str(tmp_path / "port"), cfg, res)
    a = {p.name: p.read_bytes() for p in (tmp_path / "jax").iterdir()}
    b = {p.name: p.read_bytes() for p in (tmp_path / "port").iterdir()}
    assert sorted(a) == sorted(b)
    assert a["results_ber.csv"] == b["results_ber.csv"]
    head = b["results_ber.csv"].decode().splitlines()[0]
    assert head == ("EbNo(dB),esn_uncoded,mmse_uncoded,zf_ls_uncoded,"
                    "zf_perfect_uncoded,esn_coded,mmse_coded,zf_ls_coded,"
                    "zf_perfect_coded")
    for name in ("channel_metrics_1x1.pkl", "results_ber.pkl"):
        assert pickle.loads(a[name]) == pickle.loads(b[name])
    if figures:
        assert {"BER_curves.png", "BER_preLDPC_1x1.png",
                "siso_channel_capacity.png"} <= set(b)
        assert "BER_postLDPC_1x1.png" not in b
