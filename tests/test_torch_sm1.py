"""The port's system-model-1 frontend (esn_ofdm_mimo_tpu_torch/sm1, the Gray
QAM conventions of ops/qam.py, and pipelines/classification.py's
make_equalized_dataset_sm1) against the JAX package's, on the CPU:

  * the Gray constellation, MSB-first labels, packing, mapping and hard
    demapper: equal (bit for bit);
  * the resource grid's index sets, pilot pattern and pilots at the same
    key, map_data / extract_data, subcarrier frequencies and ebnodb2no:
    equal;
  * cdl_cir and cir_to_ofdm_channel at the same key: the same rays (the
    draws are bit-exact) in complex64 einsums against JAX's real einsums,
    within CHANNEL_ATOL (measured: 8e-8 on gains of ~0.13, 1.5e-6 on the
    unit-power response);
  * ls_nn_estimate and lmmse_equalize_grid on identical inputs: the port
    solves the complex system by batched Cholesky, JAX its real embedding
    by an unrolled Cholesky, within RX_ATOL;
  * make_equalized_dataset_sm1 at batch 2 (12,288 symbols) at 0, 10 and
    20 dB: the labels identical, the features within FEATURE_ATOL
    (measured: at most 4.1e-6 on features of magnitude up to ~2).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import esn_ofdm_mimo_tpu  # noqa: F401  (sets the JAX package's precision)
from esn_ofdm_mimo_tpu.ops import qam as jq
from esn_ofdm_mimo_tpu.pipelines import classification as jpc
from esn_ofdm_mimo_tpu.sm1 import cdl as jcdl
from esn_ofdm_mimo_tpu.sm1 import grid as jgrid
from esn_ofdm_mimo_tpu.sm1 import rx as jrx
from esn_ofdm_mimo_tpu_torch.ops import qam as tq
from esn_ofdm_mimo_tpu_torch.pipelines import classification as tpc
from esn_ofdm_mimo_tpu_torch.sm1 import cdl as tcdl
from esn_ofdm_mimo_tpu_torch.sm1 import grid as tgrid
from esn_ofdm_mimo_tpu_torch.sm1 import rx as trx
from esn_ofdm_mimo_tpu_torch.utils import rng

torch.set_num_threads(1)

CHANNEL_ATOL = 1e-5
RX_ATOL = 2e-5
FEATURE_ATOL = 3e-5


def _tk(k):
    return rng.as_keys(np.asarray(k))


@pytest.mark.parametrize("m", [2, 4, 6])
def test_gray_qam_equal(m):
    np.testing.assert_array_equal(tq.qam_constellation_gray(m).numpy(),
                                  np.asarray(jq.qam_constellation_gray(m)))
    np.testing.assert_array_equal(tq.qam_bit_labels_msb(m).numpy(),
                                  np.asarray(jq.qam_bit_labels_msb(m)))
    bits = np.random.default_rng(m).integers(0, 2, (3, 40 * m))
    np.testing.assert_array_equal(
        tq.bits_to_index_msb(torch.as_tensor(bits), m).numpy(),
        np.asarray(jq.bits_to_index_msb(jnp.asarray(bits), m)))
    np.testing.assert_array_equal(
        tq.bits_to_symbols_gray(torch.as_tensor(bits), m).numpy(),
        np.asarray(jq.bits_to_symbols_gray(jnp.asarray(bits), m)))
    g = np.random.default_rng(10 + m)
    z = (g.standard_normal(500) + 1j * g.standard_normal(500)).astype(
        np.complex64)
    np.testing.assert_array_equal(
        tq.hard_demap_index_gray(torch.as_tensor(z), m).numpy(),
        np.asarray(jq.hard_demap_index_gray(jnp.asarray(z), m)))


@pytest.mark.parametrize("seed", [0, 5])
def test_grid_equal(seed):
    jr, tr = jgrid.ResourceGrid(), tgrid.ResourceGrid()
    for f in ("effective_subcarriers", "data_symbol_indices"):
        np.testing.assert_array_equal(getattr(tr, f), getattr(jr, f))
    for f in ("num_effective_subcarriers", "num_data_symbols",
              "num_resource_elements", "ofdm_symbol_duration"):
        assert getattr(tr, f) == getattr(jr, f), f
    assert tr.num_data_symbols == 768 and tr.num_effective_subcarriers == 64
    np.testing.assert_array_equal(tr.pilot_mask(), jr.pilot_mask())
    k = jax.random.PRNGKey(seed)
    pj = np.asarray(jr.pilot_grid(k))
    pt = tr.pilot_grid(_tk(k))
    np.testing.assert_array_equal(pt.numpy(), pj)
    xd = np.random.default_rng(seed).standard_normal((2, 4, 768)).astype(
        np.complex64)
    gj = np.asarray(jr.map_data(jnp.asarray(xd), jnp.asarray(pj)))
    gt = tr.map_data(torch.as_tensor(xd), pt)
    np.testing.assert_array_equal(gt.numpy(), gj)
    np.testing.assert_array_equal(tr.extract_data(gt).numpy(),
                                  np.asarray(jr.extract_data(jnp.asarray(gj))))
    np.testing.assert_array_equal(tgrid.subcarrier_frequencies(tr),
                                  jgrid.subcarrier_frequencies(jr))
    for e in (0.0, 7.0, 20.0):
        assert tgrid.ebnodb2no(e, 4, 0.5, tr) == float(
            jgrid.ebnodb2no(jnp.float32(e), 4, 0.5, jr))


@pytest.mark.parametrize("seed,batch", [(1, 2), (4, 3)])
def test_cdl_channel_close(seed, batch):
    rg = jgrid.ResourceGrid()
    k = jax.random.PRNGKey(seed)
    ja, jtau = jcdl.cdl_cir(jcdl.CdlConfig(), k, batch, 14,
                            1.0 / rg.ofdm_symbol_duration)
    ta, ttau = tcdl.cdl_cir(tcdl.CdlConfig(), _tk(k), batch, 14,
                            1.0 / rg.ofdm_symbol_duration)
    np.testing.assert_array_equal(ttau.numpy(), np.asarray(jtau))
    assert ta.dtype == torch.complex64 and ta.shape == ja.shape
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0,
                               atol=CHANNEL_ATOL)
    fr = jgrid.subcarrier_frequencies(rg)[rg.effective_subcarriers]
    ja = np.array(ja)
    hj = np.asarray(jcdl.cir_to_ofdm_channel(fr, jnp.asarray(ja), jtau))
    ht = tcdl.cir_to_ofdm_channel(fr, torch.as_tensor(ja), ttau)
    assert ht.shape == hj.shape == (batch, 14, 64, 8, 4)
    np.testing.assert_allclose(ht.numpy(), hj, rtol=0, atol=CHANNEL_ATOL)


def test_ls_nn_and_lmmse_close():
    rg_j, rg_t = jgrid.ResourceGrid(), tgrid.ResourceGrid()
    g = np.random.default_rng(3)
    B, T, F, U, S = 2, 14, 64, 8, 4

    def cn(*shape):
        return ((g.standard_normal(shape) + 1j * g.standard_normal(shape))
                / np.sqrt(2)).astype(np.complex64)

    y = cn(B, T, F, U)
    pil = np.asarray(rg_j.pilot_grid(jax.random.PRNGKey(2)))
    no = 0.05
    hj, evj = jrx.ls_nn_estimate(rg_j, jnp.asarray(y), jnp.asarray(pil), no)
    ht, evt = trx.ls_nn_estimate(rg_t, torch.as_tensor(y),
                                 torch.as_tensor(pil), no)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0,
                               atol=1e-6)
    assert evt == pytest.approx(float(evj), rel=1e-6)
    h = cn(B, T, F, U, S)
    xj, nj = jrx.lmmse_equalize_grid(jnp.asarray(h), jnp.asarray(y), evt, no)
    xt, nt = trx.lmmse_equalize_grid(torch.as_tensor(h), torch.as_tensor(y),
                                     evt, no)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=RX_ATOL)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=0,
                               atol=RX_ATOL)


@pytest.mark.parametrize("ebno", [0.0, 10.0, 20.0])
def test_equalized_dataset_sm1_equal(ebno):
    k = jax.random.fold_in(jax.random.PRNGKey(0), int(ebno))
    j = jpc.make_equalized_dataset_sm1(jnp.float32(ebno), k, batch=2)
    t = tpc.make_equalized_dataset_sm1(ebno, _tk(k), batch=2)
    assert t.x.shape == (2 * 4 * 768, 2) and t.x.dtype == torch.float32
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=0,
                               atol=FEATURE_ATOL)
