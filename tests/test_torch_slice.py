"""The whole slice: one calibrated CDL SNR point of the port
(`cdl_snr_point`, device="cpu", so the kernels' plain versions run) against
the JAX package's fused SNR step (`make_fused_cdl_snr_step` on a one-device
mesh) at identical block keys.

Configuration: `__graft_entry__._flagship_cfg(tiny=True)` (N = 32, 2x4,
n_res = 40, D = 7, max_iter 8) with calibration on, and the flagship's QC
code and offset min-sum rule (the port decodes the QC family only).

With ESN state noise 0 both sides compute the same thing; the measured
result is identical counters. The stated bands: MMSE counters within 3 bit
flips (normals agree to a few ulp, test_torch_rng.py), calibrators within
1e-3, ESN counters within 1% + 10 (the dual readout solve rounds
differently). With the default noise the two noise streams differ (the JAX
package draws it from `rbg`), so ESN counters are compared statistically.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

import esn_ofdm_mimo_tpu  # noqa: F401
import __graft_entry__ as graft
from esn_ofdm_mimo_tpu.parallel.montecarlo import make_fused_cdl_snr_step
from esn_ofdm_mimo_tpu.utils.rng import block_keys
from esn_ofdm_mimo_tpu_torch import config as tc
from esn_ofdm_mimo_tpu_torch.parallel import cdl_snr_point

G = 4
_STEPS = {}


def _jax_cfg(noise):
    cfg = graft._flagship_cfg(tiny=True)
    return dataclasses.replace(
        cfg, calib=dataclasses.replace(cfg.calib, enabled=True),
        ldpc=dataclasses.replace(cfg.ldpc, family="qc",
                                 algo="offset-minsum"),
        esn=dataclasses.replace(cfg.esn, noise=noise))


def _port_cfg(cfg):
    sub = {f.name: getattr(tc, type(getattr(cfg, f.name)).__name__)(
        **dataclasses.asdict(getattr(cfg, f.name)))
        for f in dataclasses.fields(cfg)
        if dataclasses.is_dataclass(getattr(cfg, f.name))}
    return dataclasses.replace(tc.SimConfig(), **{
        f.name: sub.get(f.name, getattr(cfg, f.name))
        for f in dataclasses.fields(cfg)})


def _run(noise, ebno, snr_idx):
    cfg = _jax_cfg(noise)
    if noise not in _STEPS:
        mesh = Mesh(np.array(jax.devices()[:1]), ("trials",))
        _STEPS[noise] = make_fused_cdl_snr_step(cfg, mesh)
    ids = jnp.arange(2 * G, dtype=jnp.uint32)
    keys = np.asarray(block_keys(jax.random.PRNGKey(0), snr_idx, ids))
    ck, dk = keys[:G].reshape(1, G, 2), keys[G:].reshape(1, G, 2)
    errs, tot, dec, calib = jax.device_get(
        _STEPS[noise](jnp.float32(ebno), jnp.asarray(ck), jnp.asarray(dk)))
    pt = cdl_snr_point(_port_cfg(cfg), ebno, ck, dk, device="cpu")
    return (errs, tot, dec, calib), pt


def test_port_config_equals_jax_config():
    cfg = _jax_cfg(0.0)
    assert dataclasses.asdict(_port_cfg(cfg)) == dataclasses.asdict(cfg)


@pytest.mark.parametrize("ebno,snr_idx", [(12.0, 1), (24.0, 2)])
def test_snr_point_matches_jax_noise0(ebno, snr_idx):
    (errs, tot, dec, calib), pt = _run(0.0, ebno, snr_idx)
    c = pt.counts
    assert pt.cal_total_bits == int(tot)
    assert c.total_bits == int(dec.total_bits)
    assert c.total_info_bits == int(dec.total_info_bits)
    assert c.ldpc_codewords == int(dec.ldpc_codewords)
    for d in ("mmse", "esn"):
        band = (lambda v: 3) if d == "mmse" else (lambda v: 0.01 * v + 10)
        pairs = [(pt.cal_bit_errors[d], errs[d]),
                 (c.bit_errors[d], dec.bit_errors[d]),
                 (c.info_errors[d], dec.info_errors[d]),
                 (c.frame_errors[d], dec.frame_errors[d]),
                 (c.ldpc_iter_sum[d], dec.ldpc_iter_sum[d]),
                 (c.ldpc_unconverged[d], dec.ldpc_unconverged[d])]
        for got, want in pairs:
            assert abs(got - int(want)) <= band(int(want)), (d, pairs)
        a, b = pt.calib[d]
        np.testing.assert_allclose(a.numpy(), np.asarray(calib[d][0]),
                                   atol=1e-3)
        np.testing.assert_allclose(b.numpy(), np.asarray(calib[d][1]),
                                   atol=1e-3)
    assert 0 < c.bit_errors["mmse"] < c.total_bits // 2


def test_snr_point_default_noise_statistics():
    (errs, tot, dec, calib), pt = _run(1e-3, 12.0, 1)
    c = pt.counts
    # MMSE never sees the ESN noise: still within the ulp band
    assert abs(c.bit_errors["mmse"] - int(dec.bit_errors["mmse"])) <= 3
    # ESN: two noise streams of the same distribution; the uncoded error
    # counts agree to within their sampling spread
    for got, want in ((pt.cal_bit_errors["esn"], int(errs["esn"])),
                      (c.bit_errors["esn"], int(dec.bit_errors["esn"]))):
        assert abs(got - want) <= 0.05 * want + 4 * np.sqrt(want) + 10
    assert 0 < c.bit_errors["esn"] < c.total_bits
