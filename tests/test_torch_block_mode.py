"""EsnConfig(rng_mode="block") in the port: every block draws its own
reservoir and seeds its own ESN noise, and runs its ESN alone, so what a
block computes does not depend on the batch it runs in (the port's
counterpart of tests/test_montecarlo.py:231-255). On the CPU (device="cpu":
the kernels' plain versions), state noise 1e-3 where only the port runs:

  * the reservoir and both readouts of block 2 are bit-identical whether it
    runs in a batch of 4, 2 or 1;
  * the NBF and CDL counters (and the CDL calibrators) are bit-identical
    for one round of 8 blocks, rounds of 4 x 2 and rounds of 2 x 4.

Against the JAX package in block mode (state noise 0, one device, the tiny
configurations of test_torch_nbf.py and test_torch_curve.py):

  * each block's reservoir: W_in and W_fb bit-exact; Wt within 2 ulp, as
    its scale comes from a power iteration that rounds differently in the
    two libraries (test_torch_esn.py:test_init_reservoir_matches_jax_at_
    same_key);
  * the readouts within atol 1e-4 / rtol 1e-3, and within 1e-3 of JAX's in
    relative norm;
  * the NBF counters at test_torch_nbf.py's bands (classical uncoded and
    frame errors identical, ESN uncoded within 1% + 10, info bits within
    1% + 3) and the CDL curve at test_torch_curve.py's (BERs and BP
    telemetry equal, calibrators within 1e-4).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

import esn_ofdm_mimo_tpu  # noqa: F401
import __graft_entry__ as graft
from esn_ofdm_mimo_tpu import config as jc
from esn_ofdm_mimo_tpu.parallel import montecarlo as jmc
from esn_ofdm_mimo_tpu.pipelines import blockfading as jbf
from esn_ofdm_mimo_tpu.pipelines import common as jcom
from esn_ofdm_mimo_tpu.utils.rng import block_keys as j_block_keys
from esn_ofdm_mimo_tpu_torch import config as tc
from esn_ofdm_mimo_tpu_torch.models import esn_cuda, esn_states_cuda
from esn_ofdm_mimo_tpu_torch.parallel import (cdl_snr_point, nbf_snr_point,
                                              run_cdl_curve)
from esn_ofdm_mimo_tpu_torch.pipelines import common as tcom
from esn_ofdm_mimo_tpu_torch.pipelines.zoo2x2 import run_zoo_blocks
from esn_ofdm_mimo_tpu_torch.utils import rng

torch.set_num_threads(1)

DETECTORS = ("esn", "esn_fixed", "zf_perfect", "zf_ls", "mmse")


def _block(cfg, noise):
    return dataclasses.replace(cfg, esn=dataclasses.replace(
        cfg.esn, rng_mode="block", noise=noise))


def _nbf(mod, noise=0.0):
    """test_torch_nbf.py's tiny 2x2 block-fading config in block mode."""
    return _block(mod.SimConfig(
        name="tiny",
        ofdm=mod.OfdmConfig(n_subcarriers=32, bits_per_symbol=4,
                            doppler_hz=3000.0),
        channel=mod.ChannelConfig(kind="exp_pdp", n_tx=2, n_rx=2),
        esn=mod.EsnConfig(n_reservoir=40),
        ldpc=mod.LdpcConfig(max_iter=20, decode_every=2, family="qc",
                            algo="offset-minsum"),
        ebno_db=(3.0, 12.0)), noise)


def _jax_cdl(noise=0.0):
    """test_torch_curve.py's tiny calibrated config in block mode."""
    cfg = graft._flagship_cfg(tiny=True)
    return _block(dataclasses.replace(
        cfg, calib=dataclasses.replace(cfg.calib, enabled=True),
        ldpc=dataclasses.replace(cfg.ldpc, family="qc",
                                 algo="offset-minsum"),
        ebno_db=(12.0, 24.0)), noise)


def _port_cfg(cfg):
    sub = {f.name: getattr(tc, type(getattr(cfg, f.name)).__name__)(
        **dataclasses.asdict(getattr(cfg, f.name)))
        for f in dataclasses.fields(cfg)
        if dataclasses.is_dataclass(getattr(cfg, f.name))}
    return dataclasses.replace(tc.SimConfig(), **{
        f.name: sub.get(f.name, getattr(cfg, f.name))
        for f in dataclasses.fields(cfg)})


def _keys(n, snr_idx=1):
    return rng.block_keys(rng.prng_key(0), snr_idx, torch.arange(n))


def test_block_reservoir_and_readouts_do_not_depend_on_the_batch():
    cfg = _nbf(tc, noise=1e-3)
    k = _keys(4)
    before = (esn_states_cuda.launches, esn_cuda.launches)
    states = [tcom.synth_block(cfg, 12.0, kk) for kk in (k, k[2:], k[2:3])]
    assert (esn_states_cuda.launches, esn_cuda.launches) == before
    for st, b, n in zip(states, (2, 0, 0), (4, 2, 1)):
        assert st.reservoir.Wt.shape == (n, 40, 40)
        for name in ("Wt", "W_in_t", "W_fb_t"):
            assert torch.equal(getattr(st.reservoir, name)[b],
                               getattr(states[0].reservoir, name)[2]), name
        for name in ("Wt_out_m", "Wt_out_f"):
            assert torch.equal(getattr(st, name)[b],
                               getattr(states[0], name)[2]), name
    # blocks draw different reservoirs, and batch mode shares one
    assert not torch.equal(states[0].reservoir.Wt[0],
                           states[0].reservoir.Wt[1])
    batch = tcom.synth_block(dataclasses.replace(cfg, esn=dataclasses.replace(
        cfg.esn, rng_mode="batch")), 12.0, k)
    assert batch.reservoir.Wt.shape == (40, 40)
    assert torch.equal(batch.reservoir.Wt, states[0].reservoir.Wt[0])
    with pytest.raises(ValueError, match="rng_mode"):
        tcom.synth_block(dataclasses.replace(cfg, esn=dataclasses.replace(
            cfg.esn, rng_mode="blocks")), 12.0, k)


def test_block_detection_does_not_depend_on_the_batch():
    cfg = _nbf(tc, noise=1e-3)
    k = _keys(4)
    code_bits, _ = tcom.data_bits_for_blocks(cfg, k, 3)
    out = {}
    for lo, hi in ((0, 4), (2, 4), (2, 3)):
        st = tcom.synth_block(cfg, 12.0, k[lo:hi])
        out[lo, hi] = tcom.detect_data_symbols(
            cfg, st, 12.0, k[lo:hi], code_bits[lo:hi]).X_hat
    for d in ("esn", "esn_fixed"):
        assert out[0, 4][d].shape == (4, 3, 32, 2)
        assert torch.equal(out[2, 4][d][0], out[0, 4][d][2]), d
        assert torch.equal(out[2, 3][d][0], out[0, 4][d][2]), d


@pytest.mark.parametrize("rounds", [2, 4], ids=["4x2", "2x4"])
def test_nbf_counters_do_not_depend_on_the_rounds(rounds):
    cfg = _nbf(tc, noise=1e-3)
    k = _keys(8).numpy()
    one = nbf_snr_point(cfg, 12.0, k.reshape(1, 8, 2), device="cpu")
    got = nbf_snr_point(cfg, 12.0, k.reshape(rounds, 8 // rounds, 2),
                        device="cpu")
    for field, a, b in zip(one._fields, one, got):
        if field == "cond_hist":
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, (field, a, b)
    assert one.n_blocks == 8 and 0 < one.bit_errors["esn"]


@pytest.mark.parametrize("rounds", [2, 4], ids=["4x2", "2x4"])
def test_cdl_counters_do_not_depend_on_the_rounds(rounds):
    cfg = _port_cfg(_jax_cdl(noise=1e-3))
    cal, dec = (_keys(16)[:8].numpy(), _keys(16)[8:].numpy())
    one = cdl_snr_point(cfg, 12.0, cal.reshape(1, 8, 2),
                        dec.reshape(1, 8, 2), device="cpu")
    got = cdl_snr_point(cfg, 12.0, cal.reshape(rounds, 8 // rounds, 2),
                        dec.reshape(rounds, 8 // rounds, 2), device="cpu")
    assert got.cal_bit_errors == one.cal_bit_errors
    assert got.cal_total_bits == one.cal_total_bits
    assert got.counts == one.counts
    for d, (a, b) in one.calib.items():
        assert torch.equal(got.calib[d][0], a) and \
            torch.equal(got.calib[d][1], b), d


def test_block_mode_matches_jax_nbf():
    keys = j_block_keys(jax.random.PRNGKey(0), 1,
                        jnp.arange(4, dtype=jnp.uint32))
    jcfg, cfg = _nbf(jc), _nbf(tc)
    st_j = jax.jit(lambda k: jcom.synth_block(jcfg, jnp.float32(12.0), k))(
        keys)
    st_t = tcom.synth_block(cfg, 12.0, rng.as_keys(np.asarray(keys)))
    for name in ("W_in_t", "W_fb_t"):
        np.testing.assert_array_equal(
            getattr(st_t.reservoir, name).numpy(),
            np.asarray(getattr(st_j.reservoir, name)))
    np.testing.assert_array_max_ulp(st_t.reservoir.Wt.numpy(),
                                    np.asarray(st_j.reservoir.Wt), maxulp=2)
    for name in ("Wt_out_m", "Wt_out_f"):
        got, want = getattr(st_t, name).numpy(), np.asarray(getattr(st_j,
                                                                    name))
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)
        for b in range(4):
            rel = np.linalg.norm(got[b] - want[b]) / np.linalg.norm(want[b])
            assert rel < 1e-3, (name, b, rel)
    want = jax.jit(lambda e, k: jbf.run_nbf_blocks(jcfg, e, k))(
        jnp.float32(12.0), keys)
    got = nbf_snr_point(cfg, 12.0, np.asarray(keys)[None], device="cpu")
    for d in DETECTORS:
        w = int(want.bit_errors[d])
        band = 0.01 * w + 10 if d.startswith("esn") else 0
        assert abs(got.bit_errors[d] - w) <= band, (d, got.bit_errors[d], w)
        assert got.frame_errors[d] == int(want.frame_errors[d]), d
        w = int(want.info_errors[d])
        assert abs(got.info_errors[d] - w) <= 0.01 * w + 3, d
    assert got.total_bits == int(want.total_bits)


def test_block_mode_matches_jax_cdl_curve():
    mesh = Mesh(np.array(jax.devices()[:1]), ("trials",))
    want = jmc.run_cdl_curve(_jax_cdl(), 12, blocks_per_device=4, mesh=mesh,
                             progress=None)
    got = run_cdl_curve(_port_cfg(_jax_cdl()), 12, blocks_per_round=4,
                        device="cpu", progress=None)
    for a, b in zip(got, want):
        for k in ("ber_uncoded", "ber_coded", "ldpc_avg_iters",
                  "ldpc_unconverged_frac"):
            assert a[k] == b[k], (k, a[k], b[k])
        for d in b["calib"]:
            np.testing.assert_allclose(np.asarray(a["calib"][d]),
                                       np.asarray(b["calib"][d]), rtol=0,
                                       atol=1e-4)


def test_zoo_comparison_refuses_block_mode():
    with pytest.raises(ValueError, match="rng_mode"):
        run_zoo_blocks(_nbf(tc), 12.0, _keys(2), epochs=1, device="cpu")
