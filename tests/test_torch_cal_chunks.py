"""The port's detection-throughput path, `run_cdl_cal_counters_chunks`,
and what a CUDA graph capture of it needs, on the CPU (the kernels' plain
versions; the graph itself runs on the card, in chip_smoke.py's `[cal
chunks]`):

  * at ESN state noise 0 it matches the JAX function under `jax.jit` on
    the tiny CDL configuration of tests/test_montecarlo.py (cdl_b, 1x2, 2
    chunks x 2 blocks, 9 dB), built as tests/test_torch_slice.py builds
    its noise-0 configuration: total bits and MMSE errors identical, ESN
    errors within test_torch_slice.py's band (1% + 10; the readout solve
    rounds differently in the two libraries);
  * at the default noise and in rng_mode="block" they equal the port's own
    `run_cdl_cal_blocks` summed over the chunks, and no LLR is computed;
  * `key_seed_tensor` (the seed the CUDA kernels read from device memory)
    has `key_seed`'s bits for every corner of the two key words;
  * `equalizer_weights`, without the solve's host-side error check,
    gives `torch.linalg.solve`'s outputs bit for bit;
  * the host tables a captured round reads are device constants made once:
    an LdpcCode (NumPy arrays, no hash) keys its encoder matrix by
    identity, and an element of `key_seed_tensor` seeds the plain
    versions' generator as `key_seed`'s int does.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import esn_ofdm_mimo_tpu  # noqa: F401
from esn_ofdm_mimo_tpu import config as jc
from esn_ofdm_mimo_tpu.pipelines.cdl import \
    run_cdl_cal_counters_chunks as jax_chunks
from esn_ofdm_mimo_tpu.utils.rng import block_keys
from esn_ofdm_mimo_tpu_torch import config as tc
from esn_ofdm_mimo_tpu_torch.ldpc import encode as enc
from esn_ofdm_mimo_tpu_torch.ldpc.code import make_qc_ldpc
from esn_ofdm_mimo_tpu_torch.models.esn_cuda import host_generator
from esn_ofdm_mimo_tpu_torch.models.esn import key_seed, key_seed_tensor
from esn_ofdm_mimo_tpu_torch.ops.equalize import equalizer_weights
from esn_ofdm_mimo_tpu_torch.utils.device import device_constant
from esn_ofdm_mimo_tpu_torch.pipelines import cdl

torch.set_num_threads(1)

R, B, EBNO = 2, 2, 9.0


def _jax_cfg(noise=None):
    """tests/test_montecarlo.py:tiny_cfg on cdl_b, 1x2."""
    esn = jc.EsnConfig(n_reservoir=40)
    if noise is not None:
        esn = dataclasses.replace(esn, noise=noise)
    return jc.SimConfig(
        name="tiny",
        ofdm=jc.OfdmConfig(n_subcarriers=32, bits_per_symbol=4,
                           doppler_hz=3000.0),
        channel=jc.ChannelConfig(kind="cdl_b", n_tx=1, n_rx=2),
        esn=esn, ldpc=jc.LdpcConfig(max_iter=20, decode_every=2),
        ebno_db=(6.0, 18.0))


def _port_cfg(cfg):
    sub = {f.name: getattr(tc, type(getattr(cfg, f.name)).__name__)(
        **dataclasses.asdict(getattr(cfg, f.name)))
        for f in dataclasses.fields(cfg)
        if dataclasses.is_dataclass(getattr(cfg, f.name))}
    return dataclasses.replace(tc.SimConfig(), **{
        f.name: sub.get(f.name, getattr(cfg, f.name))
        for f in dataclasses.fields(cfg)})


def _keys():
    """(R, B, 2) uint32 block keys of test_montecarlo.py's chunk test."""
    return np.asarray(block_keys(jax.random.PRNGKey(4), 0,
                                 jnp.arange(R * B, dtype=jnp.uint32))
                      ).reshape(R, B, 2)


def test_chunks_match_jax_noise0():
    cfg = _jax_cfg(noise=0.0)
    keys = _keys()
    errs, tot = jax.jit(lambda e, k: jax_chunks(cfg, e, k))(
        jnp.float32(EBNO), jnp.asarray(keys))
    got, got_tot = cdl.run_cdl_cal_counters_chunks(
        _port_cfg(cfg), EBNO, torch.as_tensor(keys.astype(np.int64)))
    assert got_tot == int(tot)
    assert int(got["mmse"]) == int(errs["mmse"])
    # the dual readout solve rounds differently in the two libraries
    # (test_torch_slice.py's band): 1,352 against 1,350 here
    want = int(errs["esn"])
    assert abs(int(got["esn"]) - want) <= 0.01 * want + 10


@pytest.mark.parametrize("rng_mode", ["batch", "block"])
def test_chunks_equal_summed_blocks(rng_mode, monkeypatch):
    cfg = _port_cfg(_jax_cfg())
    cfg = dataclasses.replace(cfg, esn=dataclasses.replace(
        cfg.esn, rng_mode=rng_mode))
    keys = torch.as_tensor(_keys().astype(np.int64))
    outs = [cdl.run_cdl_cal_blocks(cfg, EBNO, keys[r]) for r in range(R)]

    def no_llrs(*a, **k):
        raise AssertionError("the chunk path computed LLRs")

    monkeypatch.setattr(cdl, "_llrs_for", no_llrs)
    got, tot = cdl.run_cdl_cal_counters_chunks(cfg, EBNO, keys)
    assert tot == sum(o.total_bits for o in outs)
    assert set(got) == set(cdl.CDL_DETECTORS)
    for name, v in got.items():
        assert v.dtype == torch.int64
        assert int(v) == sum(int(o.bit_errors[name]) for o in outs), name
    assert all(0 < int(v) < tot for v in got.values())


_WORDS = (0, 2**31 - 1, 2**31, 2**32 - 1)


@pytest.mark.parametrize("k0,k1", list(itertools.product(_WORDS, _WORDS)))
def test_key_seed_tensor_bits(k0, k1):
    key = torch.tensor([k0, k1], dtype=torch.int64)
    got = key_seed_tensor(key)
    assert got.dtype == torch.int64 and got.shape == ()
    assert int(got) & (2**64 - 1) == key_seed(key)
    batch = key_seed_tensor(torch.stack([key, key.flip(0)]))
    assert [int(x) & (2**64 - 1) for x in batch] == [
        key_seed(key), key_seed(key.flip(0))]


@pytest.mark.parametrize("n_rx", [4, 8])
def test_equalizer_weights_equal_solve(n_rx):
    g = torch.Generator().manual_seed(5)
    H = torch.complex(torch.randn(64, n_rx, 4, generator=g),
                      torch.randn(64, n_rx, 4, generator=g))
    reg = 0.05
    A = H.mH @ H + reg * torch.eye(4, dtype=H.dtype)
    assert torch.equal(equalizer_weights(H, reg),
                       torch.linalg.solve(A, H.mH))


def test_encoder_matrix_is_a_constant_keyed_by_code_identity():
    code = make_qc_ldpc(64, 4, 8, 0)
    P = device_constant(enc._encoder_f32, code)
    assert P is device_constant(enc._encoder_f32, code)
    assert P.dtype == torch.float32 and np.array_equal(P.numpy(), code.P)
    # an equal code that is another object, with one encoder bit flipped:
    # its own matrix, and the codewords follow it
    P2 = code.P.copy()
    P2[0, 0] ^= 1
    twin = code._replace(P=P2)
    assert device_constant(enc._encoder_f32, twin) is not P
    u = torch.randint(0, 2, (5, code.k), generator=torch.Generator()
                      .manual_seed(3), dtype=torch.int8)
    for c, Pc in ((code, code.P), (twin, P2)):
        want = (u.numpy().astype(np.int64) @ Pc.T.astype(np.int64)) % 2
        got = enc.ldpc_encode(c, u)
        assert np.array_equal(got[:, :code.m].numpy(), want)
        assert torch.equal(got[:, code.m:], u)


@pytest.mark.parametrize("k0,k1", [(0, 1), (2**31, 7), (2**32 - 1, 2**32 - 1)])
def test_seed_tensor_element_seeds_the_plain_generator(k0, k1):
    keys = torch.tensor([[k0, k1], [k1, k0]], dtype=torch.int64)
    seeds = key_seed_tensor(keys)
    for b in range(2):
        a = torch.rand(8, generator=host_generator(seeds[b]))
        want = torch.rand(8, generator=host_generator(key_seed(keys[b])))
        assert torch.equal(a, want)
        assert host_generator(seeds[b]).initial_seed() == key_seed(keys[b])
