"""The Eb/N0 row (pipelines/common.py:EbnoRow), which lets a captured CDL
round read its link budget from device memory, on the CPU:

  * every value equals the float that `link_budget` and the block functions
    compute, bit for bit, over presets and Eb/N0s;
  * the ops that take a row's 0-d tensor where they took a Python float
    (the PA clip, LS + TD-MMSE estimation, the equaliser's load and power
    scale, the ESN input scaling and its detection's power scale) give the
    float's outputs bit for bit, so the CPU results do not move;
  * `synth_block` and `detect_data_symbols` given the row give the tensors
    they give for the float.
"""
import dataclasses

import numpy as np
import pytest
import torch

from esn_ofdm_mimo_tpu_torch.experiments.presets import (mimo_4x8_cdl,
                                                         mimo_4x8_nbf,
                                                         siso_qpsk_awgn)
from esn_ofdm_mimo_tpu_torch.ldpc import make_code
from esn_ofdm_mimo_tpu_torch.models.esn import (EsnScale, init_reservoir,
                                                scale_inputs)
from esn_ofdm_mimo_tpu_torch.models.esn_mimo import esn_detect_symbols
from esn_ofdm_mimo_tpu_torch.ops.chanest import estimate_channel
from esn_ofdm_mimo_tpu_torch.ops.equalize import (apply_equalizer,
                                                  equalizer_weights)
from esn_ofdm_mimo_tpu_torch.ops.pa import rapp_pa
from esn_ofdm_mimo_tpu_torch.pipelines import common
from esn_ofdm_mimo_tpu_torch.utils import rng

torch.set_num_threads(1)

PRESETS = {"cdl": mimo_4x8_cdl, "nbf": mimo_4x8_nbf, "siso": siso_qpsk_awgn}
EBNOS = (-3.0, 0.0, 7.5, 12.0, 21.0, 30.0)
f32 = np.float32


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_row_values_equal_the_floats(name):
    cfg = PRESETS[name](fast=True)
    No, N = f32(cfg.ofdm.noise_psd), cfg.ofdm.n_subcarriers
    rows = common.ebno_rows(cfg, EBNOS, "cpu")
    for i, e in enumerate(EBNOS):
        lb = common.link_budget(cfg, e)
        row = common.ebno_row(cfg, e, "cpu")
        assert torch.equal(torch.stack(tuple(row)), rows[i])
        want = (lb.var_x, lb.pi, lb.sqrt_pi, lb.a_clip,
                float(f32(cfg.esn.input_scaler) / np.sqrt(f32(lb.var_x))),
                float(No / f32(lb.pi) / f32(N / 2.0)),
                float(No / f32(lb.pi)))
        got = tuple(float(x) for x in row)
        assert got == want, (e, got, want)
        assert all(x.dtype == torch.float32 and x.ndim == 0 for x in row)


def _complex(g, *shape):
    return torch.complex(torch.randn(*shape, generator=g),
                         torch.randn(*shape, generator=g))


def test_ops_take_the_row_bit_for_bit():
    cfg = mimo_4x8_cdl(fast=True)
    row = common.ebno_row(cfg, 12.0, "cpu")
    lb = common.link_budget(cfg, 12.0)
    g = torch.Generator().manual_seed(7)
    x = _complex(g, 3, 4, 160)
    assert torch.equal(rapp_pa(x, row.a_clip), rapp_pa(x, lb.a_clip))
    Y, X = _complex(g, 3, 8, 128), _complex(g, 3, 4, 128)
    for a, b in zip(estimate_channel(Y, X, row.sqrt_pi, 4, 16,
                                     row.mmse_scaler),
                    estimate_channel(Y, X, lb.sqrt_pi, 4, 16,
                                     float(row.mmse_scaler))):
        assert torch.equal(a, b)
    H = _complex(g, 3, 128, 8, 4)
    W = equalizer_weights(H, row.no_over_pi)
    assert torch.equal(W, equalizer_weights(H, float(row.no_over_pi)))
    Yd = _complex(g, 3, 5, 8, 128)
    assert torch.equal(apply_equalizer(W, Yd, row.sqrt_pi),
                       apply_equalizer(W, Yd, lb.sqrt_pi))
    u = torch.randn(2, 30, 16, generator=g)
    s_t = EsnScale(row.input_scaling, 0.0, 1.0)
    s_f = EsnScale(float(row.input_scaling), 0.0, 1.0)
    assert torch.equal(scale_inputs(s_t, u), scale_inputs(s_f, u))
    res = init_reservoir(rng.prng_key(1), 16, 8, 20, noise=0.0)
    Wt = torch.randn(2, 36, 8, generator=g) * 0.1
    y = _complex(g, 2, 8, 40)
    assert torch.equal(
        esn_detect_symbols(res, s_t, Wt, y, 3, 8, 32, row.sqrt_pi),
        esn_detect_symbols(res, s_f, Wt, y, 3, 8, 32, lb.sqrt_pi))


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_blocks_given_the_row_equal_the_float(name):
    cfg = PRESETS[name](fast=True)
    cfg = dataclasses.replace(cfg, esn=dataclasses.replace(
        cfg.esn, n_reservoir=24))
    keys = rng.block_keys(rng.prng_key(2), 0, torch.arange(2))
    row = common.ebno_row(cfg, 9.0, "cpu")
    a, b = (common.synth_block(cfg, e, keys) for e in (9.0, row))
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
    assert torch.equal(torch.as_tensor(a.scale_m.input_scaling),
                       torch.as_tensor(b.scale_m.input_scaling))
    code = make_code(cfg.ldpc, cfg.ofdm.n_subcarriers
                     * cfg.ofdm.bits_per_symbol)
    bits, _ = common.data_bits_for_blocks(cfg, keys, 2, code)
    da, db = (common.detect_data_symbols(cfg, a, e, keys, bits)
              for e in (9.0, row))
    assert torch.equal(da.Y, db.Y)
    assert da.X_hat.keys() == db.X_hat.keys()
    for d in da.X_hat:
        assert torch.equal(da.X_hat[d], db.X_hat[d]), d


def test_a_row_refuses_another_input_scaler():
    cfg = mimo_4x8_cdl(fast=True)
    keys = rng.block_keys(rng.prng_key(2), 0, torch.arange(1))
    with pytest.raises(ValueError, match="input scaling"):
        common.synth_block(cfg, common.ebno_row(cfg, 9.0, "cpu"), keys,
                           esn_over={"input_scaler": 0.01})
