"""The Newton calibrator fit of the port against the JAX package, on the CPU.

fit_logreg_1d_newton takes damped Newton steps on the penalised logistic
NLL; each step keeps the best of four candidates by a float32 NLL, or stays
put. Over the first three steps (from a = 1, b = 0, far from the optimum)
the port's slopes and offsets lie within 1e-5 of the JAX fit's on random
LLRs and bits. Near the optimum the candidates' NLLs tie at float32
resolution, and which one wins depends on the order the samples are
summed in: the JAX fit itself moves by up to 1.5e-3 when the same samples
are merely reordered (measured over 48 such draws; more than 1e-5 in 62%
of them). So at the full 8 steps the test holds the port to that band,
2e-3, and to the same penalised NLL (float64, within 1e-6 relative).
fit_calibrators(fit_method="newton") is held the same way, with the stride
subsample above max_fit_samples; the GD path is unchanged beside it.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from esn_ofdm_mimo_tpu import config as jc
from esn_ofdm_mimo_tpu.pipelines import cdl as jcdl
from esn_ofdm_mimo_tpu_torch import config as tc
from esn_ofdm_mimo_tpu_torch.pipelines import cdl as tcdl

torch.set_num_threads(1)

L2 = 1e-3
BAND = 2e-3


def _llrs_bits(seed, shape, scale):
    """Bits and LLRs that follow them with noise (negative LLR <=> 1)."""
    r = np.random.default_rng(seed)
    bits = r.integers(0, 2, shape).astype(np.int8)
    llr = (scale * (1.0 - 2.0 * bits)
           + 0.8 * scale * r.standard_normal(shape)).astype(np.float32)
    return llr, bits


def _pnll64(a, b, x, y):
    """The fit's penalised NLL per row, in float64."""
    z = (np.asarray(a, np.float64)[:, None] * x.astype(np.float64)
         + np.asarray(b, np.float64)[:, None])
    ce = np.maximum(z, 0.0) - y * z + np.log1p(np.exp(-np.abs(z)))
    return ce.mean(-1) + 0.5 * L2 * np.asarray(a, np.float64) ** 2


def _same_fit(got, want, x, y):
    ga, gb = (t.numpy() for t in got)
    wa, wb = (np.asarray(t) for t in want)
    np.testing.assert_allclose(ga, wa, rtol=0, atol=BAND)
    np.testing.assert_allclose(gb, wb, rtol=0, atol=BAND)
    f_got, f_want = _pnll64(ga, gb, x, y), _pnll64(wa, wb, x, y)
    assert np.all(f_got <= f_want * (1 + 1e-6)), (f_got, f_want)


CASES = [(0, 1.0), (1, 6.0), (2, 40.0)]
IDS = ["narrow", "wide", "saturated"]


@pytest.mark.parametrize("seed,scale", CASES, ids=IDS)
def test_newton_steps_match_jax_to_1e5(seed, scale):
    x, y = _llrs_bits(seed, (4, 3000), scale)
    for steps in (1, 2, 3):
        wa, wb = jcdl.fit_logreg_1d_newton(jnp.asarray(x), jnp.asarray(y),
                                           steps=steps)
        ga, gb = tcdl.fit_logreg_1d_newton(torch.as_tensor(x),
                                           torch.as_tensor(y), steps=steps)
        assert ga.dtype == gb.dtype == torch.float32 and ga.shape == (4,)
        np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("seed,scale", CASES, ids=IDS)
def test_newton_fit_matches_jax(seed, scale):
    x, y = _llrs_bits(seed, (4, 3000), scale)
    want = jcdl.fit_logreg_1d_newton(jnp.asarray(x), jnp.asarray(y))
    got = tcdl.fit_logreg_1d_newton(torch.as_tensor(x), torch.as_tensor(y))
    _same_fit(got, want, x, y)
    # the fit calibrates: negative slopes (an LLR > 0 means bit 0), and it
    # improves on its start a = 1, b = 0
    assert np.all(got[0].numpy() < 0)
    assert np.all(_pnll64(got[0].numpy(), got[1].numpy(), x, y)
                  < _pnll64(np.ones(4), np.zeros(4), x, y))


@pytest.mark.parametrize("cap", [None, 1000])
def test_fit_calibrators_newton_matches_jax(cap):
    x_e, bits = _llrs_bits(5, (2400, 4), 3.0)
    x_m = (1.7 * x_e + 0.3).astype(np.float32)
    calib = dict(fit_method="newton", max_fit_samples=cap)
    jcfg = dataclasses.replace(jc.SimConfig(),
                               calib=jc.CalibConfig(enabled=True, **calib))
    tcfg = dataclasses.replace(tc.SimConfig(),
                               calib=tc.CalibConfig(enabled=True, **calib))
    want = jcdl.fit_calibrators(jcfg, {"esn": jnp.asarray(x_e),
                                       "mmse": jnp.asarray(x_m)},
                                jnp.asarray(bits))
    got = tcdl.fit_calibrators(tcfg, {"esn": torch.as_tensor(x_e),
                                      "mmse": torch.as_tensor(x_m)},
                               torch.as_tensor(bits))
    stride = 1 if cap is None else -(-x_e.shape[0] // cap)
    for d, x in (("esn", x_e), ("mmse", x_m)):
        _same_fit(got[d], want[d], x.T[:, ::stride], bits.T[:, ::stride])
    # GD and Newton minimise the same penalised NLL: close, not equal
    gd = tcdl.fit_calibrators(
        dataclasses.replace(tcfg, calib=dataclasses.replace(
            tcfg.calib, fit_method="gd")),
        {"esn": torch.as_tensor(x_e)}, torch.as_tensor(bits))
    assert not torch.equal(gd["esn"][0], got["esn"][0])
    np.testing.assert_allclose(gd["esn"][0].numpy(), got["esn"][0].numpy(),
                               rtol=0.2)
