"""The BP kernels' sum-product check rule (plain version: ldpc/decode.py
`tanh_half`, `log_ratio`; kernel: csrc/bp_common.cuh) and plain flooding BP
against the TPU kernel.

The rule computes t = tanh(q / 2) and r = 2 atanh(p) in the TPU kernel's
form log((1 + p) / (1 - p)) (esn_ofdm_mimo_tpu/ldpc/decode_pallas.py:231),
with short odd polynomials where a difference cancels. Accuracy criterion,
the one chip_smoke.py's `[K1 rule]` holds the kernel to: against float64 on
a log-spaced grid of both signs (|q| in [1e-6, 16], |p| in [1e-6,
0.9999999]) each value within 1e-5 relative or 5e-7 absolute, whichever is
larger; 5e-7 is about 4 ulps of 1.0, the resolution of any 1 +- p in fp32.

Plain flooding BP (the public entry on CPU tensors) is held against the
Pallas flooding kernel run with interpret=True, for the three check rules at
n = 512, B = 24, 2.5 dB, on tests/test_ldpc_qc.py's kernel-vs-XLA band.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from esn_ofdm_mimo_tpu.ldpc import code as jcode
from esn_ofdm_mimo_tpu_torch.ldpc import (decode_cuda, ldpc_decode_bp,
                                          ldpc_encode, make_qc_ldpc)
from esn_ofdm_mimo_tpu_torch.ldpc.decode import log_ratio, tanh_half

# One intra-op thread per worker process (see tests/test_torch_curve.py).
torch.set_num_threads(1)

_GRID = {"t": (16.0, lambda x: np.tanh(0.5 * x)),
         "r": (0.9999999, lambda x: 2.0 * np.arctanh(x))}


def _grid(which: str):
    hi, ref = _GRID[which]
    g = np.logspace(-6.0, np.log10(hi), 20_001)
    x = np.concatenate([-g[::-1], g]).astype(np.float32)
    x = np.clip(x, -np.float32(hi), np.float32(hi))
    return x, ref(x.astype(np.float64))


@pytest.mark.parametrize("which", ["t", "r"])
def test_plain_rule_meets_the_accuracy_criterion(which):
    x, want = _grid(which)
    fn = tanh_half if which == "t" else log_ratio
    got = fn(torch.as_tensor(x)).numpy()
    assert got.dtype == np.float32
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= np.maximum(1e-5 * np.abs(want), 5e-7)).all(), \
        float(err.max())
    # both branches are exercised: the polynomial and the exp/log form
    small = np.abs(0.5 * x if which == "t" else x) < 0.125
    assert small.any() and (~small).any()
    if which == "t":     # odd by construction (the log form is odd only
        #                  up to its rounding)
        np.testing.assert_array_equal(fn(torch.as_tensor(-x)).numpy(), -got)


def test_rule_criterion_refuses_bf16_class_accuracy():
    """The criterion is tight enough to refuse tanh.approx.f32-class
    accuracy (relative error about 2^-11), which it is meant to."""
    x, want = _grid("t")
    approx = want * (1.0 + 2.0 ** -11)
    err = np.abs(approx - want)
    assert not (err <= np.maximum(1e-5 * np.abs(want), 5e-7)).all()


def test_sumprod_rule_wrapper_on_cpu_is_the_plain_version():
    x = torch.linspace(-0.99, 0.99, 101)
    before = decode_cuda.launches_rule
    assert torch.equal(decode_cuda.sumprod_rule(x, "t"), tanh_half(x))
    assert torch.equal(decode_cuda.sumprod_rule(x, "r"), log_ratio(x))
    assert decode_cuda.launches_rule == before
    with pytest.raises(ValueError):
        decode_cuda.sumprod_rule(x, "s")
    with pytest.raises(ValueError):
        decode_cuda.sumprod_rule(x.double(), "t")


@pytest.mark.parametrize("algo", ["sumprod", "minsum", "offset-minsum"])
def test_plain_flooding_vs_pallas_flooding_interpret(algo):
    """Against the TPU kernel's flooding branch in interpret mode, patched
    the way tests/test_torch_ldpc.py patches the layered one."""
    from unittest import mock

    from esn_ofdm_mimo_tpu.ldpc import decode_pallas

    code = make_qc_ldpc(512)
    r = np.random.default_rng(11)
    u = r.integers(0, 2, size=(24, code.k)).astype(np.int8)
    cw = np.asarray(ldpc_encode(code, torch.as_tensor(u))).astype(np.float64)
    sigma = np.sqrt(1.0 / (2 * code.k / code.n * 10 ** (2.5 / 10)))
    y = 1.0 - 2.0 * cw + sigma * r.standard_normal(cw.shape)
    llr = (2.0 * y / sigma ** 2).astype(np.float32)
    with jax.disable_jit():
        orig = decode_pallas.pl.pallas_call

        def interp_call(*a, **kw):
            kw["interpret"] = True
            return orig(*a, **kw)

        with mock.patch.object(decode_pallas.pl, "pallas_call", interp_call):
            want, wst = decode_pallas.ldpc_decode_bp_pallas(
                jcode.make_qc_ldpc(512), jnp.asarray(llr), 25, algo, 0.75,
                True)
    bits, st = ldpc_decode_bp(code, torch.as_tensor(llr), 25, algo,
                              return_stats=True)
    assert (bits.numpy() == np.asarray(want)).mean() > 0.999
    assert (st["iterations"].numpy()
            == np.asarray(wst["iterations"])).mean() > 0.9
    assert (st["converged"].numpy()
            == np.asarray(wst["converged"])).mean() > 0.95
    assert 0 < int(st["converged"].sum())
