"""K2's TF32 build on the CPU: its rounding rule, its plain version and the
choice of route.

  * `round_tf32` bit for bit against a rule derived independently from the
    two TF32 neighbours of each value (ties away from zero): crafted ties,
    signs, zeros, subnormals, infinities, NaN and the overflow past the
    largest TF32, and 2^16 random bit patterns;
  * the plain TF32 form (`esn_predict(..., tf32=True)`) against the plain
    fp32 form: one step from a carried state within the bound that the two
    2^-11 roundings of s and Wt give (tanh is 1-Lipschitz), equal where s
    and Wt are already TF32 values, and a whole run within a band of 2^-11
    of the outputs' scale;
  * the route, a pure function of the precision and the device: TF32 for
    None (and "default") on CUDA, fp32 for "high", "highest", the CPU and
    a caller that passes no precision; an unknown value raises (the
    widths the TF32 build has are the library's own answer, held on the
    card);
  * on the CPU the None route is the fp32 plain version bit for bit and
    moves no launch counter (`launches`, `launches_tf32`);
  * the pipelines pass EsnConfig.recurrence_precision to the wrapper: the
    batch and block detectors and the 2x2 comparison's NMSE.

On the card chip_smoke.py holds the TF32 build against the plain TF32
form at every K2 shape it runs.
"""
import inspect
import struct

import numpy as np
import pytest
import torch

from esn_ofdm_mimo_tpu_torch import config as tc
from esn_ofdm_mimo_tpu_torch.models import esn_cuda, esn_mimo
from esn_ofdm_mimo_tpu_torch.models.esn import (EsnScale, esn_predict,
                                                init_reservoir, round_tf32)
from esn_ofdm_mimo_tpu_torch.parallel import nbf_snr_point
from esn_ofdm_mimo_tpu_torch.pipelines import zoo2x2
from esn_ofdm_mimo_tpu_torch.utils import rng

torch.set_num_threads(1)

CUDA, CPU = torch.device("cuda"), torch.device("cpu")


def _tf32_reference(bits: int) -> int:
    """The TF32 rounding of one fp32 bit pattern, from its two TF32
    neighbours in magnitude: the nearer, the larger magnitude on a tie; a
    magnitude past the largest TF32 that rounds up is an infinity; NaN
    returns NaN (None)."""
    sign, mag = bits & 0x80000000, bits & 0x7FFFFFFF
    if mag > 0x7F800000:
        return None
    if mag == 0x7F800000:
        return bits
    lo = mag & 0xFFFFE000
    hi = lo + 0x2000                  # at most 0x7F800000, the infinity
    f = lambda m: struct.unpack("<f", struct.pack("<I", m))[0]  # noqa: E731
    # fp32 values and their distances are exact in float64; past the
    # largest TF32 the next step up is 2^128
    x, lo_v = f(mag), f(lo)
    hi_v = 2.0 ** 128 if hi == 0x7F800000 else f(hi)
    return sign | (hi if hi_v - x <= x - lo_v else lo)


def _bits(x: torch.Tensor) -> list:
    return x.contiguous().view(torch.int32).numpy().astype(np.uint32).tolist()


def _check_rule(patterns):
    x = torch.tensor(np.array(patterns, dtype=np.uint32).view(np.float32))
    got = round_tf32(x)
    for p, g, gv in zip(patterns, _bits(got), got.tolist()):
        want = _tf32_reference(p)
        if want is None:
            assert gv != gv, hex(p)
        else:
            assert g == want, (hex(p), hex(g), hex(want))


def test_round_tf32_crafted_cases():
    one = 0x3F800000
    patterns = [
        one, one + 0x0FFF, one + 0x1000, one + 0x1001, one + 0x2000,
        one + 0x3000,                                  # a tie that rounds up
        0x3F801000 | 0x80000000,                       # a negative tie
        0x00000000, 0x80000000,                        # zeros keep their sign
        0x00000001, 0x00001000, 0x00001FFF, 0x807FF000,   # subnormals
        0x007FF000,                                    # up to the least normal
        0x7F7FE000, 0x7F7FEFFF, 0x7F7FF000, 0x7F7FFFFF,   # the largest TF32
        0xFF7FF000,                                    # to -inf
        0x7F800000, 0xFF800000,                        # infinities
        0x7FC00000, 0x7F800001, 0xFFFFFFFF, 0x7FFFF000,   # NaNs
    ]
    _check_rule(patterns)
    t = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 3 * 2.0 ** -11])
    assert round_tf32(t).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                                      1.0 + 2.0 ** -9]


def test_round_tf32_random_bit_patterns():
    r = np.random.default_rng(5)
    _check_rule(r.integers(0, 2**32, size=2**16, dtype=np.uint64).tolist())


def _case(n_res=40, n_in=4, n_out=4, B=6, G=3, T=30, seed=1):
    res = init_reservoir(rng.prng_key(seed), n_in, n_out, n_res, 0.9, 0.1,
                         0.0)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, T, n_in, generator=g)
    W = 0.05 * torch.randn(G, n_res + n_in, n_out, generator=g)
    return res, EsnScale(0.5, 0.0, 1.0), W, x


def test_plain_tf32_one_step_within_the_rounding_bound():
    """One step from a carried state: |o_tf32 - o_fp32| <= |Wout_s|^T
    (eps (|s0| @ |Wt|) + the fp32 sums' own error), eps = 2 2^-11 + 2^-22
    (both operands rounded to TF32, the product exact in fp32)."""
    res, scale, W, x = _case(B=6, G=6, T=1)
    n_res = res.Wt.shape[0]
    g = torch.Generator().manual_seed(9)
    s0 = torch.rand(6, n_res, generator=g) * 2 - 1
    o0 = torch.randn(6, 4, generator=g)
    out = {tf: esn_predict(res, scale, W, x, 0, init_carry=(s0, o0),
                           tf32=tf)[:, 0] for tf in (False, True)}
    mag = s0.abs() @ res.Wt.abs()                               # (B, n_res)
    eps = 2 * 2.0 ** -11 + 2.0 ** -22 + 4 * n_res * 2.0 ** -24
    bound = (eps * mag[:, :, None] * W[:, :n_res].abs()).sum(1)  # (B, n_out)
    diff = (out[True] - out[False]).abs()
    assert bool((diff <= bound + 1e-7).all()), float((diff - bound).max())
    assert float(diff.max()) > 0.0          # the TF32 form does round


def test_plain_tf32_equals_fp32_on_tf32_operands():
    """Where s0 and Wt hold TF32 values the rounding is the identity, so a
    step's outputs are the fp32 form's bit for bit."""
    res, scale, W, x = _case(B=4, G=4, T=1)
    res = res._replace(Wt=round_tf32(res.Wt))
    g = torch.Generator().manual_seed(4)
    s0 = round_tf32(torch.rand(4, res.Wt.shape[0], generator=g) - 0.5)
    o0 = torch.randn(4, 4, generator=g)
    a, b = (esn_predict(res, scale, W, x, 0, init_carry=(s0, o0), tf32=tf)
            for tf in (False, True))
    assert torch.equal(a, b)


def test_plain_tf32_run_within_a_band_of_the_fp32_form():
    """A whole run (30 steps, noise off): the outputs differ by rounding
    only, below 64 x 2^-11 of the largest output and above 0."""
    res, scale, W, x = _case()
    a, b = (esn_predict(res, scale, W, x, 5, tf32=tf) for tf in (False, True))
    d = float((a - b).abs().max())
    assert 0.0 < d <= 64 * 2.0 ** -11 * float(a.abs().max())


@pytest.mark.parametrize("precision,device,route", [
    (None, CUDA, "tf32"), ("default", CUDA, "tf32"),
    (None, "cuda", "tf32"), (None, torch.device("cuda", 1), "tf32"),
    (None, CPU, "fp32"), ("default", CPU, "fp32"), (None, "cpu", "fp32"),
    ("high", CUDA, "fp32"), ("high", CPU, "fp32"),
    ("highest", CUDA, "fp32"), ("highest", CPU, "fp32"),
])
def test_route(precision, device, route):
    assert esn_cuda.predict_route(precision, device) == route


def test_route_without_a_precision_is_fp32_and_unknown_raises():
    default = inspect.signature(esn_cuda.esn_predict_cuda).parameters[
        "precision"].default
    assert esn_cuda.predict_route(default, CUDA) == "fp32"
    for fn in (esn_mimo.esn_detect_symbols, esn_mimo.esn_nmse,
               esn_mimo.esn_detect_symbols_per_block):
        assert inspect.signature(fn).parameters["precision"].default \
            == default
    assert "precision" not in inspect.signature(
        esn_mimo.select_delay_by_nmse).parameters
    with pytest.raises(ValueError, match="precision"):
        esn_cuda.predict_route("bf16", CUDA)


def test_tf32_smem_and_tiling_mirror_the_build():
    """The TF32 build's blocks have 256 threads and a padded ring where a
    warp's ring row is an even number of 8-float groups; the flagship and
    NBF detect shapes keep their fp32 tilings' rows and blocks."""
    assert esn_cuda.block_threads(600, 20, tf32=True) == 256
    assert esn_cuda.ring_pad(600, 20, True) == 8       # 80 floats a row
    assert esn_cuda.ring_pad(300, 72, True) == 0       # 40
    assert esn_cuda.ring_pad(300, 72, False) == 0
    assert esn_cuda.predict_smem_bytes(300, 16, 8, 72, tf32=True) \
        == esn_cuda.predict_smem_bytes(300, 16, 8, 72)
    for B, n_res, fp in ((9472, 300, (72, 132, 72)),
                         (2304, 600, (18, 128, 20))):
        t = esn_cuda.predict_tiling(B, n_res, 16, 8, 132, tf32=True)
        assert (t.rows_per_block, t.blocks, t.height, t.waves) == (*fp, 1)


def test_cpu_none_route_is_the_fp32_plain_version_and_counts_nothing():
    res, scale, W, x = _case()
    before = (esn_cuda.launches, esn_cuda.launches_tf32)
    got = esn_cuda.esn_predict_cuda(res, scale, W, x, 5, 7, precision=None)
    want = esn_predict(res, scale, W, x, 5, esn_cuda.host_generator(7))
    assert torch.equal(got, want)
    assert (esn_cuda.launches, esn_cuda.launches_tf32) == before


def _recording(monkeypatch):
    seen = []
    fn = esn_mimo.esn_predict_cuda

    def run(*a, precision="highest", **k):
        seen.append(precision)
        return fn(*a, precision=precision, **k)
    monkeypatch.setattr(esn_mimo, "esn_predict_cuda", run)
    return seen


def _tiny(precision, rng_mode="batch", n_subcarriers=32):
    return tc.SimConfig(
        name="tf32_tiny",
        ofdm=tc.OfdmConfig(n_subcarriers=n_subcarriers, bits_per_symbol=4,
                           doppler_hz=3000.0),
        channel=tc.ChannelConfig(kind="exp_pdp", n_tx=2, n_rx=2),
        esn=tc.EsnConfig(n_reservoir=40, train_ebno_fixed_db=None,
                         recurrence_precision=precision, rng_mode=rng_mode),
        ldpc=tc.LdpcConfig(enabled=False), num_ofdm_symbols=8)


@pytest.mark.parametrize("precision", [None, "highest"])
@pytest.mark.parametrize("rng_mode", ["batch", "block"])
def test_detectors_pass_the_config_precision(monkeypatch, precision,
                                             rng_mode):
    seen = _recording(monkeypatch)
    cfg = _tiny(precision, rng_mode)
    keys = rng.block_keys(rng.prng_key(3), 4, torch.arange(2)).reshape(1, 2, 2)
    nbf_snr_point(cfg, 12.0, keys, device="cpu")
    assert seen and set(seen) == {precision}


@pytest.mark.parametrize("precision", [None, "highest"])
def test_zoo_nmse_passes_the_config_precision(monkeypatch, precision):
    seen = _recording(monkeypatch)
    cfg = _tiny(precision)
    keys = rng.block_keys(rng.prng_key(5), 4, torch.arange(2))
    zoo2x2.run_zoo_blocks(cfg, 12.0, keys, epochs=1, device="cpu")
    # the ESN detector and the two NMSE predictions
    assert len(seen) == 3 and set(seen) == {precision}
